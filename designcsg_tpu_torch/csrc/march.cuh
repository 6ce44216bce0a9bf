// One k1 viewport pixel: ray setup, exact sphere-trace march, FD normal and
// shading (k1.cl:420-470 march, 381-418 normal, 280-379 shade, 480-580 pixel
// setup).  Needs the generated field_sdf / scene_shade and the constants
// MAX_STEPS, EPS, TOL, MAX_D, N_EPS, IFOV, MISS_R/G/B.
//
// Reference quirks kept: the ray is NOT normalized; the step is s*TOL with hit
// test s < EPS and miss test d > MAX_D after the advance; a hit at step 0
// (d == 0) renders the miss colour; the normal is taken at o + d*r.
HD Rgb render_pixel(int ix, int iy, int width, int height, const Cam& cam, const float* bank,
                    const float* ad) {
    const float w2 = width / 2.0f;
    const float h2 = height / 2.0f;
    const float uvx = ((float)ix - w2) / w2;
    const float uvy = -((float)iy - h2) / w2;
    const float rx = uvx * cam.rgt[0] + uvy * cam.rgt[1] + IFOV * cam.rgt[2];
    const float ry = uvx * cam.upp[0] + uvy * cam.upp[1] + IFOV * cam.upp[2];
    const float rz = uvx * cam.fwd[0] + uvy * cam.fwd[1] + IFOV * cam.fwd[2];
    const float ox = cam.o[0], oy = cam.o[1], oz = cam.o[2];

    float vx = ox, vy = oy, vz = oz, d = 0.0f;
    bool hit = false;
    for (int step = 0; step < MAX_STEPS; ++step) {
        const float s = field_sdf(vx, vy, vz, bank, ad) * TOL;
        if (s < EPS) {
            hit = true;
            break;
        }
        vx += s * rx;
        vy += s * ry;
        vz += s * rz;
        d += s;
        if (d > MAX_D) break;
    }
    if (!(hit && d > 0.0f)) return Rgb{MISS_R, MISS_G, MISS_B};

    const float px = ox + d * rx, py = oy + d * ry, pz = oz + d * rz;
    const float gx = field_sdf(px + N_EPS, py, pz, bank, ad) - field_sdf(px - N_EPS, py, pz, bank, ad);
    const float gy = field_sdf(px, py + N_EPS, pz, bank, ad) - field_sdf(px, py - N_EPS, pz, bank, ad);
    const float gz = field_sdf(px, py, pz + N_EPS, bank, ad) - field_sdf(px, py, pz - N_EPS, bank, ad);
    const float inv = rsqrt_(gx * gx + gy * gy + gz * gz + 1e-30f);
    return scene_shade(px, py, pz, gx * inv, gy * inv, gz * inv, cam, bank, ad);
}
