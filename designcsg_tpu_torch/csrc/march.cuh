// One k1 viewport pixel: ray setup, sphere-trace march, FD normal and shading
// (k1.cl:420-470 march, 381-418 normal, 280-379 shade, 480-580 pixel setup),
// one ray of the cone prepass, and one ray of the fit's march with its closest
// approach.  Needs the generated field_sdf /
// scene_shade (each takes the scene's extra tables ``ex``, null for a scene
// without) and the constants MAX_STEPS, EPS, TOL, MAX_D, N_EPS, IFOV,
// MISS_R/G/B, OMEGA, CONE_SLOPE and CONE_STRICT.
//
// Reference quirks kept: the ray is NOT normalized; the step is s*TOL with hit
// test s < EPS and miss test d > MAX_D after the advance; a hit at d == 0
// renders the miss colour; the normal is taken at o + d*r.

// The march of one ray from parameter t0 (0 for the exact viewport, the cone
// prepass's t_safe in the hierarchical one): d starts at t0, the point at
// o + t0*r, and t0 > MAX_D is a miss before the first step
// (march_kernel.py:447-460 of the JAX package).  A ray that stops at its
// t0 > 0 is shaded.  Returns d on a hit, -1 otherwise.
//
// OMEGA > 1 is the over-relaxed march (Keinert et al. 2014;
// march_kernel.py:565-632): step by omg*s; when consecutive bounding spheres
// stop overlapping (|s| + prev_r < step_len) the last step may have crossed
// a surface, so it is retracted and the ray drops to omg = 1.  OMEGA == 1
// compiles to the exact march alone.
HD float march_ray(float ox, float oy, float oz, float rx, float ry, float rz, float t0,
                   const float* bank, const float* ad, const float* ex) {
    float d = t0;
    float vx = ox + d * rx, vy = oy + d * ry, vz = oz + d * rz;
    if (d > MAX_D) return -1.0f;
    if constexpr (OMEGA > 1.0f) {
        float prev_r = 0.0f, step_len = 0.0f, omg = OMEGA;
        for (int step = 0; step < MAX_STEPS; ++step) {
            const float s = field_sdf(vx, vy, vz, bank, ad, ex) * TOL;
            const bool sor_ok = !(omg > 1.0f && fabsf(s) + prev_r < step_len);
            if (sor_ok && s < EPS) return d;
            if (sor_ok) {
                step_len = omg * s;
            } else {
                step_len = step_len * (1.0f - omg);
                omg = 1.0f;
            }
            vx += step_len * rx;
            vy += step_len * ry;
            vz += step_len * rz;
            d += step_len;
            prev_r = fabsf(s);
            if (d > MAX_D) return -1.0f;
        }
    } else {
        for (int step = 0; step < MAX_STEPS; ++step) {
            const float s = field_sdf(vx, vy, vz, bank, ad, ex) * TOL;
            if (s < EPS) return d;
            vx += s * rx;
            vy += s * ry;
            vz += s * rz;
            d += s;
            if (d > MAX_D) return -1.0f;
        }
    }
    return -1.0f;  // out of steps: a miss (k1.cl:469)
}

// The march of one ray from the origin that also tracks its closest approach
// (K4, march_kernel.py:45-199 of the JAX package, and its jnp march with
// return_closest, raymarch.py:225-247 and 286-293): on every step, before the
// hit test and the advance, the point evaluated becomes (mx, my, mz) when its
// s = sdf*TOL is strictly below the smallest s so far (which starts at
// MAX_DISTANCE).  The closest point starts at the origin, so a ray that hits
// at step 0 returns d = 0 with the origin.  Returns d on a hit, -1 otherwise;
// march_ray's loop from t0 = 0 with the tracking added, exact or (OMEGA > 1)
// over-relaxed.
HD float march_ray_closest(float ox, float oy, float oz, float rx, float ry, float rz,
                           const float* bank, const float* ad, const float* ex, float& mx,
                           float& my, float& mz) {
    float d = 0.0f, vx = ox, vy = oy, vz = oz, smin = MAX_DISTANCE;
    mx = ox;
    my = oy;
    mz = oz;
    if constexpr (OMEGA > 1.0f) {
        float prev_r = 0.0f, step_len = 0.0f, omg = OMEGA;
        for (int step = 0; step < MAX_STEPS; ++step) {
            const float s = field_sdf(vx, vy, vz, bank, ad, ex) * TOL;
            if (s < smin) {
                smin = s;
                mx = vx;
                my = vy;
                mz = vz;
            }
            const bool sor_ok = !(omg > 1.0f && fabsf(s) + prev_r < step_len);
            if (sor_ok && s < EPS) return d;
            if (sor_ok) {
                step_len = omg * s;
            } else {
                step_len = step_len * (1.0f - omg);
                omg = 1.0f;
            }
            vx += step_len * rx;
            vy += step_len * ry;
            vz += step_len * rz;
            d += step_len;
            prev_r = fabsf(s);
            if (d > MAX_D) return -1.0f;
        }
    } else {
        for (int step = 0; step < MAX_STEPS; ++step) {
            const float s = field_sdf(vx, vy, vz, bank, ad, ex) * TOL;
            if (s < smin) {
                smin = s;
                mx = vx;
                my = vy;
                mz = vz;
            }
            if (s < EPS) return d;
            vx += s * rx;
            vy += s * ry;
            vz += s * rz;
            d += s;
            if (d > MAX_D) return -1.0f;
        }
    }
    return -1.0f;  // out of steps: a miss (k1.cl:469)
}

HD Rgb render_pixel(int ix, int iy, int width, int height, const Cam& cam, const float* bank,
                    const float* ad, const float* ex, float t0) {
    const float w2 = width / 2.0f;
    const float h2 = height / 2.0f;
    const float uvx = ((float)ix - w2) / w2;
    const float uvy = -((float)iy - h2) / w2;
    const float rx = uvx * cam.rgt[0] + uvy * cam.rgt[1] + IFOV * cam.rgt[2];
    const float ry = uvx * cam.upp[0] + uvy * cam.upp[1] + IFOV * cam.upp[2];
    const float rz = uvx * cam.fwd[0] + uvy * cam.fwd[1] + IFOV * cam.fwd[2];
    const float ox = cam.o[0], oy = cam.o[1], oz = cam.o[2];

    const float d = march_ray(ox, oy, oz, rx, ry, rz, t0, bank, ad, ex);
    if (!(d > 0.0f)) return Rgb{MISS_R, MISS_G, MISS_B};

    const float px = ox + d * rx, py = oy + d * ry, pz = oz + d * rz;
    const float gx = field_sdf(px + N_EPS, py, pz, bank, ad, ex) - field_sdf(px - N_EPS, py, pz, bank, ad, ex);
    const float gy = field_sdf(px, py + N_EPS, pz, bank, ad, ex) - field_sdf(px, py - N_EPS, pz, bank, ad, ex);
    const float gz = field_sdf(px, py, pz + N_EPS, bank, ad, ex) - field_sdf(px, py, pz - N_EPS, bank, ad, ex);
    const float inv = rsqrt_(gx * gx + gy * gy + gz * gz + 1e-30f);
    return scene_shade(px, py, pz, gx * inv, gy * inv, gz * inv, cam, bank, ad, ex);
}

// One ray of the cone prepass (march_kernel.py:209-294): march from the
// camera with the cone-inflated stop test s < EPS + d*CONE_SLOPE and return
// t_safe, the parameter of the last point stepped past (committed just
// before stepping past it).  A ray that leaves the scene returns its d
// unless CONE_STRICT; one out of steps returns its last committed point.
HD float cone_ray(float ox, float oy, float oz, float rx, float ry, float rz,
                  const float* bank, const float* ad, const float* ex) {
    float vx = ox, vy = oy, vz = oz, d = 0.0f, tprev = 0.0f;
    for (int step = 0; step < MAX_STEPS; ++step) {
        const float s = field_sdf(vx, vy, vz, bank, ad, ex) * TOL;
        if (s < EPS + d * CONE_SLOPE) break;
        tprev = d;
        vx += s * rx;
        vy += s * ry;
        vz += s * rz;
        d += s;
        if (d > MAX_D) {
            if (!CONE_STRICT) tprev = d;
            break;
        }
    }
    return tprev;
}
