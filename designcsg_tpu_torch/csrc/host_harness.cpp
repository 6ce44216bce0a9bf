// Host build of a generated scene source, for tests without a card: the same
// generated HD functions the kernels inline, driven by plain loops.  Built with
// a host C++ compiler after the scene code (and march.cuh, for the renderer).

// The bank arrays are interleaved as a kernel's shared copy is:
// BANK_STRIDE floats per object.
extern "C" void host_point_eval(const float* pts, float* out, long long n, const float* bank,
                                const float* ad) {
    for (long long i = 0; i < n; ++i) {
        out[i] = field_sdf(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], bank, ad);
    }
}

#ifdef HOST_RENDER
// The renderer kernel's loop: t0 is the f32[H, W] start plane, or null.
extern "C" void host_render(float* out, int height, int width, const float* cam_host,
                            const float* bank, const float* ad, const float* t0) {
    Cam cam;
    for (int k = 0; k < 3; ++k) {
        cam.o[k] = cam_host[k];
        cam.rgt[k] = cam_host[3 + k];
        cam.upp[k] = cam_host[6 + k];
        cam.fwd[k] = cam_host[9 + k];
    }
    for (int iy = 0; iy < height; ++iy) {
        for (int ix = 0; ix < width; ++ix) {
            const long long pixel = (long long)iy * width + ix;
            const Rgb c = render_pixel(ix, iy, width, height, cam, bank, ad, t0 ? t0[pixel] : 0.0f);
            float* px = out + 3 * pixel;
            px[0] = c.r;
            px[1] = c.g;
            px[2] = c.b;
        }
    }
}

// The cone kernel's loop over a ray batch f32[n, 3] from the origin o f32[3].
extern "C" void host_cone_march(float* t_safe, long long n, const float* rays, const float* o,
                                const float* bank, const float* ad) {
    for (long long i = 0; i < n; ++i) {
        t_safe[i] = cone_ray(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2],
                             bank, ad);
    }
}

// The fit's ray-march kernel's loop: d f32[n] and the closest approach
// vmin f32[n, 3] of a ray batch f32[n, 3] from the origin o f32[3].
extern "C" void host_ray_march(float* d, float* vmin, long long n, const float* rays,
                               const float* o, const float* bank, const float* ad) {
    for (long long i = 0; i < n; ++i) {
        d[i] = march_ray_closest(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2],
                                 bank, ad, vmin[3 * i], vmin[3 * i + 1], vmin[3 * i + 2]);
    }
}
#endif
