// Host build of a generated scene source, for tests without a card: the same
// generated HD functions the kernels inline, driven by plain loops.  Built with
// a host C++ compiler after the scene code (and march.cuh, for the renderer).
// The grid kernel column by column; with a cull (CULL_MODE), the chain alone
// (in one thread, and spread over a warp's 32 lanes), the culled grid tile
// by tile, and the culled renderer warp by warp, the warp's lock step,
// reductions and shuffles emulated over its 32 lanes in order; the cone
// prepass one thread a ray and split across a block's warps.

// The bank arrays are interleaved as a kernel's shared copy is:
// BANK_STRIDE floats per object.  ``ex`` is the scene's extra tables, as the
// kernels get them (null for a scene without).
extern "C" void host_point_eval(const float* pts, float* out, long long n, const float* bank,
                                const float* ad, const float* ex) {
    for (long long i = 0; i < n; ++i) {
        out[i] = field_sdf(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], bank, ad, ex);
    }
}

// K6 alone: plane_sample (table.cuh) on one letter's planes at n grid
// coordinates.
extern "C" void host_plane_sample(float* out, long long n, const float* planes, const float* gx,
                                  const float* gy) {
    for (long long i = 0; i < n; ++i) out[i] = plane_sample(planes, gx[i], gy[i]);
}

// The FD kernel's per point work (common.cuh sdf_fd_normal): the SDF f32[n]
// and the FD normal f32[n, 3].
extern "C" void host_point_eval_fd(const float* pts, float* out, float* normal, long long n,
                                   const float* bank, const float* ad, const float* ex) {
    const auto field = [&](float x, float y, float z) { return field_sdf(x, y, z, bank, ad, ex); };
    for (long long i = 0; i < n; ++i) {
        out[i] = sdf_fd_normal(field, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], normal[3 * i],
                               normal[3 * i + 1], normal[3 * i + 2]);
    }
}

#if CULL_MODE
// The cull chain on one box f32[6] (x0, x1, y0, y1, z0, z1): the predicate
// mask's N_CULL_WORDS words and the N_CULL_SLOTS substitutes.
extern "C" void host_cull_tile(const float* box, const float* bank, const float* ad,
                               const float* ex, unsigned* preds, float* substs) {
    Preds p;
    cull_tile(Iv{box[0], box[1]}, Iv{box[2], box[3]}, Iv{box[4], box[5]}, bank, ad, ex, p, substs);
    for (int i = 0; i < N_CULL_WORDS; ++i) preds[i] = p.w[i];
}

// The lane chain of a warp (march.cuh cull_tile_lanes): per chunk, each of
// the 32 lanes runs cull_lane on its slot, and the shuffles that gather the
// slots' intervals into every lane are reads of the lanes' array.
static void lane_chain(Iv bx, Iv by, Iv bz, const float* bank, const float* ad, const float* ex,
                       Preds& preds, float* substs) {
    Iv b[N_CULL_SLOTS];
    for (int chunk = 0; chunk < N_CULL_CHUNKS; ++chunk) {
        Iv lanes[32];
        for (int lane = 0; lane < 32; ++lane)
            lanes[lane] = cull_lane(chunk, lane, bx, by, bz, bank, ad, ex);
        for (int j = 0; j < 32 && 32 * chunk + j < N_CULL_SLOTS; ++j) b[32 * chunk + j] = lanes[j];
    }
    cull_tree(b, preds, substs);
}

// The lane chain on one box, as host_cull_tile.
extern "C" void host_cull_tile_lanes(const float* box, const float* bank, const float* ad,
                                     const float* ex, unsigned* preds, float* substs) {
    Preds p;
    lane_chain(Iv{box[0], box[1]}, Iv{box[2], box[3]}, Iv{box[4], box[5]}, bank, ad, ex, p, substs);
    for (int i = 0; i < N_CULL_WORDS; ++i) preds[i] = p.w[i];
}

#ifndef HOST_RENDER
// The culled grid kernel's chain for the tile at lattice index (x0, y0, zb):
// the lane chain (``lanes``) or cull_tile in one thread, on the tile's box
// (interval.cuh grid_tile_box); preds as host_cull_tile's.
extern "C" void host_grid_tile_cull(int x0, int y0, int zb, int nz, int ny, int nx, float lox,
                                    float loy, float loz, float cell, float z0, int lanes,
                                    const float* bank, const float* ad, const float* ex,
                                    unsigned* preds, float* substs) {
    Iv bx, by, bz;
    grid_tile_box(x0, y0, zb, nz, ny, nx, lox, loy, loz, cell, z0, bx, by, bz);
    Preds p;
    if (lanes) {
        lane_chain(bx, by, bz, bank, ad, ex, p, substs);
    } else {
        cull_tile(bx, by, bz, bank, ad, ex, p, substs);
    }
    for (int i = 0; i < N_CULL_WORDS; ++i) preds[i] = p.w[i];
}

// The culled grid kernel's tiles, in order (sdf_kernels.cu
// grid_eval_cull_kernel): the lane chain on the tile's box, then per (x, y)
// column of the tile its points in z, in the column form (its frame terms
// once: ``Column``) or in the point form (GRID_CULL_COLUMN 0).
template <bool Column>
static void grid_eval_cull(float* out, int nz, int ny, int nx, float lox, float loy, float loz,
                           float cell, float z0, const float* bank, const float* ad,
                           const float* ex) {
    float substs[N_CULL_SLOTS];
    for (int zb = 0; zb < nz; zb += CULL_TZ)
        for (int y0 = 0; y0 < ny; y0 += CULL_TY)
            for (int x0 = 0; x0 < nx; x0 += CULL_TX) {
                Iv bx, by, bz;
                grid_tile_box(x0, y0, zb, nz, ny, nx, lox, loy, loz, cell, z0, bx, by, bz);
                Preds preds;
                lane_chain(bx, by, bz, bank, ad, ex, preds, substs);
                for (int yi = y0; yi < ny && yi < y0 + CULL_TY; ++yi)
                    for (int xi = x0; xi < nx && xi < x0 + CULL_TX; ++xi) {
                        const float x = lattice(lox, cell, (float)xi);
                        const float y = lattice(loy, cell, (float)yi);
                        float h[N_COLUMN_TERMS];
                        if (Column) column_terms_culled(x, y, bank, preds, h);
                        for (int zi = zb; zi < nz && zi < zb + CULL_TZ; ++zi) {
                            const float z = lattice(loz, cell, add_rn(z0, (float)zi));
                            out[((long long)zi * ny + yi) * nx + xi] =
                                Column ? field_sdf_culled_column(x, y, z, h, bank, ad, ex, preds,
                                                                 substs)
                                       : field_sdf_culled(x, y, z, bank, ad, ex, preds, substs);
                        }
                    }
            }
}

extern "C" void host_grid_eval_cull(float* out, int nz, int ny, int nx, float lox, float loy,
                                    float loz, float cell, float z0, const float* bank,
                                    const float* ad, const float* ex) {
    grid_eval_cull<true>(out, nz, ny, nx, lox, loy, loz, cell, z0, bank, ad, ex);
}

extern "C" void host_grid_eval_cull_point(float* out, int nz, int ny, int nx, float lox,
                                          float loy, float loz, float cell, float z0,
                                          const float* bank, const float* ad, const float* ex) {
    grid_eval_cull<false>(out, nz, ny, nx, lox, loy, loz, cell, z0, bank, ad, ex);
}
#endif
#endif

#ifndef HOST_RENDER
// The grid kernel (sdf_kernels.cu grid_eval_kernel): per (x, y) column its
// frame terms, then its points in z through the column form.
extern "C" void host_grid_eval(float* out, int nz, int ny, int nx, float lox, float loy,
                               float loz, float cell, float z0, const float* bank,
                               const float* ad, const float* ex) {
    for (int yi = 0; yi < ny; ++yi)
        for (int xi = 0; xi < nx; ++xi) {
            const float x = lattice(lox, cell, (float)xi), y = lattice(loy, cell, (float)yi);
            float h[N_COLUMN_TERMS];
            column_terms(x, y, bank, h);
            for (int zi = 0; zi < nz; ++zi)
                out[((long long)zi * ny + yi) * nx + xi] = field_sdf_column(
                    x, y, lattice(loz, cell, add_rn(z0, (float)zi)), h, bank, ad, ex);
        }
}
#endif

#ifdef HOST_RENDER
static Cam host_cam(const float* cam_host) {
    Cam cam;
    for (int k = 0; k < 3; ++k) {
        cam.o[k] = cam_host[k];
        cam.rgt[k] = cam_host[3 + k];
        cam.upp[k] = cam_host[6 + k];
        cam.fwd[k] = cam_host[9 + k];
    }
    return cam;
}

#if CULL_MODE
static Iv host_span(const bool* on, const float* v) {
    Iv s{INFINITY, -INFINITY};
    for (int l = 0; l < 32; ++l) {
        if (on[l]) s = Iv{fminf(s.lo, v[l]), fmaxf(s.hi, v[l])};
    }
    return s;
}

// The rays of the renderer kernel's warp at (x0, y0), a 16x2 patch: which
// lanes lie in the image, their pixels, rays and start parameters.
struct HostWarp {
    bool on[32];
    long long pixel[32];
    float rx[32], ry[32], rz[32], t[32];

    HostWarp(int x0, int y0, int height, int width, const Cam& cam, const float* t0) {
        for (int l = 0; l < 32; ++l) {
            const int ix = x0 + l % 16, iy = y0 + l / 16;
            on[l] = ix < width && iy < height;
            pixel[l] = (long long)iy * width + ix;
            pixel_ray(ix, iy, width, height, cam, rx[l], ry[l], rz[l]);
            t[l] = on[l] && t0 ? t0[pixel[l]] : 0.0f;
        }
    }

    Box box(const Cam& cam) const {
        return hoisted_box(cam, host_span(on, rx), host_span(on, ry), host_span(on, rz),
                           host_span(on, t).lo);
    }
};

// The hoisted box f32[6] (x0, x1, y0, y1, z0, z1) of the warp at (x0, y0).
extern "C" void host_hoisted_box(float* box, int x0, int y0, int height, int width,
                                 const float* cam_host, const float* t0) {
    const Cam cam = host_cam(cam_host);
    const Box b = HostWarp(x0, y0, height, width, cam, t0).box(cam);
    const Iv ivs[3] = {b.x, b.y, b.z};
    for (int k = 0; k < 3; ++k) {
        box[2 * k] = ivs[k].lo;
        box[2 * k + 1] = ivs[k].hi;
    }
}

// The dynamic warps' steps and the chains they ran, since the last read.
static long long host_steps = 0, host_chains = 0;

extern "C" void host_dynamic_counts(long long* out) {
    out[0] = host_steps;
    out[1] = host_chains;
    host_steps = host_chains = 0;
}

// One warp of the culled renderer kernel (march.cuh render_pixel_culled and
// march_dynamic, with its lane chain), its 32 lanes in
// turn: the 16x2 patch at (x0, y0).
static void host_render_warp(float* out, int x0, int y0, int height, int width, const Cam& cam,
                             const float* bank, const float* ad, const float* ex,
                             const float* t0) {
    const HostWarp w(x0, y0, height, width, cam, t0);
    const bool* on = w.on;
    const float *rx = w.rx, *ry = w.ry, *rz = w.rz, *t = w.t;
    float d[32];
    CullTile hoisted;
    const Box b = w.box(cam);
    cull_tile(b.x, b.y, b.z, bank, ad, ex, hoisted.preds, hoisted.substs);
    const auto field = [&](float x, float y, float z) {
        return field_sdf_culled(x, y, z, bank, ad, ex, hoisted.preds, hoisted.substs);
    };
#if CULL_MODE == 2
    Ray ray[32];
    bool active[32];
    float vx[32], vy[32], vz[32];
    for (int l = 0; l < 32; ++l) {
        ray[l] = ray_start(cam.o[0], cam.o[1], cam.o[2], rx[l], ry[l], rz[l], t[l]);
        active[l] = on[l] && !(ray[l].d > MAX_D);
        d[l] = -1.0f;
    }
    CullTile tile;
    Box held = empty_box();
    for (int step = 0; step < MAX_STEPS; ++step) {
        bool any = false;
        for (int l = 0; l < 32; ++l) {
            any = any || active[l];
            vx[l] = ray[l].vx;
            vy[l] = ray[l].vy;
            vz[l] = ray[l].vz;
        }
        if (!any) break;
        if (hold_box(held, host_span(active, vx), host_span(active, vy), host_span(active, vz))) {
            lane_chain(held.x, held.y, held.z, bank, ad, ex, tile.preds, tile.substs);
            ++host_chains;
        }
        ++host_steps;
        for (int l = 0; l < 32; ++l) {
            if (!active[l]) continue;
            const float s = field_sdf_culled(ray[l].vx, ray[l].vy, ray[l].vz, bank, ad, ex,
                                             tile.preds, tile.substs) * TOL;
            const int state = ray_step(ray[l], rx[l], ry[l], rz[l], s);
            if (state != MARCHING) {
                active[l] = false;
                if (state == HIT) d[l] = ray[l].d;
            }
        }
    }
#else
    for (int l = 0; l < 32; ++l) {
        d[l] = on[l] ? march_ray(cam.o[0], cam.o[1], cam.o[2], rx[l], ry[l], rz[l], t[l], field)
                     : -1.0f;
    }
#endif
    for (int l = 0; l < 32; ++l) {
        if (!on[l]) continue;
        const Rgb c = shade_ray(d[l], rx[l], ry[l], rz[l], cam, bank, ad, ex, field);
        float* px = out + 3 * w.pixel[l];
        px[0] = c.r;
        px[1] = c.g;
        px[2] = c.b;
    }
}
#endif

// The renderer kernel's loop: t0 is the f32[H, W] start plane, or null.  With
// a cull, warp by warp (16x2 patches of the kernel's 16x8 blocks).
extern "C" void host_render(float* out, int height, int width, const float* cam_host,
                            const float* bank, const float* ad, const float* ex,
                            const float* t0) {
    const Cam cam = host_cam(cam_host);
#if CULL_MODE
    for (int y0 = 0; y0 < height; y0 += 2)
        for (int x0 = 0; x0 < width; x0 += 16)
            host_render_warp(out, x0, y0, height, width, cam, bank, ad, ex, t0);
#else
    for (int iy = 0; iy < height; ++iy) {
        for (int ix = 0; ix < width; ++ix) {
            const long long pixel = (long long)iy * width + ix;
            const Rgb c = render_pixel(ix, iy, width, height, cam, bank, ad, ex,
                                        t0 ? t0[pixel] : 0.0f);
            float* px = out + 3 * pixel;
            px[0] = c.r;
            px[1] = c.g;
            px[2] = c.b;
        }
    }
#endif
}

// The cone kernel's loop over a ray batch f32[n, 3] from the origin o f32[3],
// one thread a ray (CONE_WARPS 0).
extern "C" void host_cone_march(float* t_safe, long long n, const float* rays, const float* o,
                                const float* bank, const float* ad, const float* ex) {
    for (long long i = 0; i < n; ++i) {
        t_safe[i] = cone_ray(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2],
                             bank, ad, ex);
    }
}

#ifdef CONE_SPLIT
// The cone kernel split across S warps (cone_kernel.cu, CONE_WARPS = S), one
// block of 32 rays at a time: each warp keeps its own copy of the 32 rays'
// state, as on the card; per step every warp writes its slots (cone_slots<S>)
// for its 32 lanes into the step's buffer, the end of that loop standing for
// the barrier, then every warp runs cone_tape on the buffer and steps its
// copy.  Returns 0, or 1 if two warps' copies ever disagree (on the card
// they would then leave the loop apart).
template <int S>
static int cone_split(float* t_safe, long long n, const float* rays, const float* o,
                      const float* bank, const float* ad, const float* ex) {
    for (long long b = 0; b < n; b += 32) {
        ConeRay ray[S][32];
        bool marching[S][32];
        float rx[32], ry[32], rz[32];
        for (int l = 0; l < 32; ++l) {
            const long long i = b + l;
            const bool on = i < n;
            rx[l] = on ? rays[3 * i] : 0.0f;
            ry[l] = on ? rays[3 * i + 1] : 0.0f;
            rz[l] = on ? rays[3 * i + 2] : 0.0f;
            for (int w = 0; w < S; ++w) {
                ray[w][l] = ConeRay{o[0], o[1], o[2], 0.0f, 0.0f};
                marching[w][l] = on;
            }
        }
        float slots[2][N_CONE_SLOTS * 32];
        for (int step = 0; step < MAX_STEPS; ++step) {
            bool any = false;
            for (int l = 0; l < 32; ++l) any = any || marching[0][l];
            if (!any) break;
            float* buf = slots[step & 1];
            for (int w = 0; w < S; ++w)
                for (int l = 0; l < 32; ++l)
                    cone_slots<S>(w, ray[w][l].vx, ray[w][l].vy, ray[w][l].vz, bank, ad, ex,
                                  buf + l);
            for (int w = 0; w < S; ++w)
                for (int l = 0; l < 32; ++l) {
                    const float s = cone_tape(buf + l) * TOL;
                    if (marching[w][l]) marching[w][l] = cone_advance(ray[w][l], rx[l], ry[l], rz[l], s);
                }
            for (int w = 1; w < S; ++w)
                for (int l = 0; l < 32; ++l)
                    if (marching[w][l] != marching[0][l] || ray[w][l].tprev != ray[0][l].tprev)
                        return 1;
        }
        for (int l = 0; l < 32 && b + l < n; ++l) t_safe[b + l] = ray[0][l].tprev;
    }
    return 0;
}

extern "C" int host_cone_march_split(int warps, float* t_safe, long long n, const float* rays,
                                     const float* o, const float* bank, const float* ad,
                                     const float* ex) {
    switch (warps) {
        case 1: return cone_split<1>(t_safe, n, rays, o, bank, ad, ex);
        case 2: return cone_split<2>(t_safe, n, rays, o, bank, ad, ex);
        case 4: return cone_split<4>(t_safe, n, rays, o, bank, ad, ex);
        case 8: return cone_split<8>(t_safe, n, rays, o, bank, ad, ex);
        default: return 2;
    }
}
#endif

// The fit's ray-march kernel's loop: d f32[n] and the closest approach
// vmin f32[n, 3] of a ray batch f32[n, 3] from the origin o f32[3].
extern "C" void host_ray_march(float* d, float* vmin, long long n, const float* rays,
                               const float* o, const float* bank, const float* ad,
                               const float* ex) {
    for (long long i = 0; i < n; ++i) {
        d[i] = march_ray_closest(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2],
                                 bank, ad, ex, vmin[3 * i], vmin[3 * i + 1], vmin[3 * i + 2]);
    }
}
#endif
