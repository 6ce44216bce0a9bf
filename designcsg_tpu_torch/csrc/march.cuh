// One k1 viewport pixel: ray setup, sphere-trace march, FD normal and shading
// (k1.cl:420-470 march, 381-418 normal, 280-379 shade, 480-580 pixel setup),
// with the exact per-tile cull when CULL_MODE is 1 (hoisted) or 2 (dynamic);
// one ray of the cone prepass, and one ray of the fit's march with its closest
// approach.  Needs the generated field_sdf /
// scene_shade (each takes the scene's extra tables ``ex``, null for a scene
// without), with a cull also cull_tile / field_sdf_culled and interval.cuh,
// and the constants MAX_STEPS, EPS, TOL, MAX_D, N_EPS, IFOV, MISS_R/G/B,
// OMEGA, CONE_SLOPE, CONE_STRICT, CULL_DRIFT and CULL_MODE.
//
// Reference quirks kept: the ray is NOT normalized; the step is s*TOL with hit
// test s < EPS and miss test d > MAX_D after the advance; a hit at d == 0
// renders the miss colour; the normal is taken at o + d*r.

// The SDF the unculled kernels march: the scene's tape (field_sdf).  The
// culled renderer marches the culled tape under a tile's predicates instead.
struct SceneField {
    const float* bank;
    const float* ad;
    const float* ex;
    HD float operator()(float x, float y, float z) const { return field_sdf(x, y, z, bank, ad, ex); }
};

// The march of one ray over ``field(x, y, z)`` from parameter t0 (0 for the
// exact viewport, the cone prepass's t_safe in the hierarchical one): d
// starts at t0, the point at o + t0*r, and t0 > MAX_D is a miss before the
// first step (march_kernel.py:447-460 of the JAX package).  A ray that stops
// at its t0 > 0 is shaded.  Returns d on a hit, -1 otherwise.
//
// OMEGA > 1 is the over-relaxed march (Keinert et al. 2014;
// march_kernel.py:565-632): step by omg*s; when consecutive bounding spheres
// stop overlapping (|s| + prev_r < step_len) the last step may have crossed
// a surface, so it is retracted and the ray drops to omg = 1.  OMEGA == 1
// compiles to the exact march alone.
template <class Field>
HD float march_ray(float ox, float oy, float oz, float rx, float ry, float rz, float t0,
                   Field field) {
    float d = t0;
    float vx = ox + d * rx, vy = oy + d * ry, vz = oz + d * rz;
    if (d > MAX_D) return -1.0f;
    if constexpr (OMEGA > 1.0f) {
        float prev_r = 0.0f, step_len = 0.0f, omg = OMEGA;
        for (int step = 0; step < MAX_STEPS; ++step) {
            const float s = field(vx, vy, vz) * TOL;
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
            const float s = field(vx, vy, vz) * TOL;
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

#if CULL_MODE
// One step of ``march_ray`` on a ``Ray``'s state, for the dynamic cull's
// warp, which steps its rays in lock step (``march_dynamic``) and so cannot
// run ``march_ray``'s per-ray loop.  It advances a ray as ``march_ray`` does;
// the per-ray marches keep their own loop: run through ``ray_step`` the
// unculled renderer read slower on the H100 (PERF.md).
struct Ray {
    float vx, vy, vz, d, prev_r, step_len, omg;
};
constexpr int MARCHING = 0, HIT = 1, MISS = 2;

HD Ray ray_start(float ox, float oy, float oz, float rx, float ry, float rz, float t0) {
    return Ray{ox + t0 * rx, oy + t0 * ry, oz + t0 * rz, t0, 0.0f, 0.0f, OMEGA};
}

// One step of the march with s = sdf * TOL at the ray's point: HIT (d is the
// hit), MISS (d passed MAX_D) or MARCHING.
HD int ray_step(Ray& ray, float rx, float ry, float rz, float s) {
    if constexpr (OMEGA > 1.0f) {
        const bool sor_ok = !(ray.omg > 1.0f && fabsf(s) + ray.prev_r < ray.step_len);
        if (sor_ok && s < EPS) return HIT;
        if (sor_ok) {
            ray.step_len = ray.omg * s;
        } else {
            ray.step_len = ray.step_len * (1.0f - ray.omg);
            ray.omg = 1.0f;
        }
        ray.vx += ray.step_len * rx;
        ray.vy += ray.step_len * ry;
        ray.vz += ray.step_len * rz;
        ray.d += ray.step_len;
        ray.prev_r = fabsf(s);
    } else {
        if (s < EPS) return HIT;
        ray.vx += s * rx;
        ray.vy += s * ry;
        ray.vz += s * rz;
        ray.d += s;
    }
    return ray.d > MAX_D ? MISS : MARCHING;
}
#endif  // CULL_MODE

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

// The camera ray of pixel (ix, iy): (uv.x, uv.y, IFOV) on the frame rows,
// not normalized (k1.cl:506-528).
HD void pixel_ray(int ix, int iy, int width, int height, const Cam& cam, float& rx, float& ry,
                  float& rz) {
    const float w2 = width / 2.0f;
    const float h2 = height / 2.0f;
    const float uvx = ((float)ix - w2) / w2;
    const float uvy = -((float)iy - h2) / w2;
    rx = uvx * cam.rgt[0] + uvy * cam.rgt[1] + IFOV * cam.rgt[2];
    ry = uvx * cam.upp[0] + uvy * cam.upp[1] + IFOV * cam.upp[2];
    rz = uvx * cam.fwd[0] + uvy * cam.fwd[1] + IFOV * cam.fwd[2];
}

// The colour of a ray that marched to ``d``: the miss colour unless d > 0,
// else the FD normal of ``field`` at o + d*r and the shading there.
template <class Field>
HD Rgb shade_ray(float d, float rx, float ry, float rz, const Cam& cam, const float* bank,
                 const float* ad, const float* ex, Field field) {
    if (!(d > 0.0f)) return Rgb{MISS_R, MISS_G, MISS_B};
    const float px = cam.o[0] + d * rx, py = cam.o[1] + d * ry, pz = cam.o[2] + d * rz;
    const float gx = field(px + N_EPS, py, pz) - field(px - N_EPS, py, pz);
    const float gy = field(px, py + N_EPS, pz) - field(px, py - N_EPS, pz);
    const float gz = field(px, py, pz + N_EPS) - field(px, py, pz - N_EPS);
    const float inv = rsqrt_(gx * gx + gy * gy + gz * gz + 1e-30f);
    return scene_shade(px, py, pz, gx * inv, gy * inv, gz * inv, cam, bank, ad, ex);
}

// A pixel of the unculled renderer.
HD Rgb render_pixel(int ix, int iy, int width, int height, const Cam& cam, const float* bank,
                    const float* ad, const float* ex, float t0) {
    float rx, ry, rz;
    pixel_ray(ix, iy, width, height, cam, rx, ry, rz);
    const SceneField field{bank, ad, ex};
    const float d = march_ray(cam.o[0], cam.o[1], cam.o[2], rx, ry, rz, t0, field);
    return shade_ray(d, rx, ry, rz, cam, bank, ad, ex, field);
}

#if CULL_MODE
// The exact per-tile cull (K7) in the renderer (march_kernel.py:462-523 of
// the JAX package).  A tile is a warp: 32 rays of a 16x2 patch.  Its
// predicates are the same in every lane, so a skipped group costs the warp
// no divergence.

struct CullTile {
    Preds preds;
    float substs[N_CULL_SLOTS];
};

// Axis span of o + d*r for d in ``d`` and a ray component's interval over
// the tile, inflated so that it holds every point the march evaluates: the
// FD normal's probes reach N_EPS off a hit point, and accumulated positions
// drift from o + d*r by up to MAX_STEPS ulps (march_kernel.py:477-491).
HD Iv ray_span(float o, Iv d, Iv r) {
    const Iv p = iv_add(iv_const(o), iv_mul(d, r));
    const float s = add_rn(N_EPS, mul_rn(add_rn(add_rn(fabsf(p.lo), fabsf(p.hi)), 1.0f), CULL_DRIFT));
    return Iv{sub_rn(p.lo, s), add_rn(p.hi, s)};
}

// The hoisted cull's box: a tile's view-cone segment, from its ray
// intervals and its least start parameter to MAX_D, as an inflated axis box.
struct Box {
    Iv x, y, z;
};

HD Box hoisted_box(const Cam& cam, Iv rx, Iv ry, Iv rz, float d_min) {
    const Iv d{d_min, MAX_D};
    return Box{ray_span(cam.o[0], d, rx), ray_span(cam.o[1], d, ry), ray_span(cam.o[2], d, rz)};
}

#ifdef __CUDACC__
__device__ __forceinline__ float warp_min(float v) {
    for (int m = 16; m > 0; m >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, m));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
    return v;
}

// [min, max] of ``v`` over the lanes where ``on`` holds, in every lane.
__device__ __forceinline__ Iv warp_span(bool on, float v) {
    return Iv{warp_min(on ? v : INFINITY), warp_max(on ? v : -INFINITY)};
}

// The dynamic cull's march: the warp steps in lock step while any lane
// marches, and before each step every lane runs the chain on the box of
// the marching lanes' current points (march_kernel.py:497-520) -- exactly
// the points about to be evaluated.  Every lane of the warp must call it.
__device__ float march_dynamic(bool on, const Cam& cam, float rx, float ry, float rz, float t0,
                               const float* bank, const float* ad, const float* ex) {
    Ray ray = ray_start(cam.o[0], cam.o[1], cam.o[2], rx, ry, rz, t0);
    bool active = on && !(ray.d > MAX_D);
    float hit_d = -1.0f;
    CullTile tile;
    for (int step = 0; step < MAX_STEPS; ++step) {
        if (!__any_sync(0xffffffffu, active)) break;
        cull_tile(warp_span(active, ray.vx), warp_span(active, ray.vy), warp_span(active, ray.vz),
                  bank, ad, ex, tile.preds, tile.substs);
        if (active) {
            const float s = field_sdf_culled(ray.vx, ray.vy, ray.vz, bank, ad, ex, tile.preds,
                                             tile.substs) * TOL;
            const int state = ray_step(ray, rx, ry, rz, s);
            if (state != MARCHING) {
                active = false;
                if (state == HIT) hit_d = ray.d;
            }
        }
    }
    return hit_d;
}

// A pixel of the culled renderer; ``on`` is false for a lane outside the
// image, which still takes part in the warp's reductions.  Every lane of
// the warp must call it.  The hoisted cull, one chain per tile over its
// ``hoisted_box``, serves the whole march in the hoisted mode and the FD
// normals in both modes.
__device__ Rgb render_pixel_culled(bool on, int ix, int iy, int width, int height, const Cam& cam,
                                   const float* bank, const float* ad, const float* ex, float t0) {
    float rx, ry, rz;
    pixel_ray(ix, iy, width, height, cam, rx, ry, rz);
    CullTile hoisted;
    const Box b = hoisted_box(cam, warp_span(on, rx), warp_span(on, ry), warp_span(on, rz),
                              warp_min(on ? t0 : INFINITY));
    cull_tile(b.x, b.y, b.z, bank, ad, ex, hoisted.preds, hoisted.substs);
    const auto field = [&](float x, float y, float z) {
        return field_sdf_culled(x, y, z, bank, ad, ex, hoisted.preds, hoisted.substs);
    };
#if CULL_MODE == 2
    const float d = march_dynamic(on, cam, rx, ry, rz, t0, bank, ad, ex);
#else
    const float d = on ? march_ray(cam.o[0], cam.o[1], cam.o[2], rx, ry, rz, t0, field) : -1.0f;
#endif
    return shade_ray(d, rx, ry, rz, cam, bank, ad, ex, field);
}
#endif  // __CUDACC__
#endif  // CULL_MODE

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
