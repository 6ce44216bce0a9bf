// One k1 viewport pixel: ray setup, sphere-trace march, FD normal and shading
// (k1.cl:420-470 march, 381-418 normal, 280-379 shade, 480-580 pixel setup),
// with the exact per-tile cull when CULL_MODE is 1 (hoisted) or 2 (dynamic);
// one ray of the cone prepass, and one ray of the fit's march with its
// closest approach.  Needs the generated field_sdf / scene_shade (each takes
// the scene's extra tables ``ex``, null for a scene without), with a cull
// also cull_lane / cull_tree / field_sdf_culled and interval.cuh, and the
// constants MAX_STEPS, EPS, TOL, MAX_D, N_EPS, IFOV, MISS_R/G/B, OMEGA,
// CONE_SLOPE, CONE_STRICT, CULL_DRIFT, CULL_MODE and N_CULL_CHUNKS.
//
// The dynamic cull runs a chain only when the warp's points leave the box it
// holds (``hold_box``), and runs it over the warp's lanes: a chain costs per
// chunk of 32 slots one frame interval and one interval body per brush kind
// in the chunk, two shuffles per slot, then the relevance tree
// (ops/cuda/tape.py lane_chain_ops; Design1 with the gizmo: 319 FP32
// operations and 24 shuffles a warp issues, where each lane ran the 1,163
// of the one-thread chain before).  The plain version and the JAX package
// cull every step on the box of the marching points.
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

// The dynamic cull's held box, empty before the first step.
HD Box empty_box() {
    const Iv e{INFINITY, -INFINITY};
    return Box{e, e, e};
}

HD bool iv_within(Iv a, Iv b) { return a.lo >= b.lo && a.hi <= b.hi; }

// Predicates reused across steps: while the marching points' box (bx, by,
// bz) stays inside ``held``, the predicates of ``held`` serve the step, and
// this returns false; else ``held`` becomes the points' box widened by
// CULL_HOLD on every side (rounded outward: a - m <= a, a + m >= a), and
// it returns true, for the chain to run on it.  Exact as the per-step cull
// is: predicates that hold on a box hold on every point inside it, so the
// frames stay bit-equal to the unculled kernel's.  The plain version and
// the JAX package keep the per-step cull (march_kernel.py:497-520); the
// share of group evaluations skipped differs from theirs (PERF.md).
HD bool hold_box(Box& held, Iv bx, Iv by, Iv bz) {
    if (iv_within(bx, held.x) && iv_within(by, held.y) && iv_within(bz, held.z)) return false;
    held = Box{Iv{sub_rn(bx.lo, CULL_HOLD), add_rn(bx.hi, CULL_HOLD)},
               Iv{sub_rn(by.lo, CULL_HOLD), add_rn(by.hi, CULL_HOLD)},
               Iv{sub_rn(bz.lo, CULL_HOLD), add_rn(bz.hi, CULL_HOLD)}};
    return true;
}

// Group evaluations a tile's predicates allow, for the debug counters.
HD int pred_groups(const Preds& p) {
    int n = 0;
    for (int i = 0; i < N_CULL_WORDS; ++i) {
        for (unsigned w = p.w[i]; w; w &= w - 1u) ++n;
    }
    return n;
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

// Debug counters, counting in CULL_STATS builds only: the evaluations a
// warp makes through a cull, the group evaluations its predicates allow and
// the chains it runs, read by read_cull_stats.  Lane 0 of the warp adds; the
// arguments are warp-uniform.
#ifdef CULL_STATS
constexpr bool CULL_COUNTING = true;
#else
constexpr bool CULL_COUNTING = false;
#endif
__device__ unsigned long long cull_stats[3];

__device__ __forceinline__ void count_cull(int evals, int group_evals, int chains) {
    if ((threadIdx.y * blockDim.x + threadIdx.x) % 32 == 0) {
        atomicAdd(&cull_stats[0], (unsigned long long)evals);
        atomicAdd(&cull_stats[1], (unsigned long long)group_evals);
        atomicAdd(&cull_stats[2], (unsigned long long)chains);
    }
}

// The counters since the last read (evals, group evals, chains), then zero.
extern "C" int read_cull_stats(int device, unsigned long long* out) {
    int rc = use_device(device);
    if (rc == 0) rc = (int)cudaMemcpyFromSymbol(out, cull_stats, sizeof(cull_stats));
    const unsigned long long zero[3] = {0, 0, 0};
    if (rc == 0) rc = (int)cudaMemcpyToSymbol(cull_stats, zero, sizeof(zero));
    return rc;
}

// The dynamic cull's march: the warp steps in lock step while any lane
// marches, and before each step it takes the box of the marching lanes'
// current points (march_kernel.py:497-520), exactly the points about to be
// evaluated; when that box leaves the held one (``hold_box``) the warp runs
// the lane chain on the new held box (``cull_tile_lanes``).  Every lane of
// the warp must call it.
__device__ float march_dynamic(bool on, const Cam& cam, float rx, float ry, float rz, float t0,
                               const float* bank, const float* lane_bank, const float* ad,
                               const float* ex) {
    Ray ray = ray_start(cam.o[0], cam.o[1], cam.o[2], rx, ry, rz, t0);
    bool active = on && !(ray.d > MAX_D);
    float hit_d = -1.0f;
    CullTile tile;
    Box held = empty_box();
    for (int step = 0; step < MAX_STEPS; ++step) {
        if (!__any_sync(0xffffffffu, active)) break;
        if (hold_box(held, warp_span(active, ray.vx), warp_span(active, ray.vy),
                     warp_span(active, ray.vz))) {
            cull_tile_lanes(held.x, held.y, held.z, lane_bank, ad, ex, tile.preds, tile.substs);
            if constexpr (CULL_COUNTING) count_cull(0, 0, 1);
        }
        if constexpr (CULL_COUNTING) {
            const int n = __popc(__ballot_sync(0xffffffffu, active));
            count_cull(n, n * pred_groups(tile.preds), 0);
        }
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
// image, which still takes part in the warp's reductions and its lane
// chains.  Every lane of the warp must call it.  The hoisted cull, one
// chain per tile over its ``hoisted_box``, serves the whole march in the
// hoisted mode and the FD normals in both modes; it runs once per warp, in
// every lane (``cull_tile``): spread over the lanes it saved nothing and
// read 2% slower on Design1 (PERF.md).
__device__ Rgb render_pixel_culled(bool on, int ix, int iy, int width, int height, const Cam& cam,
                                   const float* bank, const float* lane_bank, const float* ad,
                                   const float* ex, float t0) {
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
    const float d = march_dynamic(on, cam, rx, ry, rz, t0, bank, lane_bank, ad, ex);
    if constexpr (CULL_COUNTING) {
        const int normals = 6 * __popc(__ballot_sync(0xffffffffu, on && d > 0.0f));
        count_cull(normals, normals * pred_groups(hoisted.preds), 1);
    }
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
struct ConeRay {
    float vx, vy, vz, d, tprev;
};

// One step of a cone ray on s = sdf * TOL at its point; false once it stops.
HD bool cone_advance(ConeRay& r, float rx, float ry, float rz, float s) {
    if (s < EPS + r.d * CONE_SLOPE) return false;
    r.tprev = r.d;
    r.vx += s * rx;
    r.vy += s * ry;
    r.vz += s * rz;
    r.d += s;
    if (r.d > MAX_D) {
        if (!CONE_STRICT) r.tprev = r.d;
        return false;
    }
    return true;
}

HD float cone_ray(float ox, float oy, float oz, float rx, float ry, float rz,
                  const float* bank, const float* ad, const float* ex) {
    ConeRay r{ox, oy, oz, 0.0f, 0.0f};
    for (int step = 0; step < MAX_STEPS; ++step) {
        if (!cone_advance(r, rx, ry, rz, field_sdf(r.vx, r.vy, r.vz, bank, ad, ex) * TOL)) break;
    }
    return r.tprev;
}
