// Interval arithmetic of the exact per-tile cull (K7): the C++ twin of the
// helpers of ops/cull.py, operation for operation, so that the generated
// ``cull_tile`` and the plain culler give the same bits.
//
// Every product and sum rounds on its own (mul_rn/add_rn/sub_rn of
// common.cuh: the point and grid unit contracts FMAs elsewhere).  Needs common.cuh above it.

struct Iv {
    float lo, hi;
};

// A tile's predicate mask: bit g % 32 of word g / 32 is set when group g must
// be evaluated (N_CULL_WORDS words, one bit per group of the cull plan).
struct Preds {
    unsigned w[N_CULL_WORDS];
};

HD Iv iv_const(float c) { return Iv{c, c}; }

HD Iv iv_add(Iv a, Iv b) { return Iv{add_rn(a.lo, b.lo), add_rn(a.hi, b.hi)}; }

HD Iv iv_sub(Iv a, Iv b) { return Iv{sub_rn(a.lo, b.hi), sub_rn(a.hi, b.lo)}; }

HD Iv iv_neg(Iv a) { return Iv{-a.hi, -a.lo}; }

HD Iv iv_min(Iv a, Iv b) { return Iv{fminf(a.lo, b.lo), fminf(a.hi, b.hi)}; }

HD Iv iv_max(Iv a, Iv b) { return Iv{fmaxf(a.lo, b.lo), fmaxf(a.hi, b.hi)}; }

// Interval times a (possibly negative) scalar.
HD Iv iv_mul_scalar(Iv a, float c) {
    const float x = mul_rn(a.lo, c), y = mul_rn(a.hi, c);
    return Iv{fminf(x, y), fmaxf(x, y)};
}

// General interval product (endpoint extremes).
HD Iv iv_mul(Iv a, Iv b) {
    const float p0 = mul_rn(a.lo, b.lo), p1 = mul_rn(a.lo, b.hi);
    const float p2 = mul_rn(a.hi, b.lo), p3 = mul_rn(a.hi, b.hi);
    return Iv{fminf(fminf(p0, p1), fminf(p2, p3)), fmaxf(fmaxf(p0, p1), fmaxf(p2, p3))};
}

HD Iv iv_abs(Iv a) { return Iv{fmaxf(fmaxf(a.lo, -a.hi), 0.0f), fmaxf(-a.lo, a.hi)}; }

HD Iv iv_square(Iv a) {
    const Iv m = iv_abs(a);
    return Iv{mul_rn(m.lo, m.lo), mul_rn(m.hi, m.hi)};
}

HD Iv iv_sqrt(Iv a) { return Iv{sqrtf(fmaxf(a.lo, 0.0f)), sqrtf(fmaxf(a.hi, 0.0f))}; }

// Interval of sqrt(a^2 + b^2 + c^2).
HD Iv iv_norm3(Iv a, Iv b, Iv c) {
    return iv_sqrt(iv_add(iv_add(iv_square(a), iv_square(b)), iv_square(c)));
}

// Widen by 1e-6 (|lo| + |hi|) + 1e-6: the cull engages only with a margin
// over the float evaluation of the brush (cull.py:539-545 of the JAX package).
HD Iv iv_pad(Iv a) {
    const float s = add_rn(mul_rn(add_rn(fabsf(a.lo), fabsf(a.hi)), 1e-6f), 1e-6f);
    return Iv{sub_rn(a.lo, s), add_rn(a.hi, s)};
}

// The object's local coordinates over the box: ((v-o).r, (v-o).u, (v-o).f)
// with the frame row ``o`` of the bank (position, right, up, forward).
HD void iv_local(Iv bx, Iv by, Iv bz, const float* o, Iv& a, Iv& b, Iv& c) {
#define W(i) bank_word(o, i)
    const Iv dx = iv_sub(bx, iv_const(W(0))), dy = iv_sub(by, iv_const(W(1)));
    const Iv dz = iv_sub(bz, iv_const(W(2)));
    a = iv_add(iv_add(iv_mul_scalar(dx, W(3)), iv_mul_scalar(dy, W(4))), iv_mul_scalar(dz, W(5)));
    b = iv_add(iv_add(iv_mul_scalar(dx, W(6)), iv_mul_scalar(dy, W(7))), iv_mul_scalar(dz, W(8)));
    c = iv_add(iv_add(iv_mul_scalar(dx, W(9)), iv_mul_scalar(dy, W(10))), iv_mul_scalar(dz, W(11)));
#undef W
}

// Interval twin of the k1 gizmo (cull.py:347-364 of the JAX package).
HD Iv iv_axes_cylinder(Iv r2, Iv h) {
    return iv_max(iv_sub(iv_abs(h), iv_const(0.5f)), iv_sub(iv_sqrt(r2), iv_const(AXES_RADIUS)));
}

HD Iv iv_gizmo(Iv bx, Iv by, Iv bz) {
    const float inv = 0.2f;  // 1 / INITIAL_SCALE, rounded
    const Iv xs = iv_mul_scalar(bx, inv), ys = iv_mul_scalar(by, inv), zs = iv_mul_scalar(bz, inv);
    const Iv half = iv_const(0.5f);
    const Iv dx = iv_axes_cylinder(iv_add(iv_square(ys), iv_square(zs)), iv_sub(xs, half));
    const Iv dy = iv_axes_cylinder(iv_add(iv_square(xs), iv_square(zs)), iv_sub(ys, half));
    const Iv dz = iv_axes_cylinder(iv_add(iv_square(xs), iv_square(ys)), iv_sub(zs, half));
    return iv_min(dx, iv_min(dy, dz));
}

// The culled grid's tile (sdf_kernel.py:205-248 of the JAX package): CULL_TX x
// CULL_TY x CULL_TZ lattice points lo + cell * (x, y, z0 + z), and its box,
// built from the lattice indices as the points are rounded.
constexpr int CULL_TX = 32;
constexpr int CULL_TY = 8;
constexpr int CULL_TZ = 8;

HD Iv lattice_span(float a, float b) { return Iv{fminf(a, b), fmaxf(a, b)}; }

// Generated after this file, from the scene's cull plan (ops/cuda/tape.py):
// the chain in one thread, and one slot of the lane chain and its tree.
HD void cull_tile(Iv bx, Iv by, Iv bz, const float* bank, const float* ad, const float* ex,
                  Preds& preds, float* substs);
HD Iv cull_lane(int chunk, int lane, Iv bx, Iv by, Iv bz, const float* bank, const float* ad,
                const float* ex);
HD void cull_tree(const Iv* bv, Preds& preds, float* substs);

// The box of the tile that starts at lattice index (x0, y0, zb).
HD void grid_tile_box(int x0, int y0, int zb, int nz, int ny, int nx, float lox, float loy,
                      float loz, float cell, float z0, Iv& bx, Iv& by, Iv& bz) {
    const int x1 = (x0 + CULL_TX < nx ? x0 + CULL_TX : nx) - 1;
    const int y1 = (y0 + CULL_TY < ny ? y0 + CULL_TY : ny) - 1;
    const int z1 = (zb + CULL_TZ < nz ? zb + CULL_TZ : nz) - 1;
    bx = lattice_span(lattice(lox, cell, (float)x0), lattice(lox, cell, (float)x1));
    by = lattice_span(lattice(loy, cell, (float)y0), lattice(loy, cell, (float)y1));
    bz = lattice_span(lattice(loz, cell, add_rn(z0, (float)zb)),
                      lattice(loz, cell, add_rn(z0, (float)z1)));
}

#ifdef __CUDACC__
// K7's chain on a box, spread over a warp's lanes: lane k runs slot 32c + k
// of chunk c (ops/cuda/tape.py cull_lane_function: its object's frame
// interval, then one pass per brush kind, so lanes of one kind run
// together), the slots' intervals are gathered into every lane by
// shuffles, and the relevance tree (``cull_tree``) runs warp-uniform.  Every
// lane ends with the same predicates and substitutes, bit for bit those of
// ``cull_tile`` on the same box: the same rounded operations, on another
// lane.  ``lane_bank`` is read at lane-dependent rows (common.cuh
// SCENE_BANK).  Every lane of the warp must call it.  The dynamic cull
// (march.cuh march_dynamic) and the culled grid (sdf_kernels.cu) run it.
__device__ __forceinline__ void cull_tile_lanes(Iv bx, Iv by, Iv bz, const float* lane_bank,
                                                const float* ad, const float* ex, Preds& preds,
                                                float* substs) {
    const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
    Iv b[N_CULL_SLOTS];
#pragma unroll
    for (int chunk = 0; chunk < N_CULL_CHUNKS; ++chunk) {
        const Iv mine = cull_lane(chunk, lane, bx, by, bz, lane_bank, ad, ex);
#pragma unroll
        for (int j = 0; j < 32 && 32 * chunk + j < N_CULL_SLOTS; ++j) {
            b[32 * chunk + j] = Iv{__shfl_sync(0xffffffffu, mine.lo, j),
                                   __shfl_sync(0xffffffffu, mine.hi, j)};
        }
    }
    cull_tree(b, preds, substs);
}
#endif
