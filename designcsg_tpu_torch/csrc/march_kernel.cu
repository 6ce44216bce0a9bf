// Fused k1 viewport renderer for one scene: exact or over-relaxed march (the
// generated constant OMEGA), from the camera or from a per-pixel start plane.
//
// Replaces the JAX package's Pallas kernel
//   ops/pallas/march_kernel.py:make_pallas_renderer (exact and over-relaxed
//   march, optional t0 input, and the exact per-tile cull, K7: the generated
//   CULL_MODE is 0 off, 1 hoisted, 2 dynamic).
//
// What bounds it on Hopper: FP32 issue.  Each pixel runs tens to hundreds of
// march steps, each a full evaluation of the tape plus the gizmo, then six more
// for its normal and one per object to attribute its material, and writes
// only 12 B (RGB) at the end.  Rays diverge: a warp runs as long as its
// slowest ray.
//
// The simple design: one thread per pixel with its own march loop (per-ray
// early exit, which is what the TPU kernel's masked per-tile loop computes:
// masked steps change nothing), blocks of 16x8 pixels so a warp holds a 16x2
// patch of neighbouring rays that tend to finish together, the camera as a
// kernel parameter, and RGB written interleaved as the (H, W, 3) image.  The
// TPU kernel's 32x32 tile-major layout and K-step unroll are Mosaic
// mechanisms and are not reproduced.  The optional t0 plane (f32[H, W], the
// cone prepass's handoff) is one more read per pixel; a null pointer starts
// every ray at the camera.  ``ex`` holds the scene's baked tables
// (csrc/table.cuh), null for a scene without.  This unit is built with
// -fmad=false (ops/cuda/build.py): every product and sum rounds as in the
// plain version, so a ray stops at the same step; with FMA contraction,
// single pixels at creases shaded up to 1.2e-3 apart.
//
// The object bank of a scene of more than 4 objects lives in constant
// memory (common.cuh BANK_CONSTANT; the rule: ops/cuda/tape.py
// RENDER_CONSTANT_BANK_MIN_OBJECTS): in shared memory the compiler held
// every object's frame in registers across the march (Design1: 208
// registers, 2 blocks an SM); as operands of the FP32 instructions it takes
// none.  Design2's 3 objects cost few registers so, and its frames ran
// faster with them there; so did Design1's under the hoisted cull
// (registers and the A/B: PERF.md).
//
// The cull (march.cuh render_pixel_culled): the TPU kernel's tile, an (8, 128)
// lock-stepped vector with one scalar interval chain, becomes the warp, a
// 16x2 patch of this block.  Every lane runs the TPU's scalar chain on the
// warp's box (shuffle reductions), so the predicates are warp-uniform and a
// skipped group costs no divergence; lanes outside the image take part in
// the chain and the reductions and write nothing.  The dynamic mode runs a
// chain whenever the warp's points leave the box it holds, and there the
// chain is spread over the lanes (march.cuh cull_tile_lanes): lane k
// computes slot k's interval (its object's frame interval, then one pass
// per brush kind), shuffles gather the slots into every lane, and the
// relevance tree runs warp-uniform.  What a warp issues per chain, counted
// from the generated code (ops/cuda/tape.py lane_chain_ops, with the
// gizmo): Design1 319 FP32 operations and 24 shuffles where every lane ran
// the one-thread chain's 1,163; Design2 302 and 8 (410) and Logo 1,261 and
// 12 (1,484: its letters have three interval bodies, so only the frame
// intervals run in parallel).  On the H100 the lane chain ran Design1's
// dynamic frame 26% faster than the one-thread chain and no design's
// slower (PERF.md).
//
// Needs the generated scene code, common.cuh and march.cuh above it.
#include <cuda_runtime.h>

constexpr int RENDER_BX = 16;
constexpr int RENDER_BY = 8;

__global__ void __launch_bounds__(RENDER_BX * RENDER_BY)
render_kernel(float* __restrict__ out, int height, int width, int row0, int rows, Cam cam,
              const float* __restrict__ t0, const float* __restrict__ pos,
              const float* __restrict__ right, const float* __restrict__ up,
              const float* __restrict__ fwd, const float* __restrict__ ad,
              const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(bank, lane_bank, gbank, pos, right, up, fwd);
    const int ix = blockIdx.x * RENDER_BX + threadIdx.x;
    const int ly = blockIdx.y * RENDER_BY + threadIdx.y;  // row of the block
    const int iy = row0 + ly;                              // row of the frame
    const bool on = ix < width && ly < rows;
    const long long pixel = (long long)ly * width + ix;
#if CULL_MODE
    const Rgb c = render_pixel_culled(on, ix, iy, width, height, cam, bank, lane_bank, ad, ex,
                                      on && t0 ? t0[pixel] : 0.0f);
    if (!on) return;
#else
    if (!on) return;
    const Rgb c = render_pixel(ix, iy, width, height, cam, bank, ad, ex, t0 ? t0[pixel] : 0.0f);
#endif
    float* px = out + 3 * pixel;
    px[0] = c.r;
    px[1] = c.g;
    px[2] = c.b;
}

// Rows [row0, row0 + rows) of the height x width frame into ``out``
// f32[rows, width, 3]; ``t0`` (null: from the camera) is f32[rows, width].
extern "C" int launch_render(void* out, int height, int width, int row0, int rows,
                             const float* cam_host, const void* t0, SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if (rows <= 0 || width <= 0) return 0;
    if (row0 < 0 || row0 + rows > height) return (int)cudaErrorInvalidValue;
    Cam cam;
    for (int k = 0; k < 3; ++k) {
        cam.o[k] = cam_host[k];
        cam.rgt[k] = cam_host[3 + k];
        cam.upp[k] = cam_host[6 + k];
        cam.fwd[k] = cam_host[9 + k];
    }
    const dim3 block(RENDER_BX, RENDER_BY);
    const dim3 grid((width + RENDER_BX - 1) / RENDER_BX, (rows + RENDER_BY - 1) / RENDER_BY);
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    render_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, height, width, row0, rows, cam, (const float*)t0, SCENE_ARGS);
    return (int)cudaGetLastError();
}
