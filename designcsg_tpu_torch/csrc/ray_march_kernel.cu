// Batched ray march with closest approach, for one scene: the forward march of
// the differentiable fit.
//
// Replaces the JAX package's Pallas kernel
//   ops/pallas/march_kernel.py:make_pallas_ray_march.
//
// Each ray of an input batch marches from the projected camera origin
// (march.cuh march_ray_closest) and writes its hit distance d (-1 on a miss)
// and its closest-approach point vmin.  The fit reattaches gradients at those
// points with the plain tape under autograd (ops/raymarch.py), so this kernel
// is forward only, as the TPU one is.
//
// What bounds it on Hopper: FP32 issue and the latency of a serial march.
// A ray moves 28 B (12 B of ray read, 4 B of d and 12 B of vmin written)
// against tens to hundreds of tape evaluations, each step waiting on the
// last.  The unit builds with -fmad=false (P1, ops/cuda/build.py: one
// rounding decides where a march stops and which point is closest), so the
// FP32 pipe retires one operation per lane and clock, not two: the reachable
// ceiling is half the card's 67 TFLOP/s bound.  Measured on the H100
// (PERF.md), the questions and what the design does about each:
//
// * Registers and occupancy.  With the bank in shared memory the compiler
//   hoists its loads out of the march loop (Design1: all 30 LDS before the
//   loop, 396 instructions a step inside it, 305 of them FP32) and holds
//   every live object's frame in registers: 149, 3 blocks of 128 an SM.
//   More blocks did not help: at most 128 registers (4 blocks) ran 2%
//   slower, at most 64 (8 blocks, with spills) 12% slower, and the constant
//   bank (31 registers) 4% slower.  So a scene without tables keeps that
//   build.  Where the shared build reloads the bank every step (Logo), the
//   bank lives in constant memory (common.cuh BANK_CONSTANT), where an
//   FP32 instruction takes a bank word as its operand.  The rule:
//   ops/cuda/tape.py ray_march_bank_constant.
// * Divergence and the tail.  A warp of 32 neighbouring rays runs as long as
//   its longest ray (83.5% of Design1's lane-steps busy at 640x480, 80.5% of
//   Logo's; chip_smoke.py k4_warp_lane_share).  Persistent warps that refill
//   their finished lanes from a global counter (Aila and Laine,
//   Understanding the Efficiency of Ray Traversal on GPUs, HPG 2009) were
//   built and measured: they raised Design2's lane share and ran its march
//   faster, but ran Design1's and Logo's, the fit's main paths, slower (the
//   atomic, the ray load and the restart against a light step; Logo's
//   refilled lanes read the letter planes at scattered positions).  So
//   every scene runs one thread per ray, a grid over the batch; refill
//   comes back when a main path marches a heavy tape.  At `cli fit`'s 64x48
//   (3,072 rays) the grid is 24 blocks on 132 SMs: the batch cannot fill
//   the card.
//
// The rays are an AoS input f32[N, 3] formed by the caller exactly as its
// plain version forms them; the origin is a device pointer f32[3] (the
// fit's lies on the card: no host copy before a launch); vmin is written
// interleaved as f32[N, 3]; the scene's baked tables (if any) come as
// ``ex`` (Logo's letter planes).  The TPU kernel's three (rows, 128) planes
// and its (8, 128) tiles are Mosaic layout and are not reproduced.  OMEGA
// (generated) > 1 compiles the over-relaxed march.
//
// Needs the generated scene code, common.cuh and march.cuh above it.
#include <cuda_runtime.h>

constexpr int RAY_THREADS = 128;

__global__ void __launch_bounds__(RAY_THREADS)
ray_march_kernel(float* __restrict__ d, float* __restrict__ vmin, long long n,
                 const float* __restrict__ rays, const float* __restrict__ o,
                 const float* __restrict__ pos, const float* __restrict__ right,
                 const float* __restrict__ up, const float* __restrict__ fwd,
                 const float* __restrict__ ad, const float* __restrict__ ex,
                 const float* __restrict__ gbank) {
    SCENE_BANK(bank, lane_bank, gbank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float mx, my, mz;
    d[i] = march_ray_closest(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2],
                             bank, ad, ex, mx, my, mz);
    vmin[3 * i] = mx;
    vmin[3 * i + 1] = my;
    vmin[3 * i + 2] = mz;
}

extern "C" int launch_ray_march(void* d, void* vmin, long long n, const void* rays, const void* o,
                                SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + RAY_THREADS - 1) / RAY_THREADS);
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    ray_march_kernel<<<blocks, RAY_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)d, (float*)vmin, n, (const float*)rays, (const float*)o, SCENE_ARGS);
    return (int)cudaGetLastError();
}
