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
// What bounds it on Hopper: FP32 issue, as the renderer: tens to hundreds of
// tape evaluations per ray against 28 B moved (12 B of ray read, 4 B of d and
// 12 B of vmin written).  Rays diverge: a warp runs as long as its slowest ray.
//
// The simple design, as the cone kernel's: one thread per ray with its own
// loop (per-ray early exit, which the TPU kernel's masked per-tile loop
// computes), rays as an AoS input f32[N, 3] formed by the caller exactly as
// its plain version forms them, the object banks in shared memory, the origin
// as three float parameters, vmin written interleaved as f32[N, 3].  The TPU
// kernel's three (rows, 128) planes and its (8, 128) tiles are Mosaic layout
// and are not reproduced.  OMEGA (generated) > 1 compiles the over-relaxed
// march.  Built with -fmad=false, as the renderer (ops/cuda/build.py): one
// rounding decides where a march stops and which point is closest.
//
// Needs the generated scene code, common.cuh and march.cuh above it.
#include <cuda_runtime.h>

constexpr int RAY_THREADS = 128;

__global__ void __launch_bounds__(RAY_THREADS)
ray_march_kernel(float* __restrict__ d, float* __restrict__ vmin, long long n,
                 const float* __restrict__ rays, float ox, float oy, float oz,
                 const float* __restrict__ pos, const float* __restrict__ right,
                 const float* __restrict__ up, const float* __restrict__ fwd,
                 const float* __restrict__ ad) {
    __shared__ float s_bank[N_OBJ * BANK_STRIDE];
    load_bank(s_bank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float mx, my, mz;
    d[i] = march_ray_closest(ox, oy, oz, rays[3 * i], rays[3 * i + 1], rays[3 * i + 2], s_bank,
                             ad, mx, my, mz);
    vmin[3 * i] = mx;
    vmin[3 * i + 1] = my;
    vmin[3 * i + 2] = mz;
}

extern "C" int launch_ray_march(void* d, void* vmin, long long n, const void* rays, float ox,
                                float oy, float oz, const void* pos, const void* right,
                                const void* up, const void* fwd, const void* ad, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + RAY_THREADS - 1) / RAY_THREADS);
    ray_march_kernel<<<blocks, RAY_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)d, (float*)vmin, n, (const float*)rays, ox, oy, oz, (const float*)pos,
        (const float*)right, (const float*)up, (const float*)fwd, (const float*)ad);
    return (int)cudaGetLastError();
}
