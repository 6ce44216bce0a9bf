// Cone prepass of the hierarchical viewport, for one scene.
//
// Replaces the JAX package's Pallas kernel
//   ops/pallas/march_kernel.py:make_pallas_cone_march.
//
// Each coarse ray (through the centre pixel of an FxF block) marches with the
// cone-inflated stop test s < EPS + d*CONE_SLOPE (march.cuh cone_ray) and
// writes t_safe, from which every fine ray of its block starts
// (march_kernel.cu with a t0 plane).
//
// What bounds it on Hopper: FP32 issue, as the renderer: tens of tape
// evaluations per ray against 16 B moved (12 B of ray read, 4 B written).
// At 640x480 and F = 5 there are only 96x128 = 12,288 rays, under one wave of
// the card (132 SMs at 128 threads a block); later work may cut the blocks
// smaller or march several images at once.
//
// The simple design: one thread per ray with its own loop (per-ray early
// exit, which the TPU kernel's masked per-tile loop computes), rays as an
// AoS input f32[N, 3] formed by the caller exactly as its plain version forms
// them, the object banks in shared memory, and the projected camera origin,
// the slope, CONE_STRICT, EPS, TOL, MAX_D and MAX_STEPS as constants or
// parameters.  Built with -fmad=false, as the renderer (ops/cuda/build.py):
// one rounding decides where a march stops.
//
// Needs the generated scene code, common.cuh and march.cuh above it.
#include <cuda_runtime.h>

constexpr int CONE_THREADS = 128;

__global__ void __launch_bounds__(CONE_THREADS)
cone_march_kernel(float* __restrict__ t_safe, long long n, const float* __restrict__ rays,
                  float ox, float oy, float oz, const float* __restrict__ pos,
                  const float* __restrict__ right, const float* __restrict__ up,
                  const float* __restrict__ fwd, const float* __restrict__ ad) {
    __shared__ float s_bank[N_OBJ * BANK_STRIDE];
    load_bank(s_bank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    t_safe[i] = cone_ray(ox, oy, oz, rays[3 * i], rays[3 * i + 1], rays[3 * i + 2], s_bank, ad);
}

extern "C" int launch_cone_march(void* t_safe, long long n, const void* rays, float ox, float oy,
                                 float oz, const void* pos, const void* right, const void* up,
                                 const void* fwd, const void* ad, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + CONE_THREADS - 1) / CONE_THREADS);
    cone_march_kernel<<<blocks, CONE_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)t_safe, n, (const float*)rays, ox, oy, oz, (const float*)pos,
        (const float*)right, (const float*)up, (const float*)fwd, (const float*)ad);
    return (int)cudaGetLastError();
}
