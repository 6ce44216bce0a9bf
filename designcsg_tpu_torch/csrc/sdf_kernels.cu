// SDF point evaluation (k2) and SDF grid evaluation, for one scene.
//
// Replaces the JAX package's Pallas kernels
//   ops/pallas/sdf_kernel.py:make_pallas_point_eval (point eval) and
//   ops/pallas/sdf_kernel.py:make_grid_eval (grid eval).
//
// What bounds them on Hopper: the unrolled tape is FP32 issue.  Design1's tape
// costs ~300 FP32 operations per point against 16 B moved per point for point
// eval (12 B read, 4 B written) and 4 B per point for grid eval (coordinates
// are made from the thread index, nothing is read), i.e. roughly 19 and 75
// operations per byte, above the H100's ~20 FP32 operations per byte of
// bandwidth: both kernels are compute-bound, the grid kernel clearly so.
//
// The simple design: one thread per point, the tape inlined into straight-line
// code with its registers in registers, and the object banks (a few hundred
// bytes) copied once per block into shared memory, where every thread reads
// the same word (a broadcast).  Points stay AoS (x, y, z interleaved), the
// layout the callers hold; a warp's 32 points are 384 contiguous bytes.
// The grid kernel writes z-major (slab, ny, nx), x fastest across a warp, so
// its stores coalesce.
//
// Needs the generated scene code (field_sdf, N_OBJ) and common.cuh above it.
#include <cuda_runtime.h>

constexpr int SDF_THREADS = 256;

__global__ void __launch_bounds__(SDF_THREADS)
point_eval_kernel(const float* __restrict__ pts, float* __restrict__ out, long long n,
                  const float* __restrict__ pos, const float* __restrict__ right,
                  const float* __restrict__ up, const float* __restrict__ fwd,
                  const float* __restrict__ ad) {
    __shared__ float s_bank[N_OBJ * BANK_STRIDE];
    load_bank(s_bank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = field_sdf(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], s_bank, ad);
}

// SDF at lo + cell * (x, y, z0 + z) for the (nz, ny, nx) lattice, each
// coordinate rounded exactly as the plain version computes it
// (sdf_kernel.py:228-233 of the JAX package).
__global__ void __launch_bounds__(SDF_THREADS)
grid_eval_kernel(float* __restrict__ out, int nz, int ny, int nx, float lox, float loy,
                 float loz, float cell, float z0, const float* __restrict__ pos,
                 const float* __restrict__ right, const float* __restrict__ up,
                 const float* __restrict__ fwd, const float* __restrict__ ad) {
    __shared__ float s_bank[N_OBJ * BANK_STRIDE];
    load_bank(s_bank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long plane = (long long)ny * nx;
    if (i >= plane * nz) return;
    const int zi = (int)(i / plane);
    const int rem = (int)(i - (long long)zi * plane);
    const int yi = rem / nx;
    const int xi = rem - yi * nx;
    const float x = add_rn(lox, mul_rn(cell, (float)xi));
    const float y = add_rn(loy, mul_rn(cell, (float)yi));
    const float z = add_rn(loz, mul_rn(cell, add_rn(z0, (float)zi)));
    out[i] = field_sdf(x, y, z, s_bank, ad);
}

static unsigned int blocks_for(long long n) {
    return (unsigned int)((n + SDF_THREADS - 1) / SDF_THREADS);
}

extern "C" int launch_point_eval(const void* pts, void* out, long long n, const void* pos,
                                 const void* right, const void* up, const void* fwd,
                                 const void* ad, void* stream) {
    if (n <= 0) return 0;
    point_eval_kernel<<<blocks_for(n), SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (float*)out, n, (const float*)pos, (const float*)right,
        (const float*)up, (const float*)fwd, (const float*)ad);
    return (int)cudaGetLastError();
}

extern "C" int launch_grid_eval(void* out, int nz, int ny, int nx, float lox, float loy,
                                float loz, float cell, float z0, const void* pos,
                                const void* right, const void* up, const void* fwd,
                                const void* ad, void* stream) {
    const long long n = (long long)nz * ny * nx;
    if (n <= 0) return 0;
    grid_eval_kernel<<<blocks_for(n), SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)out, nz, ny, nx, lox, loy, loz, cell, z0, (const float*)pos,
        (const float*)right, (const float*)up, (const float*)fwd, (const float*)ad);
    return (int)cudaGetLastError();
}
