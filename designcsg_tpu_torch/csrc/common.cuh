// Definitions shared by every generated scene source.
//
// ops/cuda/tape.py assembles one translation unit per kernel from the files
// in this directory and the generated scene code, in this order:
//   scene constants (generated) -> common.cuh -> brush/material bodies and the
//   unrolled tape (generated) -> march.cuh (renderer only) -> the kernel file.
// Per-point math is HD: __host__ __device__ under nvcc and plain inline
// functions under a host C++ compiler, so the same generated scene code also
// builds on the host (tests/test_torch_codegen.py).
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

constexpr float MAX_DISTANCE = 64.0f;
constexpr float INITIAL_SCALE = 5.0f;
constexpr float AXES_RADIUS = 0.015f;
constexpr float AXES_SHADE_RADIUS = 0.025f;
// Floats per object in the bank copy a kernel keeps in shared memory:
// position, right, up, forward (reciprocal frame rows), 3 each.
constexpr int BANK_STRIDE = 12;

struct Rgb {
    float r, g, b;
};

// Projected camera origin and the camera frame (rows), as the renderer gets
// them (march_kernel.py:733-740 of the JAX package).
struct Cam {
    float o[3];
    float rgt[3];
    float upp[3];
    float fwd[3];
};

// Rounded product and sum that the compiler may not contract into an FMA:
// the grid kernel builds lattice coordinates bit-exactly as the plain
// version does.
HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fadd_rn(a, b);
#else
    return a + b;
#endif
}

HD float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
    return rsqrtf(x);
#else
    return 1.0f / sqrtf(x);
#endif
}

// max(|h| - 1/2, sqrt(r2) - radius): one gizmo axis cylinder (k1.cl:41-43).
HD float axes_cylinder(float r2, float h, float radius) {
    return fmaxf(fabsf(h) - 0.5f, sqrtf(r2) - radius);
}

// The three k1 gizmo cylinders at 1/INITIAL_SCALE (k1.cl:237-270).
HD float gizmo_sdf(float x, float y, float z) {
    const float xs = x / INITIAL_SCALE, ys = y / INITIAL_SCALE, zs = z / INITIAL_SCALE;
    const float dx = axes_cylinder(ys * ys + zs * zs, xs - 0.5f, AXES_RADIUS);
    const float dy = axes_cylinder(xs * xs + zs * zs, ys - 0.5f, AXES_RADIUS);
    const float dz = axes_cylinder(xs * xs + ys * ys, zs - 0.5f, AXES_RADIUS);
    return fminf(dx, fminf(dy, dz));
}

#ifdef __CUDACC__
// Copy the four object banks into the block's shared bank, interleaved per
// object.  Every thread of the block must call it.
__device__ __forceinline__ void load_bank(float* s_bank, const float* pos, const float* right,
                                          const float* up, const float* fwd) {
    const int nthreads = blockDim.x * blockDim.y;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < N_OBJ * 3; i += nthreads) {
        const int row = (i / 3) * BANK_STRIDE + i % 3;
        s_bank[row] = pos[i];
        s_bank[row + 3] = right[i];
        s_bank[row + 6] = up[i];
        s_bank[row + 9] = fwd[i];
    }
    __syncthreads();
}
#endif
