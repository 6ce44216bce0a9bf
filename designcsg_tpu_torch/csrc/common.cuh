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
// A function that every call site calls, where a copy at each would make
// the unit too large for the compiler (ops/cuda/tape.py tape_qualifier).
#define HD_CALL __host__ __device__ __noinline__
#else
#define HD inline
#define HD_CALL inline
#endif

constexpr float MAX_DISTANCE = 64.0f;
constexpr float INITIAL_SCALE = 5.0f;
constexpr float AXES_RADIUS = 0.015f;
constexpr float AXES_SHADE_RADIUS = 0.025f;
// Floats per object in the interleaved bank a kernel reads: position,
// right, up, forward (reciprocal frame rows), 3 each.
constexpr int BANK_STRIDE = 12;

// Word ``i`` of the bank row ``o``.  Where the bank lies in global memory
// (BANK_GLOBAL) the read goes through the read-only data cache; the lanes of
// a warp read the same word at once, which L1 serves as a broadcast.
HD float bank_word(const float* o, int i) {
#if defined(__CUDA_ARCH__) && BANK_GLOBAL
    return __ldg(o + i);
#else
    return o[i];
#endif
}

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

HD float sub_rn(float a, float b) { return add_rn(a, -b); }

// A lattice coordinate lo + cell * i, one rounded product and one rounded
// sum, as the plain version makes it (sdf_kernel.py:228-233 of the JAX
// package).
HD float lattice(float lo, float cell, float i) { return add_rn(lo, mul_rn(cell, i)); }

// a * b + c as the unit's build rounds it: one fused multiply-add where the
// build contracts (nvcc's default: the point and grid unit), a rounded
// product and a rounded sum where it does not (the -fmad=false units, which
// ops/cuda/build.py builds with NO_FMA_CONTRACTION, and the host build).
// Written out, so that two forms of one sum round alike whatever nvcc would
// contract: the frame transform's point and column forms (frame_terms).
HD float madd(float a, float b, float c) {
#if defined(__CUDA_ARCH__) && !defined(NO_FMA_CONTRACTION)
    return __fmaf_rn(a, b, c);
#else
    return add_rn(mul_rn(a, b), c);
#endif
}

// An object's frame transform (k2.cl:105-113), split at z: ``frame_terms``
// gives the z-invariant part of each local coordinate at world (x, y, .),
// (x - o[0]) * o[3r + 3] + (y - o[1]) * o[3r + 4] for frame row r, and
// brush_<k>_column (ops/cuda/tape.py) finishes row r at z with
// madd(z - o[2], o[3r + 5], h[r]).  The point form (brush_<k>_at) and the
// grid kernel's column form (terms once per lattice column, the rows
// finished per point) run the same code, so they give the same bits.  The
// fused form is fma(dz, o5, fma(dx, o3, dy * o4)), the contraction nvcc
// makes of the sum (dx*o3 + dy*o4) + dz*o5 as the point form wrote it
// before; built without contraction every product and sum rounds on its
// own, in that sum's order.
HD void frame_terms(float x, float y, const float* o, float* h) {
    const float dx = sub_rn(x, bank_word(o, 0)), dy = sub_rn(y, bank_word(o, 1));
    h[0] = madd(dx, bank_word(o, 3), mul_rn(dy, bank_word(o, 4)));
    h[1] = madd(dx, bank_word(o, 6), mul_rn(dy, bank_word(o, 7)));
    h[2] = madd(dx, bank_word(o, 9), mul_rn(dy, bank_word(o, 10)));
}

// IEEE-rounded quotient and square root, whatever the build's flags.
HD float div_rn(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fdiv_rn(a, b);
#else
    return a / b;
#endif
}

HD float sqrt_rn(float x) {
#ifdef __CUDA_ARCH__
    return __fsqrt_rn(x);
#else
    return sqrtf(x);
#endif
}

// The SDF and its FD normal at (x, y, z), in the order of the plain version
// (ops/interpreter.py make_normal_fn over a point evaluation): the six
// offset points are the point plus or minus (NORMAL_EPS, 0, 0) and its
// permutations, one f32 sum or difference per coordinate (adding 0 turns
// -0 into +0, as it does there); g_i = f(p + e_i) - f(p - e_i); g / (2e);
// then g / sqrt((g0*g0 + g1*g1) + g2*g2).  Every operation is rounded on
// its own, so the result is that composition's bit for bit wherever the
// seven field values are.  ``field(x, y, z)`` is the unit's SDF; NORMAL_EPS
// is constants.py's NORMAL_EPSILON, the evaluator's.
constexpr float NORMAL_EPS = 0.005f;

template <class Field>
HD float sdf_fd_normal(const Field& field, float x, float y, float z, float& nx, float& ny,
                       float& nz) {
    const float e = NORMAL_EPS;
    const float s = field(x, y, z);
    float g[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
        const float ox = axis == 0 ? e : 0.0f, oy = axis == 1 ? e : 0.0f, oz = axis == 2 ? e : 0.0f;
        const float hi = field(add_rn(x, ox), add_rn(y, oy), add_rn(z, oz));
        const float lo = field(sub_rn(x, ox), sub_rn(y, oy), sub_rn(z, oz));
        g[axis] = div_rn(sub_rn(hi, lo), mul_rn(2.0f, e));
    }
    const float norm = sqrt_rn(add_rn(add_rn(mul_rn(g[0], g[0]), mul_rn(g[1], g[1])),
                                      mul_rn(g[2], g[2])));
    // A zero gradient gives a zero normal, as OpenCL's normalize does.
    const float length = norm > 0.0f ? norm : 1.0f;
    nx = div_rn(g[0], length);
    ny = div_rn(g[1], length);
    nz = div_rn(g[2], length);
    return s;
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

// The three k1 gizmo cylinders at 1/INITIAL_SCALE (k1.cl:237-270); its sums
// of squares written out (madd, in the order nvcc contracted a * a + b * b),
// so the grid kernel's column form, where x and y are loop-invariant,
// rounds them as the point form does.
HD float gizmo_sdf(float x, float y, float z) {
    const float xs = x / INITIAL_SCALE, ys = y / INITIAL_SCALE, zs = z / INITIAL_SCALE;
    const float dx = axes_cylinder(madd(ys, ys, mul_rn(zs, zs)), xs - 0.5f, AXES_RADIUS);
    const float dy = axes_cylinder(madd(xs, xs, mul_rn(zs, zs)), ys - 0.5f, AXES_RADIUS);
    const float dz = axes_cylinder(madd(xs, xs, mul_rn(ys, ys)), zs - 0.5f, AXES_RADIUS);
    return fminf(dx, fminf(dy, dz));
}

#ifdef __CUDACC__
// Make ``device`` the current card of this unit's runtime before a host
// function's first runtime call.  nvcc links the CUDA runtime into every
// unit statically, so each unit keeps a current device of its own, apart
// from PyTorch's: every launcher is told the card of its tensors.
static int use_device(int device) { return (int)cudaSetDevice(device); }

// Every launcher takes the scene's banks (pos, right, up, fwd), its
// arbitrary data ``ad`` and extra tables ``ex``, the launch's interleaved
// bank buffer ``gbank`` (BANK_GLOBAL only, else null), the card of its
// tensors and the stream; it returns a cudaError_t.
#define SCENE_PARAMS                                                                     \
    const void *pos, const void *right, const void *up, const void *fwd, const void *ad, \
        const void *ex, void *gbank, int device, void *stream
#define SCENE_ARGS                                                                        \
    (const float*)pos, (const float*)right, (const float*)up, (const float*)fwd,          \
        (const float*)ad, (const float*)ex, (const float*)gbank

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

// The interleaved bank (BANK_STRIDE floats an object) of the four bank
// arrays, written to ``dst`` in global memory by one block.
__global__ void interleave_bank_kernel(const float* __restrict__ pos,
                                       const float* __restrict__ right,
                                       const float* __restrict__ up,
                                       const float* __restrict__ fwd, float* __restrict__ dst) {
    for (int i = threadIdx.x; i < N_OBJ * 3; i += blockDim.x) {
        const int row = (i / 3) * BANK_STRIDE + i % 3;
        dst[row] = pos[i];
        dst[row + 3] = right[i];
        dst[row + 6] = up[i];
        dst[row + 9] = fwd[i];
    }
}

// Where a kernel reads the object bank (BANK_CONSTANT and BANK_GLOBAL,
// generated per unit by ops/cuda/tape.py bank_placement, from the bytes
// each placement needs).  A kernel takes the bank through
// SCENE_BANK(name, lane_name, gbank, pos, right, up, fwd): ``name`` for its
// warp-uniform reads, ``lane_name`` for reads whose row differs between the
// lanes of a warp (the lane chain of the cull, interval.cuh), ``gbank`` the
// launch's interleaved bank in global memory (null unless BANK_GLOBAL).
//
// Shared (neither): a copy in the block's shared memory (load_bank).  Every
//    lane reads the same word at the same moment, a broadcast, but through
//    an LDS into a register; inside a march loop the compiler hoists those
//    loads out of the loop, so the bank of every live object stays in
//    registers for the whole march (Design1's fit march: 149 registers,
//    PERF.md).  A static array: with the kernel's other shared buffers it
//    must stay within the 48 KB a block may declare (48 B an object).
// BANK_CONSTANT: ``c_bank`` in constant memory, where an FP32 instruction
//    takes a bank word as an operand (c[0x3][...]) and no register holds
//    it.  The launcher fills it on the launch's stream before the kernel,
//    device to device (``prepare_bank``: one tiny interleaving kernel into
//    ``g_bank`` and one copy to the symbol), so the banks may change on the
//    card between launches, as the fit's do, with no host copy and no
//    synchronisation.  One unit holds one bank per card: launches of a
//    unit on a card are ordered on one stream (ops/cuda/build.py
//    stream_handle).  ``g_bank``, the same interleaved bank in global
//    memory, serves the lane-dependent reads, which constant memory would
//    serialise.  64 KB of constant memory hold 1,365 objects
//    (ops/cuda/tape.py BANK_CONSTANT_MAX_OBJECTS).
// BANK_GLOBAL: the interleaved bank in a device buffer that the caller
//    allocates and passes per launch (``gbank``), filled by the launcher on
//    the launch's stream; reads go through __ldg (bank_word).  No size
//    limit and no state of the unit: the placement of a scene whose bank
//    fits neither of the others.
#if BANK_CONSTANT
static_assert(N_OBJ * BANK_STRIDE * sizeof(float) <= 65536,
              "a __constant__ bank holds at most 1365 objects");
__constant__ float c_bank[N_OBJ * BANK_STRIDE];
__device__ float g_bank[N_OBJ * BANK_STRIDE];

// Fill g_bank and c_bank from the four bank arrays on ``stream``; returns a
// cudaError_t.
static int prepare_bank(const void* pos, const void* right, const void* up, const void* fwd,
                        void*, cudaStream_t stream) {
    void* dst = nullptr;
    int rc = (int)cudaGetSymbolAddress(&dst, g_bank);
    if (rc != 0) return rc;
    interleave_bank_kernel<<<1, 256, 0, stream>>>((const float*)pos, (const float*)right,
                                                  (const float*)up, (const float*)fwd,
                                                  (float*)dst);
    rc = (int)cudaGetLastError();
    if (rc == 0) {
        rc = (int)cudaMemcpyToSymbolAsync(c_bank, dst, sizeof(c_bank), 0,
                                          cudaMemcpyDeviceToDevice, stream);
    }
    return rc;
}

#define SCENE_BANK(name, lane_name, gbank, pos, right, up, fwd) \
    const float* name = c_bank;                                  \
    const float* lane_name = g_bank;                             \
    (void)lane_name
#elif BANK_GLOBAL
// Fill the launch's bank buffer ``gbank`` (N_OBJ * BANK_STRIDE floats) on
// ``stream``; returns a cudaError_t.
static int prepare_bank(const void* pos, const void* right, const void* up, const void* fwd,
                        void* gbank, cudaStream_t stream) {
    if (gbank == nullptr) return (int)cudaErrorInvalidValue;
    interleave_bank_kernel<<<1, 256, 0, stream>>>((const float*)pos, (const float*)right,
                                                  (const float*)up, (const float*)fwd,
                                                  (float*)gbank);
    return (int)cudaGetLastError();
}

#define SCENE_BANK(name, lane_name, gbank, pos, right, up, fwd) \
    const float* name = gbank;                                   \
    const float* lane_name = gbank;                              \
    (void)lane_name
#else
static int prepare_bank(const void*, const void*, const void*, const void*, void*, cudaStream_t) {
    return 0;
}

#define SCENE_BANK(name, lane_name, gbank, pos, right, up, fwd) \
    __shared__ float name[N_OBJ * BANK_STRIDE];                  \
    static_assert(N_OBJ * BANK_STRIDE * sizeof(float) <= 48 * 1024, \
                  "a shared bank holds at most 1024 objects (ops/cuda/tape.py bank_placement)"); \
    load_bank(name, pos, right, up, fwd);                        \
    const float* lane_name = name;                               \
    (void)lane_name
#endif
#endif
