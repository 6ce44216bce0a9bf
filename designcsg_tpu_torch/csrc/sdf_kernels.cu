// SDF point evaluation (k2), in its single and its FD form, and SDF grid
// evaluation, for one scene.
//
// Replaces the JAX package's Pallas kernels
//   ops/pallas/sdf_kernel.py:make_pallas_point_eval (point eval) and
//   ops/pallas/sdf_kernel.py:make_grid_eval (grid eval, and with cull=True
//   its exact per-tile cull, K7: grid_eval_cull_kernel).
//
// What bounds them on Hopper: the unrolled tape is FP32 issue.  Design1's tape
// costs ~300 FP32 operations per point against 16 B moved per point for point
// eval (12 B read, 4 B written) and 4 B per point for grid eval (coordinates
// are made from the thread index, nothing is read), i.e. roughly 19 and 75
// operations per byte, above the H100's ~20 FP32 operations per byte of
// bandwidth: both kernels are compute-bound, the grid kernel clearly so.
// On the export's refine, though, what bound K1 was the host: each Newton
// step called it seven times (the SDF and the six FD probes) with a dozen
// PyTorch operations of glue between, and every launch was paid for on the
// host.  point_eval_fd_kernel is K1's FD form for that caller: per point the
// SDF and its FD normal in one launch (common.cuh sdf_fd_normal), seven
// evaluations against 28 B moved, so compute-bound at any batch the refine
// gives it.  It is persistent and grid-stride (as many blocks as are
// resident on the card, each loading the bank once), and a thread's seven
// evaluations are independent, the instruction-level parallelism that hides
// the tape's latency.  Its unit is this source built without FMA
// contraction (ops/cuda/build.py ``sdf_fd``): the normal divides field
// differences by 0.01, so it must round as its plain version does.
//
// The simple design: one thread per point, the tape inlined into straight-line
// code with its registers in registers, and the object banks (a few hundred
// bytes) copied once per block into shared memory, where every thread reads
// the same word (a broadcast).  Points stay AoS (x, y, z interleaved), the
// layout the callers hold; a warp's 32 points are 384 contiguous bytes.
// The grid kernel writes z-major (slab, ny, nx), x fastest across a warp, so
// its stores coalesce.
//
// A scene whose brushes read baked tables (Logo) passes them as ``ex``, one
// concatenation read through the read-only cache by csrc/table.cuh (K6);
// ``ex`` is null for every other scene.
//
// Needs the generated scene code (field_sdf, N_OBJ) and common.cuh above it.
#include <cuda_runtime.h>

constexpr int SDF_THREADS = 256;

__global__ void __launch_bounds__(SDF_THREADS)
point_eval_kernel(const float* __restrict__ pts, float* __restrict__ out, long long n,
                  const float* __restrict__ pos, const float* __restrict__ right,
                  const float* __restrict__ up, const float* __restrict__ fwd,
                  const float* __restrict__ ad, const float* __restrict__ ex) {
    SCENE_BANK(s_bank, lane_bank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = field_sdf(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], s_bank, ad, ex);
}

// K1 in its FD form: per point the SDF and its FD normal (six more
// evaluations at the offset points), one launch for what the plain path
// makes of seven point launches and the normal's glue (common.cuh
// sdf_fd_normal).  Persistent and grid-stride: the launcher starts as many
// blocks as fit on the card at once, so each block loads the bank once for
// many points; a thread's seven evaluations are independent of each other.
__global__ void __launch_bounds__(SDF_THREADS)
point_eval_fd_kernel(const float* __restrict__ pts, float* __restrict__ out,
                     float* __restrict__ normal, long long n, const float* __restrict__ pos,
                     const float* __restrict__ right, const float* __restrict__ up,
                     const float* __restrict__ fwd, const float* __restrict__ ad,
                     const float* __restrict__ ex) {
    SCENE_BANK(s_bank, lane_bank, pos, right, up, fwd);
    const auto field = [&](float x, float y, float z) { return field_sdf(x, y, z, s_bank, ad, ex); };
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        float nx, ny, nz;
        out[i] = sdf_fd_normal(field, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], nx, ny, nz);
        normal[3 * i] = nx;
        normal[3 * i + 1] = ny;
        normal[3 * i + 2] = nz;
    }
}

// SDF at lo + cell * (x, y, z0 + z) for the (nz, ny, nx) lattice, each
// coordinate rounded exactly as the plain version computes it
// (sdf_kernel.py:228-233 of the JAX package).
__global__ void __launch_bounds__(SDF_THREADS)
grid_eval_kernel(float* __restrict__ out, int nz, int ny, int nx, float lox, float loy,
                 float loz, float cell, float z0, const float* __restrict__ pos,
                 const float* __restrict__ right, const float* __restrict__ up,
                 const float* __restrict__ fwd, const float* __restrict__ ad,
                 const float* __restrict__ ex) {
    SCENE_BANK(s_bank, lane_bank, pos, right, up, fwd);
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
    out[i] = field_sdf(x, y, z, s_bank, ad, ex);
}

#if CULL_MODE
// The culled grid (sdf_kernel.py:205-248 of the JAX package).  A block owns a
// spatially compact tile of CULL_TX x CULL_TY x CULL_TZ lattice points (a
// thread per (x, y), a loop over z; interval.cuh), so one interval chain
// serves 2,048 points: the block's first thread runs it on the tile's box
// into shared memory.
__global__ void __launch_bounds__(CULL_TX * CULL_TY)
grid_eval_cull_kernel(float* __restrict__ out, int nz, int ny, int nx, float lox, float loy,
                      float loz, float cell, float z0, const float* __restrict__ pos,
                      const float* __restrict__ right, const float* __restrict__ up,
                      const float* __restrict__ fwd, const float* __restrict__ ad,
                      const float* __restrict__ ex) {
    SCENE_BANK(s_bank, lane_bank, pos, right, up, fwd);
    __shared__ Preds s_preds;
    __shared__ float s_substs[N_CULL_SLOTS];
    const int x0 = blockIdx.x * CULL_TX, y0 = blockIdx.y * CULL_TY, zb = blockIdx.z * CULL_TZ;
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        grid_tile_cull(x0, y0, zb, nz, ny, nx, lox, loy, loz, cell, z0, s_bank, ad, ex, s_preds,
                       s_substs);
    }
    __syncthreads();
    const int xi = x0 + threadIdx.x, yi = y0 + threadIdx.y;
    if (xi >= nx || yi >= ny) return;
    const Preds preds = s_preds;
    const float x = lattice(lox, cell, (float)xi), y = lattice(loy, cell, (float)yi);
    const int z_end = min(zb + CULL_TZ, nz);
    for (int zi = zb; zi < z_end; ++zi) {
        const float z = lattice(loz, cell, add_rn(z0, (float)zi));
        out[((long long)zi * ny + yi) * nx + xi] =
            field_sdf_culled(x, y, z, s_bank, ad, ex, preds, s_substs);
    }
}
#endif

static unsigned int blocks_for(long long n) {
    return (unsigned int)((n + SDF_THREADS - 1) / SDF_THREADS);
}

extern "C" int launch_point_eval(const void* pts, void* out, long long n, const void* pos,
                                 const void* right, const void* up, const void* fwd,
                                 const void* ad, const void* ex, void* stream) {
    if (n <= 0) return 0;
    if (const int rc = prepare_bank(pos, right, up, fwd, (cudaStream_t)stream)) return rc;
    point_eval_kernel<<<blocks_for(n), SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (float*)out, n, (const float*)pos, (const float*)right,
        (const float*)up, (const float*)fwd, (const float*)ad, (const float*)ex);
    return (int)cudaGetLastError();
}

// The FD kernel's grid: as many blocks as can be resident on the card at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on every SM), fewer
// for a small batch.  Computed once per process.
static int fd_resident_blocks(int* blocks) {
    static int resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        int rc = (int)cudaGetDevice(&dev);
        if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (rc == 0) {
            rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_eval_fd_kernel,
                                                                    SDF_THREADS, 0);
        }
        if (rc != 0) return rc;
        resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    *blocks = resident;
    return 0;
}

extern "C" int launch_point_eval_fd(const void* pts, void* out, void* normal, long long n,
                                    const void* pos, const void* right, const void* up,
                                    const void* fwd, const void* ad, const void* ex,
                                    void* stream) {
    if (n <= 0) return 0;
    int resident = 0;
    const int rc = fd_resident_blocks(&resident);
    if (rc != 0) return rc;
    const long long need = (long long)blocks_for(n);
    const unsigned int blocks = (unsigned int)(need < resident ? need : resident);
    if (const int rc = prepare_bank(pos, right, up, fwd, (cudaStream_t)stream)) return rc;
    point_eval_fd_kernel<<<blocks, SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (float*)out, (float*)normal, n, (const float*)pos,
        (const float*)right, (const float*)up, (const float*)fwd, (const float*)ad,
        (const float*)ex);
    return (int)cudaGetLastError();
}

extern "C" int launch_grid_eval(void* out, int nz, int ny, int nx, float lox, float loy,
                                float loz, float cell, float z0, const void* pos,
                                const void* right, const void* up, const void* fwd,
                                const void* ad, const void* ex, void* stream) {
    const long long n = (long long)nz * ny * nx;
    if (n <= 0) return 0;
    if (const int rc = prepare_bank(pos, right, up, fwd, (cudaStream_t)stream)) return rc;
    grid_eval_kernel<<<blocks_for(n), SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)out, nz, ny, nx, lox, loy, loz, cell, z0, (const float*)pos,
        (const float*)right, (const float*)up, (const float*)fwd, (const float*)ad,
        (const float*)ex);
    return (int)cudaGetLastError();
}

// Returns cudaErrorInvalidValue (1) for a scene whose tape cannot be culled
// (its wrapper launches grid_eval_kernel instead).
extern "C" int launch_grid_eval_cull(void* out, int nz, int ny, int nx, float lox, float loy,
                                     float loz, float cell, float z0, const void* pos,
                                     const void* right, const void* up, const void* fwd,
                                     const void* ad, const void* ex, void* stream) {
#if CULL_MODE
    if ((long long)nz * ny * nx <= 0) return 0;
    const dim3 block(CULL_TX, CULL_TY);
    const dim3 grid((nx + CULL_TX - 1) / CULL_TX, (ny + CULL_TY - 1) / CULL_TY,
                    (nz + CULL_TZ - 1) / CULL_TZ);
    if (const int rc = prepare_bank(pos, right, up, fwd, (cudaStream_t)stream)) return rc;
    grid_eval_cull_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, nz, ny, nx, lox, loy, loz, cell, z0, (const float*)pos, (const float*)right,
        (const float*)up, (const float*)fwd, (const float*)ad, (const float*)ex);
    return (int)cudaGetLastError();
#else
    return (int)cudaErrorInvalidValue;
#endif
}
