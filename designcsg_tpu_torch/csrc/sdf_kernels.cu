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
// The point kernel: one thread per point, the tape inlined into
// straight-line code with its registers in registers, and the object banks
// (a few hundred bytes) copied once per block into shared memory, where
// every thread reads the same word (a broadcast).  A bank that would pass
// the 48 KB of static shared memory a block may declare (with the culled
// grid's predicate and substitute buffers) is read from global memory
// instead, through the read-only cache (common.cuh BANK_GLOBAL,
// ops/cuda/tape.py bank_placement): a scene of more than about 1,000
// objects, which JAX's kernels take too.  Points stay AoS (x, y, z
// interleaved), the layout the callers hold; a warp's 32 points are 384
// contiguous bytes.
//
// The grid kernel issues fewer instructions a point than the point kernel
// for the same field (redesigned for Hopper).  At one thread a point it was
// at its issue limit: Design1's point code is ~560 instructions, and its
// 2.18M-point slab took about what 132 SMs need to issue them.  Two cuts:
//   - Columns.  A thread owns one (x, y) lattice column and walks a range
//     of z; a block of SDF_THREADS consecutive columns (x fastest, wrapping
//     to the next row) and a z range, so at each z the warp's 32 stores are
//     consecutive floats, as before, and a 257-wide lattice wastes no lanes
//     at its row ends as 32-wide tiles would.  One 32-bit division a column
//     splits its index; no 64-bit division is left.  The slab is cut into
//     as many z ranges as make one wave of the blocks resident on the card
//     (grid_eval_z_ranges, from the unit's occupancy), each range making
//     its columns' terms once: on the H100 Design1's unit (128 registers,
//     2 blocks an SM) takes path A's 33-plane slab in one range, Logo's
//     (40 registers) in three.
//   - The frame transform hoisted.  An object's local coordinate
//     (x - o0) * r0 + (y - o1) * r1 + (z - o2) * r2 has a z-invariant part;
//     the column form (ops/cuda/tape.py column_terms / field_sdf_column,
//     common.cuh frame_terms) makes it once per column and finishes it per
//     point with one subtraction and a multiply-add a row: 7 FP32
//     operations an object where the point form takes 18 (Design1: 11 of
//     its 18 on 10 objects).  Both forms call the same two functions with
//     every sum written out (common.cuh madd), so they give the same bits.
// The grid's output is z-major (slab, ny, nx).
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
                  const float* __restrict__ ad, const float* __restrict__ ex,
                  const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
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
                     const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
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
// (sdf_kernel.py:228-233 of the JAX package): thread per column
// (blockIdx.x), ``zper`` lattice planes per block (blockIdx.y).
__global__ void __launch_bounds__(SDF_THREADS, 2)
grid_eval_kernel(float* __restrict__ out, int nz, int ny, int nx, int zper, float lox,
                 float loy, float loz, float cell, float z0, const float* __restrict__ pos,
                 const float* __restrict__ right, const float* __restrict__ up,
                 const float* __restrict__ fwd, const float* __restrict__ ad,
                 const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
    const int plane = ny * nx;
    const int col = blockIdx.x * SDF_THREADS + threadIdx.x;
    if (col >= plane) return;
    const int yi = col / nx;
    const float x = lattice(lox, cell, (float)(col - yi * nx)), y = lattice(loy, cell, (float)yi);
    float h[N_COLUMN_TERMS];
    column_terms(x, y, s_bank, h);
    const int z_begin = blockIdx.y * zper;
    const int z_end = min(z_begin + zper, nz);
    float* dst = out + (long long)z_begin * plane + col;
    for (int zi = z_begin; zi < z_end; ++zi, dst += plane) {
        *dst = field_sdf_column(x, y, lattice(loz, cell, add_rn(z0, (float)zi)), h, s_bank, ad, ex);
    }
}

#if CULL_MODE
// The culled grid (sdf_kernel.py:205-248 of the JAX package).  A block owns a
// spatially compact tile of CULL_TX x CULL_TY x CULL_TZ lattice points (a
// thread per (x, y), a loop over z; interval.cuh), so one interval chain
// serves 2,048 points.  The block's first warp runs K7's lane chain on the
// tile's box (interval.cuh cull_tile_lanes, one slot a lane, as the dynamic
// cull of the renderer does) into shared memory, where that shortens the
// chain (GRID_CULL_LANES, ops/cuda/tape.py grid_cull_lanes); else its first
// thread runs the whole chain (``cull_tile``) while the block waits.  The z
// loop runs the column form of the culled field (the frame terms of the
// groups the tile evaluates, once per column of the tile), or where that
// lost to the point form, the point form (GRID_CULL_COLUMN,
// ops/cuda/tape.py grid_cull_column); both give the same bits.
__global__ void __launch_bounds__(CULL_TX * CULL_TY)
grid_eval_cull_kernel(float* __restrict__ out, int nz, int ny, int nx, float lox, float loy,
                      float loz, float cell, float z0, const float* __restrict__ pos,
                      const float* __restrict__ right, const float* __restrict__ up,
                      const float* __restrict__ fwd, const float* __restrict__ ad,
                      const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
    __shared__ Preds s_preds;
    __shared__ float s_substs[N_CULL_SLOTS];
    const int x0 = blockIdx.x * CULL_TX, y0 = blockIdx.y * CULL_TY, zb = blockIdx.z * CULL_TZ;
    if (threadIdx.y == 0) {
        Iv bx, by, bz;
        grid_tile_box(x0, y0, zb, nz, ny, nx, lox, loy, loz, cell, z0, bx, by, bz);
#if GRID_CULL_LANES
        Preds preds;
        float substs[N_CULL_SLOTS];
        cull_tile_lanes(bx, by, bz, lane_bank, ad, ex, preds, substs);
        if (threadIdx.x == 0) {
            s_preds = preds;
#pragma unroll
            for (int k = 0; k < N_CULL_SLOTS; ++k) s_substs[k] = substs[k];
        }
#else
        if (threadIdx.x == 0) cull_tile(bx, by, bz, s_bank, ad, ex, s_preds, s_substs);
#endif
    }
    __syncthreads();
    const int xi = x0 + threadIdx.x, yi = y0 + threadIdx.y;
    if (xi >= nx || yi >= ny) return;
    const Preds preds = s_preds;
    const float x = lattice(lox, cell, (float)xi), y = lattice(loy, cell, (float)yi);
#if GRID_CULL_COLUMN
    float h[N_COLUMN_TERMS];
    column_terms_culled(x, y, s_bank, preds, h);
#endif
    const int z_end = min(zb + CULL_TZ, nz);
    for (int zi = zb; zi < z_end; ++zi) {
        const float z = lattice(loz, cell, add_rn(z0, (float)zi));
        out[((long long)zi * ny + yi) * nx + xi] =
#if GRID_CULL_COLUMN
            field_sdf_culled_column(x, y, z, h, s_bank, ad, ex, preds, s_substs);
#else
            field_sdf_culled(x, y, z, s_bank, ad, ex, preds, s_substs);
#endif
    }
}
#endif

static unsigned int blocks_for(long long n) {
    return (unsigned int)((n + SDF_THREADS - 1) / SDF_THREADS);
}

extern "C" int launch_point_eval(const void* pts, void* out, long long n, SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if (n <= 0) return 0;
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    point_eval_kernel<<<blocks_for(n), SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (float*)out, n, SCENE_ARGS);
    return (int)cudaGetLastError();
}

// Blocks of SDF_THREADS threads of ``kernel`` resident on the current card
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on every SM),
// computed once per process and card into ``cache``.
constexpr int MAX_CARDS = 64;

template <class Kernel>
static int resident_blocks(Kernel kernel, int* cache, int* blocks) {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc != 0) return rc;
    if (dev >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
    if (cache[dev] == 0) {
        int sms = 0, per_sm = 0;
        rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SDF_THREADS, 0);
        if (rc != 0) return rc;
        cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    *blocks = cache[dev];
    return 0;
}

// The FD kernel's grid: as many blocks as can be resident on the card at
// once, fewer for a small batch.
static int fd_resident_blocks(int* blocks) {
    static int resident[MAX_CARDS] = {};
    return resident_blocks(point_eval_fd_kernel, resident, blocks);
}

extern "C" int launch_point_eval_fd(const void* pts, void* out, void* normal, long long n,
                                    SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if (n <= 0) return 0;
    int resident = 0;
    const int rc = fd_resident_blocks(&resident);
    if (rc != 0) return rc;
    const long long need = (long long)blocks_for(n);
    const unsigned int blocks = (unsigned int)(need < resident ? need : resident);
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    point_eval_fd_kernel<<<blocks, SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (float*)out, (float*)normal, n, SCENE_ARGS);
    return (int)cudaGetLastError();
}

// The unculled grid's z ranges for an (nz, ny, nx) slab on ``device``: as
// many as fill one wave of the blocks resident on the card (at least one,
// at most nz), each of ``*zper`` planes but the last.  Column indices are
// ints: a plane of at most 2^31 - 1 points.
extern "C" int grid_eval_z_ranges(int nz, int ny, int nx, int device, int* ranges, int* zper) {
    static int resident[MAX_CARDS] = {};
    if (const int rc = use_device(device)) return rc;
    if ((long long)ny * nx > 0x7fffffffLL || nz <= 0) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    if (const int rc = resident_blocks(grid_eval_kernel, resident, &blocks)) return rc;
    const int columns = (int)blocks_for((long long)ny * nx);
    const int fill = blocks / columns;
    const int want = fill < 1 ? 1 : (fill < nz ? fill : nz);
    *zper = (nz + want - 1) / want;
    *ranges = (nz + *zper - 1) / *zper;
    return 0;
}

extern "C" int launch_grid_eval(void* out, int nz, int ny, int nx, float lox, float loy,
                                float loz, float cell, float z0, SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if ((long long)nz * ny * nx <= 0) return 0;
    int ranges = 0, zper = 0;
    if (const int rc = grid_eval_z_ranges(nz, ny, nx, device, &ranges, &zper)) return rc;
    const dim3 grid(blocks_for((long long)ny * nx), ranges);
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    grid_eval_kernel<<<grid, SDF_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)out, nz, ny, nx, zper, lox, loy, loz, cell, z0, SCENE_ARGS);
    return (int)cudaGetLastError();
}

#if CULL_MODE
// Only in the culled grid's unit (ops/cuda/tape.py sdf_kernel_source with
// ``cull``), built for a scene whose tape can be culled.
extern "C" int launch_grid_eval_cull(void* out, int nz, int ny, int nx, float lox, float loy,
                                     float loz, float cell, float z0, SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if ((long long)nz * ny * nx <= 0) return 0;
    const dim3 block(CULL_TX, CULL_TY);
    const dim3 grid((nx + CULL_TX - 1) / CULL_TX, (ny + CULL_TY - 1) / CULL_TY,
                    (nz + CULL_TZ - 1) / CULL_TZ);
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    grid_eval_cull_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, nz, ny, nx, lox, loy, loz, cell, z0, SCENE_ARGS);
    return (int)cudaGetLastError();
}
#endif
