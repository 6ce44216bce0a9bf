// K6: sampling of a baked rank-factored 2D field, inlined into every kernel
// whose scene has a brush that reads one (Logo's letters).
//
// Replaces the JAX package's in-kernel sampler
//   ops/pallas/table.py:packed_rank_sample,
// which its Pallas kernels (point, grid, renderer, cone, ray march) call
// through Logo's brush twins.  Plain version: ops/table.py.
//
// The field is b(gx, gy) = sum_k (UA_k[c0] + fx*US_k[c0]) * (VA_k[r0] + fy*VS_k[r0])
// over a f32[4*RANK_K, 128] table (blocks UA, US, VA, VS), at grid coordinates
// clipped to [0, 126.999], with c0 = floor(gx), fx = gx - c0 (and r0, fy).
// The terms are summed from 0 in k order, as the plain version sums them.
//
// What bounds it on Hopper: per evaluation 4*RANK_K = 128 four-byte reads at
// two columns of the table (c0 for the x blocks, r0 for the y blocks), each a
// stride-512 B walk down the rows, and ~200 FP32 operations.  Neighbouring
// rays read neighbouring columns, so a warp's reads of one row fall in a few
// 32 B sectors; the table (64 KB a letter, 192 KB for Logo's three) stays in
// L2 and, read-only, in the SM's L1/texture cache.
//
// The simple design: the table stays in global memory and is read through
// the read-only data cache (__ldg under nvcc, plain loads on the host).
// Three letters' tables are too large for shared memory beside a kernel's
// bank at useful occupancy; staging them (per letter, or in bf16) is later
// work.
//
// Needs common.cuh above it.

constexpr int RANK_K = 32;
constexpr int TABLE_W = 128;

HD float table_load(const float* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

HD float rank_sample(const float* tbl, float gx, float gy) {
    gx = fminf(fmaxf(gx, 0.0f), 126.999f);
    gy = fminf(fmaxf(gy, 0.0f), 126.999f);
    const float x0 = floorf(gx), y0 = floorf(gy);
    const float fx = gx - x0, fy = gy - y0;
    const float* ua = tbl + (int)x0;
    const float* us = ua + RANK_K * TABLE_W;
    const float* va = tbl + 2 * RANK_K * TABLE_W + (int)y0;
    const float* vs = va + RANK_K * TABLE_W;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < RANK_K; ++k) {
        const float uk = table_load(ua + k * TABLE_W) + fx * table_load(us + k * TABLE_W);
        const float vk = table_load(va + k * TABLE_W) + fy * table_load(vs + k * TABLE_W);
        acc = acc + uk * vk;
    }
    return acc;
}
