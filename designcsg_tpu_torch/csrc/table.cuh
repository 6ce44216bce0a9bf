// K6: sampling of a baked 2D field, inlined into every kernel whose scene has
// a brush that reads one (Logo's letters).
//
// Replaces the JAX package's in-kernel sampler
//   ops/pallas/table.py:packed_rank_sample,
// which its Pallas kernels (point, grid, renderer, cone, ray march) call
// through Logo's brush twins.  Plain version: ops/table.py plane_sample.
//
// The JAX package stores each letter as a rank-32 factorization,
//   b(gx, gy) = sum_k (UA_k[c0] + fx*US_k[c0]) * (VA_k[r0] + fy*VS_k[r0]),
// because Mosaic can gather only within one vreg, so a dense 2D table is out
// on the TPU (ops/pallas/table.py:1-30 there).  On Hopper a dense 2D gather
// is one load, so the port samples the same function in its expanded form:
// four f32[128, 128] planes AA = UA'VA, AS = UA'VS, SA = US'VA, SS = US'VS
// (designs/logo.py letter_planes, summed in float64 and rounded once), stored
// interleaved as f32[128][128][4], rows r0 (y) then columns c0 (x), and
//   b = (AA + fy*AS) + fx*(SA + fy*SS)
// at [r0][c0], the grid coordinates clipped to [0, 126.999] with
// c0 = floor(gx), fx = gx - c0 (and r0, fy) as the rank form clips them.
//
// What bounds it on Hopper: per letter evaluation one 16-byte read and 14
// FP32 operations (clip, floor, fractions, then 3 products and 3 sums),
// against the rank form's 128 four-byte reads and ~200 operations.  The
// planes of a letter take 256 KB (768 KB for Logo), more than a block's
// shared memory, so the design reads them through the read-only data cache
// (__ldg of a float4) and leaves them in L2 and L1; rays or points that
// step along a letter's x read neighbouring 16-byte cells of one row.  What
// is left is the latency of one dependent load per letter, which the
// kernels' other warps hide.
//
// Every product and sum is rounded on its own (mul_rn/add_rn: no FMA
// contraction, also in the point and grid units, which build with it), so
// the card and the host build give the plain version's bits.
//
// Needs common.cuh above it.

constexpr int TABLE_W = 128;

HD float plane_sample(const float* planes, float gx, float gy) {
    gx = fminf(fmaxf(gx, 0.0f), 126.999f);
    gy = fminf(fmaxf(gy, 0.0f), 126.999f);
    const float x0 = floorf(gx), y0 = floorf(gy);
    const float fx = gx - x0, fy = gy - y0;
    const float* cell = planes + 4 * ((int)y0 * TABLE_W + (int)x0);
#ifdef __CUDA_ARCH__
    const float4 v = __ldg(reinterpret_cast<const float4*>(cell));
    const float aa = v.x, as = v.y, sa = v.z, ss = v.w;
#else
    const float aa = cell[0], as = cell[1], sa = cell[2], ss = cell[3];
#endif
    return add_rn(add_rn(aa, mul_rn(fy, as)), mul_rn(fx, add_rn(sa, mul_rn(fy, ss))));
}
