// Native mesh post-processing ops of the export (a copy of the JAX
// package's designcsg_tpu/native/meshops.cpp, kept apart so that the port
// imports nothing of that package; stitch_loops is the port's own).
//
// Counterpart of the reference's C++ mesh pipeline (cms/main/Headers/
// {mesh,utils}.hpp): the SDF math runs on the card (the CUDA kernels); what
// is host work -- sparse marching-cubes cell assembly, exact vertex welding,
// the crack loops' caps, mesh file IO -- runs here instead of
// vectorized-but-allocating numpy.
// Exposed as a C ABI for ctypes; every entry point has a numpy fallback in
// Python (the tests compare the two).
//
// Build: g++ -O3 -shared -fPIC meshops.cpp -o libmeshops.so  (native/__init__.py
// builds it at first use into build/torch_native/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// The minimal-area triangulation of one loop of m >= 3 vertex ids (the cap
// of export/retopo.py _cap_block), written as m - 2 triangles to out.  For
// each span j - i the best split k, the first of equal costs, costs the
// triangle (p_i, p_k, p_j) by half the norm of (p_k - p_i) x (p_j - p_i),
// in float64 and in numpy's order of operations; the triangles come out in
// the recursion's order: the split's triangle, the part below, the part
// above.  Contraction into FMAs is off here: it would change the areas'
// last bits, and with them the ties.
__attribute__((optimize("fp-contract=off")))
void cap_loop(const long long* ids, long long m, const double* verts,
              std::vector<double>& p, std::vector<double>& cost,
              std::vector<long long>& split, std::vector<long long>& stack, long long* out)
{
    p.resize((size_t)(m * 3));
    cost.assign((size_t)(m * m), 0.0);
    split.resize((size_t)(m * m));
    for (long long a = 0; a < m; a++)
        for (int d = 0; d < 3; d++) p[a * 3 + d] = verts[ids[a] * 3 + d];
    for (long long span = 2; span < m; span++) {
        for (long long i = 0; i + span < m; i++) {
            const long long j = i + span;
            const double* pi = &p[i * 3];
            const double* pj = &p[j * 3];
            const double bx = pj[0] - pi[0], by = pj[1] - pi[1], bz = pj[2] - pi[2];
            double best = 0.0;
            long long arg = -1;
            for (long long k = i + 1; k < j; k++) {
                const double* pk = &p[k * 3];
                const double ax = pk[0] - pi[0], ay = pk[1] - pi[1], az = pk[2] - pi[2];
                const double cx = ay * bz - az * by;
                const double cy = az * bx - ax * bz;
                const double cz = ax * by - ay * bx;
                const double area = 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
                const double c = (cost[i * m + k] + cost[k * m + j]) + area;
                // np.argmin: the first minimum, or the first NaN.
                if (arg < 0 || c < best || (std::isnan(c) && !std::isnan(best))) {
                    best = c;
                    arg = k;
                }
            }
            cost[i * m + j] = best;
            split[i * m + j] = arg;
        }
    }
    // The recursion from (0, m - 1) on a stack of (i, j): pop (i, j), emit
    // its triangle, push (k, j), then (i, k) on top of it.
    stack.resize((size_t)(2 * m));
    long long top = 0;
    stack[0] = 0;
    stack[1] = m - 1;
    for (long long n = 0; n < m - 2; n++) {
        const long long i = stack[top * 2], j = stack[top * 2 + 1];
        const long long k = split[i * m + j];
        out[n * 3 + 0] = ids[i];
        out[n * 3 + 1] = ids[k];
        out[n * 3 + 2] = ids[j];
        top--;
        if (j - k >= 2) {
            top++;
            stack[top * 2] = k;
            stack[top * 2 + 1] = j;
        }
        if (k - i >= 2) {
            top++;
            stack[top * 2] = i;
            stack[top * 2 + 1] = k;
        }
    }
}

}  // namespace

extern "C" {

// Extract triangles from one z-slab of corner samples.
//
// corners: f32[(sz+1) * r1 * r1] (z-major, then y, then x); a cell (x,y,z)
// has corner c at offset (z + cz, y + cy, x + cx) with c = cx + 2*cy + 4*cz.
// Table arrays come from Python's generated triangle_table() so the two
// implementations can never drift.
//
// Outputs per triangle: 3 global-edge keys (weldable vertex ids) and 3
// vertex positions in grid units.  Returns the number of triangles written,
// or -1 if capacity was insufficient (caller retries with a larger buffer).
long long mc_slab(const float* corners,
                  long long sz,     // cells in z within this slab
                  long long r1,     // corner count per axis (res + 1)
                  long long z0,     // global z index of the slab's first cell
                  int midpoint,     // 1 = edge midpoints (reference parity)
                  const long long* tri_edges,  // [256 * maxt * 3]
                  const long long* n_tris,     // [256]
                  long long maxt,
                  const long long* edge_axis,    // [12]
                  const long long* edge_origin,  // [12 * 3] lower-corner offset
                  const long long* edge_c0,      // [12] lower corner index
                  const long long* edge_c1,      // [12] upper corner index
                  const long long* corner_off,   // [8 * 3] (x, y, z) per corner
                  long long capacity,
                  long long* out_keys,  // [capacity * 3]
                  float* out_pos)       // [capacity * 9]
{
    const long long res = r1 - 1;
    const long long plane = r1 * r1;
    long long count = 0;
    for (long long z = 0; z < sz; z++) {
        for (long long y = 0; y < res; y++) {
            const float* row0 = corners + z * plane + y * r1;
            for (long long x = 0; x < res; x++) {
                int config = 0;
                for (int c = 0; c < 8; c++) {
                    const long long cx = corner_off[c * 3 + 0];
                    const long long cy = corner_off[c * 3 + 1];
                    const long long cz = corner_off[c * 3 + 2];
                    const float v = corners[(z + cz) * plane + (y + cy) * r1 + (x + cx)];
                    if (v < 0.0f) config |= (1 << c);
                }
                (void)row0;
                if (config == 0 || config == 255) continue;
                const long long nt = n_tris[config];
                for (long long t = 0; t < nt; t++) {
                    if (count >= capacity) return -1;
                    for (int k = 0; k < 3; k++) {
                        const long long e =
                            tri_edges[(config * maxt + t) * 3 + k];
                        const long long ax = edge_axis[e];
                        const long long gx = x + edge_origin[e * 3 + 0];
                        const long long gy = y + edge_origin[e * 3 + 1];
                        const long long gz = z0 + z + edge_origin[e * 3 + 2];
                        out_keys[count * 3 + k] =
                            ((ax * r1 + gz) * r1 + gy) * r1 + gx;
                        float tt = 0.5f;
                        if (!midpoint) {
                            const long long c0 = edge_c0[e];
                            const long long c1 = edge_c1[e];
                            const float v0 = corners[(z + corner_off[c0 * 3 + 2]) * plane +
                                                     (y + corner_off[c0 * 3 + 1]) * r1 +
                                                     (x + corner_off[c0 * 3 + 0])];
                            const float v1 = corners[(z + corner_off[c1 * 3 + 2]) * plane +
                                                     (y + corner_off[c1 * 3 + 1]) * r1 +
                                                     (x + corner_off[c1 * 3 + 0])];
                            const float denom = v0 - v1;
                            if (denom > 1e-12f || denom < -1e-12f) tt = v0 / denom;
                            if (tt < 0.0f) tt = 0.0f;
                            if (tt > 1.0f) tt = 1.0f;
                        }
                        float px = (float)gx, py = (float)gy, pz = (float)gz;
                        if (ax == 0) px += tt;
                        else if (ax == 1) py += tt;
                        else pz += tt;
                        out_pos[count * 9 + k * 3 + 0] = px;
                        out_pos[count * 9 + k * 3 + 1] = py;
                        out_pos[count * 9 + k * 3 + 2] = pz;
                    }
                    count++;
                }
            }
        }
    }
    return count;
}

// Extract triangles from K gathered corner blocks (the active-block path:
// the device computes which blocks contain the surface and ships only those —
// the two-level analog of the reference's octree descent, mesh.hpp:214-267).
//
// corners: f32[K * (nz+1) * (ny+1) * (nx+1)], block-major, z/y/x within a
// block.  coords: i64[K * 3] = global (x0, y0, z0) cell origin per block.
// Keys are global edge ids against the full (r1 = res+1) corner grid, so
// blocks weld seamlessly with each other and with mc_slab output.
long long mc_blocks(const float* corners,
                    const long long* coords,  // [K * 3] (x0, y0, z0)
                    long long K,
                    long long nz, long long ny, long long nx,  // cells/block
                    long long r1,     // global corner count per axis
                    int midpoint,
                    const long long* tri_edges,  // [256 * maxt * 3]
                    const long long* n_tris,     // [256]
                    long long maxt,
                    const long long* edge_axis,    // [12]
                    const long long* edge_origin,  // [12 * 3]
                    const long long* edge_c0,      // [12]
                    const long long* edge_c1,      // [12]
                    const long long* corner_off,   // [8 * 3] (x, y, z)
                    long long capacity,
                    long long* out_keys,  // [capacity * 3]
                    float* out_pos)       // [capacity * 9]
{
    const long long rowlen = nx + 1;
    const long long plane = (ny + 1) * rowlen;
    const long long blocklen = (nz + 1) * plane;
    long long count = 0;
    for (long long b = 0; b < K; b++) {
        const float* blk = corners + b * blocklen;
        const long long x0 = coords[b * 3 + 0];
        const long long y0 = coords[b * 3 + 1];
        const long long z0 = coords[b * 3 + 2];
        for (long long z = 0; z < nz; z++) {
            for (long long y = 0; y < ny; y++) {
                for (long long x = 0; x < nx; x++) {
                    int config = 0;
                    for (int c = 0; c < 8; c++) {
                        const long long cx = corner_off[c * 3 + 0];
                        const long long cy = corner_off[c * 3 + 1];
                        const long long cz = corner_off[c * 3 + 2];
                        const float v =
                            blk[(z + cz) * plane + (y + cy) * rowlen + (x + cx)];
                        if (v < 0.0f) config |= (1 << c);
                    }
                    if (config == 0 || config == 255) continue;
                    const long long nt = n_tris[config];
                    for (long long t = 0; t < nt; t++) {
                        if (count >= capacity) return -1;
                        for (int k = 0; k < 3; k++) {
                            const long long e =
                                tri_edges[(config * maxt + t) * 3 + k];
                            const long long ax = edge_axis[e];
                            const long long gx = x0 + x + edge_origin[e * 3 + 0];
                            const long long gy = y0 + y + edge_origin[e * 3 + 1];
                            const long long gz = z0 + z + edge_origin[e * 3 + 2];
                            out_keys[count * 3 + k] =
                                ((ax * r1 + gz) * r1 + gy) * r1 + gx;
                            float tt = 0.5f;
                            if (!midpoint) {
                                const long long c0 = edge_c0[e];
                                const long long c1 = edge_c1[e];
                                const float v0 =
                                    blk[(z + corner_off[c0 * 3 + 2]) * plane +
                                        (y + corner_off[c0 * 3 + 1]) * rowlen +
                                        (x + corner_off[c0 * 3 + 0])];
                                const float v1 =
                                    blk[(z + corner_off[c1 * 3 + 2]) * plane +
                                        (y + corner_off[c1 * 3 + 1]) * rowlen +
                                        (x + corner_off[c1 * 3 + 0])];
                                const float denom = v0 - v1;
                                if (denom > 1e-12f || denom < -1e-12f)
                                    tt = v0 / denom;
                                if (tt < 0.0f) tt = 0.0f;
                                if (tt > 1.0f) tt = 1.0f;
                            }
                            float px = (float)gx, py = (float)gy, pz = (float)gz;
                            if (ax == 0) px += tt;
                            else if (ax == 1) py += tt;
                            else pz += tt;
                            out_pos[count * 9 + k * 3 + 0] = px;
                            out_pos[count * 9 + k * 3 + 1] = py;
                            out_pos[count * 9 + k * 3 + 2] = pz;
                        }
                        count++;
                    }
                }
            }
        }
    }
    return count;
}

// Expand compacted (cell index, config) pairs into per-triangle global edge
// keys — the host half of the on-device-compaction extraction path
// (export/compact.py).  Returns the number of triangles written, or -1 if
// capacity was insufficient.
long long cells_to_tri_keys(const long long* cells_idx,  // [N] (z*res+y)*res+x
                            const unsigned char* cells_cfg,  // [N]
                            long long N,
                            long long res,
                            const long long* tri_edges,  // [256 * maxt * 3]
                            const long long* n_tris,     // [256]
                            long long maxt,
                            const long long* edge_axis,    // [12]
                            const long long* edge_origin,  // [12 * 3]
                            long long capacity,
                            long long* out_keys)  // [capacity * 3]
{
    const long long r1 = res + 1;
    long long count = 0;
    for (long long i = 0; i < N; i++) {
        const long long idx = cells_idx[i];
        const long long cz = idx / (res * res);
        const long long cy = (idx / res) % res;
        const long long cx = idx % res;
        const int config = cells_cfg[i];
        const long long nt = n_tris[config];
        for (long long t = 0; t < nt; t++) {
            if (count >= capacity) return -1;
            for (int k = 0; k < 3; k++) {
                const long long e = tri_edges[(config * maxt + t) * 3 + k];
                const long long ax = edge_axis[e];
                const long long gx = cx + edge_origin[e * 3 + 0];
                const long long gy = cy + edge_origin[e * 3 + 1];
                const long long gz = cz + edge_origin[e * 3 + 2];
                out_keys[count * 3 + k] = ((ax * r1 + gz) * r1 + gy) * r1 + gx;
            }
            count++;
        }
    }
    return count;
}

// Weld vertices by exact key: fills inverse[i] (vertex id per input key) and
// first_idx[v] (input index of vertex v's first occurrence); returns the
// number of unique vertices.
long long weld(const long long* keys, long long n, long long* inverse,
               long long* first_idx)
{
    std::unordered_map<long long, long long> map;
    map.reserve((size_t)(n / 4 + 16));
    long long next = 0;
    for (long long i = 0; i < n; i++) {
        auto it = map.find(keys[i]);
        if (it == map.end()) {
            map.emplace(keys[i], next);
            first_idx[next] = i;
            inverse[i] = next;
            next++;
        } else {
            inverse[i] = it->second;
        }
    }
    return next;
}

// Close a mesh's crack loops (export/retopo.py stitch_boundary_loops, which
// is the numpy twin of this pass, face for face).
//
// Boundary edges are the directed edges (a, b) of the faces -- every face's
// (0,1) edge, then every (1,2), then every (2,0) -- whose undirected edge
// occurs once; each is counted in a bucket of its smaller end.  The walk
// starts at each unused boundary edge in order and follows, at each vertex,
// its first unused outgoing edge (edges in index order, a head per vertex
// past the used ones) until it returns to its start; it abandons a loop
// that grows past max_loop vertices (counted open) or reaches a vertex with
// nothing left to follow.  A loop of 3 or more vertices not all on the
// domain box (has_domain: |v - lo| < eps or |v - hi| < eps on an axis) is
// reversed and capped by cap_loop, caps in loop order, those with a
// repeated vertex dropped.
//
// faces: i64[F * 3]; verts: f64[nv * 3]; out_caps: i64[3 * F * 3] (a loop
// of m edges gives m - 2 triangles); out_counts: boundary edges, open
// loops, closed loops, and the faces given with a repeated vertex.  Returns
// the cap triangles written, or -1 if a face names a vertex outside [0, nv).
long long stitch_loops(const long long* faces, long long F, const double* verts, long long nv,
                       int has_domain, const double* lo, const double* hi, double eps,
                       long long max_loop, long long* out_caps, long long* out_counts)
{
    const long long E = 3 * F;
    long long degenerate = 0;
    for (long long f = 0; f < F; f++) {
        const long long* t = faces + f * 3;
        for (int q = 0; q < 3; q++)
            if (t[q] < 0 || t[q] >= nv) return -1;
        degenerate += t[0] == t[1] || t[1] == t[2] || t[0] == t[2];
    }

    // Directed edge e = q * F + f runs from corner q of face f to corner
    // q + 1 (mod 3).  Each is counted in the bucket of its smaller end,
    // beside its larger end; buckets fill in edge order.
    std::vector<long long> off((size_t)(nv + 1), 0);
    for (long long q = 0; q < 3; q++)
        for (long long f = 0; f < F; f++) {
            const long long a = faces[f * 3 + q], b = faces[f * 3 + (q + 1) % 3];
            off[std::min(a, b) + 1]++;
        }
    for (long long v = 0; v < nv; v++) off[v + 1] += off[v];
    std::vector<long long> bucket_edge((size_t)E), bucket_end((size_t)E);
    {
        std::vector<long long> fill(off.begin(), off.end() - 1);
        for (long long q = 0; q < 3; q++)
            for (long long f = 0; f < F; f++) {
                const long long a = faces[f * 3 + q], b = faces[f * 3 + (q + 1) % 3];
                const long long s = fill[std::min(a, b)]++;
                bucket_edge[s] = q * F + f;
                bucket_end[s] = std::max(a, b);
            }
    }
    std::vector<unsigned char> once((size_t)E, 0);
    {
        std::vector<long long> stamp((size_t)nv, -1), count((size_t)nv, 0);
        for (long long u = 0; u < nv; u++) {
            for (long long s = off[u]; s < off[u + 1]; s++) {
                const long long v = bucket_end[s];
                if (stamp[v] != u) {
                    stamp[v] = u;
                    count[v] = 0;
                }
                count[v]++;
            }
            for (long long s = off[u]; s < off[u + 1]; s++)
                once[bucket_edge[s]] = count[bucket_end[s]] == 1;
        }
    }
    std::vector<long long> src, dst;
    for (long long q = 0; q < 3; q++)
        for (long long f = 0; f < F; f++) {
            if (!once[q * F + f]) continue;
            src.push_back(faces[f * 3 + q]);
            dst.push_back(faces[f * 3 + (q + 1) % 3]);
        }
    const long long nb = (long long)src.size();

    // The boundary edges leaving each vertex, in index order: by_start
    // positions head[v] .. tail[v] - 1; head moves past used ones.
    std::vector<long long> head((size_t)(nv + 1), 0);
    for (long long e = 0; e < nb; e++) head[src[e] + 1]++;
    for (long long v = 0; v < nv; v++) head[v + 1] += head[v];
    std::vector<long long> tail(head.begin() + 1, head.end());
    std::vector<long long> by_start((size_t)nb);
    {
        std::vector<long long> fill(head.begin(), head.end() - 1);
        for (long long e = 0; e < nb; e++) by_start[fill[src[e]]++] = e;
    }
    std::vector<unsigned char> used((size_t)nb, 0);
    std::vector<long long> loop, ids;
    std::vector<double> p, cost;
    std::vector<long long> split, stack, tris;
    long long n_caps = 0, open_loops = 0, closed_loops = 0;
    for (long long start = 0; start < nb; start++) {
        if (used[start]) continue;
        loop.assign(1, src[start]);
        used[start] = 1;
        long long cur = dst[start];
        bool ok = true;
        while (cur != loop[0]) {
            loop.push_back(cur);
            long long h = head[cur];
            while (h < tail[cur] && used[by_start[h]]) h++;
            head[cur] = h;
            if (h == tail[cur] || (long long)loop.size() > max_loop) {
                ok = false;
                break;
            }
            const long long next = by_start[h];
            used[next] = 1;
            cur = dst[next];
        }
        const long long m = (long long)loop.size();
        if (!ok || m < 3) {
            if (m > max_loop) open_loops++;
            continue;
        }
        if (has_domain) {
            bool all_on = true;
            for (long long a = 0; a < m && all_on; a++) {
                bool on = false;
                for (int d = 0; d < 3; d++) {
                    const double x = verts[loop[a] * 3 + d];
                    on = on || std::fabs(x - lo[d]) < eps || std::fabs(x - hi[d]) < eps;
                }
                all_on = on;
            }
            if (all_on) continue;  // clip boundary, not a crack
        }
        // Capped with winding opposite the traversal: boundary edges run as
        // their faces wind them, so the cap runs reversed.
        ids.assign(loop.rbegin(), loop.rend());
        tris.resize((size_t)((m - 2) * 3));
        cap_loop(ids.data(), m, verts, p, cost, split, stack, tris.data());
        for (long long t = 0; t < m - 2; t++) {
            const long long* c = &tris[t * 3];
            if (c[0] == c[1] || c[1] == c[2] || c[0] == c[2]) continue;
            std::memcpy(out_caps + n_caps * 3, c, 3 * sizeof(long long));
            n_caps++;
        }
        closed_loops++;
    }
    out_counts[0] = nb;
    out_counts[1] = open_loops;
    out_counts[2] = closed_loops;
    out_counts[3] = degenerate;
    return n_caps;
}

// Binary STL with the reference's conventions: zero normals, vertices
// written (x, z, y) (cms utils.hpp:63-76).  tris: f32[n * 9].
long long write_stl_soup(const char* path, const float* tris, long long n)
{
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    unsigned char header[80] = {0};
    fwrite(header, 1, 80, f);
    uint32_t n32 = (uint32_t)n;
    fwrite(&n32, 4, 1, f);
    std::vector<unsigned char> rec(50 * 4096);
    long long i = 0;
    while (i < n) {
        long long batch = n - i < 4096 ? n - i : 4096;
        memset(rec.data(), 0, (size_t)(50 * batch));
        for (long long j = 0; j < batch; j++) {
            float* out = (float*)(rec.data() + j * 50);
            const float* tri = tris + (i + j) * 9;
            // out[0..2] = zero normal
            for (int v = 0; v < 3; v++) {
                out[3 + v * 3 + 0] = tri[v * 3 + 0];
                out[3 + v * 3 + 1] = tri[v * 3 + 2];
                out[3 + v * 3 + 2] = tri[v * 3 + 1];
            }
        }
        fwrite(rec.data(), 1, (size_t)(50 * batch), f);
        i += batch;
    }
    fclose(f);
    return n;
}

}  // extern "C"
