// Native mesh post-processing ops of the export (a copy of the JAX
// package's designcsg_tpu/native/meshops.cpp, kept apart so that the port
// imports nothing of that package).
//
// Counterpart of the reference's C++ mesh pipeline (cms/main/Headers/
// {mesh,utils}.hpp): the SDF math runs on the card (the CUDA kernels); what
// is host work -- sparse marching-cubes cell assembly, exact vertex welding,
// mesh file IO -- runs here instead of vectorized-but-allocating numpy.
// Exposed as a C ABI for ctypes; every entry point has a numpy fallback in
// Python (the tests compare the two).
//
// Build: g++ -O3 -shared -fPIC meshops.cpp -o libmeshops.so  (native/__init__.py
// builds it at first use into build/torch_native/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

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
