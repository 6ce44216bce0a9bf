// Fused k1 viewport renderer for one scene: exact or over-relaxed march (the
// generated constant OMEGA), from the camera or from a per-pixel start plane.
//
// Replaces the JAX package's Pallas kernel
//   ops/pallas/march_kernel.py:make_pallas_renderer (exact and over-relaxed
//   march, optional t0 input; no cull).
//
// What bounds it on Hopper: FP32 issue.  Each pixel runs tens to hundreds of
// march steps, each a full evaluation of the tape plus the gizmo, then six more
// for its normal and one per object to attribute its material, and writes
// only 12 B (RGB) at the end.  Rays diverge: a warp runs as long as its
// slowest ray.
//
// The simple design: one thread per pixel with its own march loop (per-ray
// early exit, which is what the TPU kernel's masked per-tile loop computes:
// masked steps change nothing), blocks of 16x8 pixels so a warp holds a 16x2
// patch of neighbouring rays that tend to finish together, the object banks in
// shared memory, the camera as a kernel parameter, and RGB written
// interleaved as the (H, W, 3) image.  The TPU kernel's 32x32 tile-major
// layout and K-step unroll are Mosaic mechanisms and are not reproduced.
// The optional t0 plane (f32[H, W], the cone prepass's handoff) is one more
// read per pixel; a null pointer starts every ray at the camera.
// This unit is built with -fmad=false (ops/cuda/build.py): every product and
// sum rounds as in the plain version, so a ray stops at the same step; with
// FMA contraction, single pixels at creases shaded up to 1.2e-3 apart.
//
// Needs the generated scene code, common.cuh and march.cuh above it.
#include <cuda_runtime.h>

constexpr int RENDER_BX = 16;
constexpr int RENDER_BY = 8;

__global__ void __launch_bounds__(RENDER_BX * RENDER_BY)
render_kernel(float* __restrict__ out, int height, int width, Cam cam,
              const float* __restrict__ pos, const float* __restrict__ right,
              const float* __restrict__ up, const float* __restrict__ fwd,
              const float* __restrict__ ad, const float* __restrict__ t0) {
    __shared__ float s_bank[N_OBJ * BANK_STRIDE];
    load_bank(s_bank, pos, right, up, fwd);
    const int ix = blockIdx.x * RENDER_BX + threadIdx.x;
    const int iy = blockIdx.y * RENDER_BY + threadIdx.y;
    if (ix >= width || iy >= height) return;
    const long long pixel = (long long)iy * width + ix;
    const Rgb c = render_pixel(ix, iy, width, height, cam, s_bank, ad, t0 ? t0[pixel] : 0.0f);
    float* px = out + 3 * pixel;
    px[0] = c.r;
    px[1] = c.g;
    px[2] = c.b;
}

extern "C" int launch_render(void* out, int height, int width, const float* cam_host,
                             const void* pos, const void* right, const void* up,
                             const void* fwd, const void* ad, const void* t0, void* stream) {
    if (height <= 0 || width <= 0) return 0;
    Cam cam;
    for (int k = 0; k < 3; ++k) {
        cam.o[k] = cam_host[k];
        cam.rgt[k] = cam_host[3 + k];
        cam.upp[k] = cam_host[6 + k];
        cam.fwd[k] = cam_host[9 + k];
    }
    const dim3 block(RENDER_BX, RENDER_BY);
    const dim3 grid((width + RENDER_BX - 1) / RENDER_BX, (height + RENDER_BY - 1) / RENDER_BY);
    render_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)out, height, width, cam, (const float*)pos, (const float*)right,
        (const float*)up, (const float*)fwd, (const float*)ad, (const float*)t0);
    return (int)cudaGetLastError();
}
