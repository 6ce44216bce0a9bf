// Cone prepass of the hierarchical viewport, for one scene.
//
// Replaces the JAX package's Pallas kernel
//   ops/pallas/march_kernel.py:make_pallas_cone_march.
//
// Each coarse ray (through the centre pixel of an FxF block) marches with the
// cone-inflated stop test s < EPS + d*CONE_SLOPE (march.cuh cone_ray and
// cone_advance) and writes t_safe, from which every fine ray of its block
// starts (march_kernel.cu with a t0 plane).
//
// What bounds it on Hopper: not throughput but the latency of one ray's
// steps.  At 640x480 and F = 5 there are only 96x128 = 12,288 rays, tens of
// tape evaluations each: with one thread a ray that is 96 blocks of 128
// threads for 132 SMs, one warp a scheduler, and each step waits on one
// thread's straight-line tape (about 2,500 cycles on Design1) with nothing
// to hide it, while the launch's whole issue fits in under 10 us.
//
// The design (CONE_WARPS = S > 0, redesigned for Hopper): a block of S
// warps serves 32 rays, one a lane.  The tape's slots (its imports and the
// gizmo) are dealt among the S warps by their operation counts
// (ops/cuda/tape.py cone_deal); warp j evaluates its slots for all 32 rays,
// so every lane of a warp runs the same brush code, and writes them to
// shared memory; after one barrier every warp runs the tape's MIN/MAX/NEGATE
// rows on the shared values (cone_tape: a few dozen operations) and steps
// its copy of the 32 rays.  Each warp gets the same s and takes the same
// stop test, so the S warps leave the loop together, and t_safe is that of
// cone_ray bit for bit (the same brush_<k>_at, the same rows).  The values
// alternate between two buffers by step, so one barrier a step suffices: a
// warp writes step n + 1's values only after every warp has passed step n's
// barrier, and reads step n's values before reaching step n + 1's.  12,288
// rays make 384 blocks of S warps.  S comes from tape.cone_warps: 4 on
// every shipped design, by the A/B.  0 keeps one thread a ray with its own
// loop (per-ray early exit): the form for a scene whose bank and slot
// buffers (256 B a slot) would pass the 48 KB of static shared memory, from
// about 160 imports.  Its bank (48 B an object) stays in shared memory up
// to 1,024 objects and lies in global memory above (common.cuh
// BANK_GLOBAL; ops/cuda/tape.py bank_placement).
//
// Rays are an AoS input f32[N, 3] formed by the caller exactly as its plain
// version forms them, the projected camera origin ``o`` f32[3] is read on the
// card (no host copy), the object bank sits in shared memory (in global
// memory for a scene of more than 1,024 objects), and the slope,
// CONE_STRICT, EPS, TOL, MAX_D and MAX_STEPS are constants; the scene's baked
// tables (if any) are ``ex``.  Built with -fmad=false, as the renderer
// (ops/cuda/build.py): one rounding decides where a march stops.
//
// Needs the generated scene code, common.cuh, march.cuh and the generated
// split (cone_slots, cone_tape) above it.
#include <cuda_runtime.h>

#if CONE_WARPS
__global__ void __launch_bounds__(32 * CONE_WARPS)
cone_march_kernel(float* __restrict__ t_safe, long long n, const float* __restrict__ rays,
                  const float* __restrict__ o, const float* __restrict__ pos,
                  const float* __restrict__ right, const float* __restrict__ up,
                  const float* __restrict__ fwd, const float* __restrict__ ad,
                  const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
    static_assert(4 * ((BANK_CONSTANT || BANK_GLOBAL ? 0 : N_OBJ * BANK_STRIDE) +
                       2 * 32 * N_CONE_SLOTS) <= 48 * 1024,
                  "the split cone's shared memory passes 48 KB (tape.cone_warps keeps it under)");
    __shared__ float s_slots[2][N_CONE_SLOTS * 32];
    const int lane = threadIdx.x, warp = threadIdx.y;
    const long long i = (long long)blockIdx.x * 32 + lane;
    const bool on = i < n;
    const float rx = on ? rays[3 * i] : 0.0f, ry = on ? rays[3 * i + 1] : 0.0f;
    const float rz = on ? rays[3 * i + 2] : 0.0f;
    ConeRay ray{o[0], o[1], o[2], 0.0f, 0.0f};
    bool marching = on;
    for (int step = 0; step < MAX_STEPS; ++step) {
        if (!__any_sync(0xffffffffu, marching)) break;
        float* v = s_slots[step & 1] + lane;
        cone_slots<CONE_WARPS>(warp, ray.vx, ray.vy, ray.vz, s_bank, ad, ex, v);
        __syncthreads();
        const float s = cone_tape(v) * TOL;
        if (marching) marching = cone_advance(ray, rx, ry, rz, s);
    }
    if (on && warp == 0) t_safe[i] = ray.tprev;
}

static dim3 cone_block() { return dim3(32, CONE_WARPS); }
static long long cone_rays_per_block() { return 32; }
#else
__global__ void __launch_bounds__(128)
cone_march_kernel(float* __restrict__ t_safe, long long n, const float* __restrict__ rays,
                  const float* __restrict__ o, const float* __restrict__ pos,
                  const float* __restrict__ right, const float* __restrict__ up,
                  const float* __restrict__ fwd, const float* __restrict__ ad,
                  const float* __restrict__ ex, const float* __restrict__ gbank) {
    SCENE_BANK(s_bank, lane_bank, gbank, pos, right, up, fwd);
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    t_safe[i] = cone_ray(o[0], o[1], o[2], rays[3 * i], rays[3 * i + 1], rays[3 * i + 2], s_bank,
                         ad, ex);
}

static dim3 cone_block() { return dim3(128); }
static long long cone_rays_per_block() { return 128; }
#endif

extern "C" int launch_cone_march(void* t_safe, long long n, const void* rays, const void* o,
                                 SCENE_PARAMS) {
    if (const int rc = use_device(device)) return rc;
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + cone_rays_per_block() - 1) / cone_rays_per_block());
    if (const int rc = prepare_bank(pos, right, up, fwd, gbank, (cudaStream_t)stream)) return rc;
    cone_march_kernel<<<blocks, cone_block(), 0, (cudaStream_t)stream>>>(
        (float*)t_safe, n, (const float*)rays, (const float*)o, SCENE_ARGS);
    return (int)cudaGetLastError();
}
