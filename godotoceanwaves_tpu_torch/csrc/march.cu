// Bracket march of a uniform (G, G) height table, one thread per pixel ray.
//
// Replaces godotoceanwaves_tpu/ops/pallas_march.py march_heightfield (the
// Pallas kernel _march_kernel), the renderer's march_impl="pallas". The TPU
// kernel held the table in VMEM and built dense hat-weight rows for an MXU
// product per sample; here each sample reads its 2 x 2 texels.
//
// The kernel takes the wrapper's inputs as they come: rays (P, 3), the march
// window t0, t1, the valid mask (bool bytes), the camera (3,), the grid
// centre (2,), and the table in fp32 or bf16 by its strides (the renderer's
// is a (G, G, 3)[..., 1] slice). It folds the geometry into per-pixel linear
// forms with the fp32 operations of ops/march.py _lanes
// (pallas_march.py:138-148):
//   fx(t) = ax + t bx, ax = (cam_x - centre_x - origin) * inv_cell, bx = dir_x * inv_cell
//   (z alike), below(t) = cam_y + t dir_y < h(fx(t), fz(t)).
//
// Per pixel: b0 = below(t0) (camera under a crest: bracket (t0, t0 + seg));
// else the first of march_steps samples t = t0 + (k + 1) seg below the
// surface brackets (t - seg, t]; then refine_rounds rounds of 8 samples
// inside the bracket. Samples run in groups of kGroup: a group issues the
// texel loads of all its samples before any compare, takes its first
// crossing, and the round stops between groups. Later samples cannot change
// the first crossing, so this is the serial march's result bit for bit, as
// the TPU kernel's (pallas_march.py:76-88). The numbers follow the TPU
// kernel: bf16 table, z hat weights rounded to bf16 (pallas_march.py:69), x
// hat weights kept fp32 (:73), fp32 sums; no contraction (built with
// -fmad=false, ops/_build.py).
//
// What bounds it: the table reads, 4 texels a sample and ~56 samples a
// pixel at the interactive settings; 21 bytes in and 9 out per pixel. The
// renderer's strided fp32 table spans 768 KB at G = 256, more than an SM's
// L1, so the launch is a cooperative grid of resident blocks that first
// copies the table once into a compact bf16 scratch (128 KB, L1-resident),
// meets at a grid-wide barrier, then marches the pixels in turn. Groups of
// 4 samples beat 1 and 8 (1 leaves each sample's loads waiting on the last
// compare; 8 takes 80 registers to 4's 61), and the compact table beat
// reading the strided table in place by 1.4x at 640x360 (PERF.md §6).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float texel(const float* p) { return bf16_round(__ldg(p)); }
__device__ __forceinline__ float texel(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}

// The caller's table by its element strides, texel (i, j) at
// p[i * row + j * col].
template <typename T>
struct Table {
    const T* p;
    int64_t row, col;
    __device__ __forceinline__ float operator()(int i, int j) const {
        return texel(p + i * row + j * col);
    }
};

// The launch's compact bf16 copy of the table, written in the same launch
// (so read by plain loads, not the read-only path).
struct Compact {
    const __nv_bfloat16* p;
    int g;
    __device__ __forceinline__ float operator()(int i, int j) const {
        return __bfloat162float(p[i * g + j]);
    }
};

struct Ray {
    float ax, az, cy, bx, bz, dy;
};

// One sample at t: its table coordinates and its 2 x 2 texels, loaded.
struct Sample {
    float t, fx, fz, h[4];
};

__device__ __forceinline__ Sample load(const Compact& tab, float hi_cap, const Ray& r, float t) {
    Sample s;
    s.t = t;
    s.fx = fminf(fmaxf(r.ax + t * r.bx, 0.0f), hi_cap);
    s.fz = fminf(fmaxf(r.az + t * r.bz, 0.0f), hi_cap);
    const int i = (int)s.fz, j = (int)s.fx;     // fz, fx >= 0: truncation is floor
    s.h[0] = tab(i, j);
    s.h[1] = tab(i + 1, j);
    s.h[2] = tab(i, j + 1);
    s.h[3] = tab(i + 1, j + 1);
    return s;
}

__device__ __forceinline__ bool below(const Sample& s, const Ray& r) {
    const int i = (int)s.fz, j = (int)s.fx;
    const float wz0 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(s.fz - (float)i)));
    const float wz1 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(s.fz - (float)(i + 1))));
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(s.fx - (float)j));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(s.fx - (float)(j + 1)));
    const float r0 = wz0 * s.h[0] + wz1 * s.h[1];
    const float r1 = wz0 * s.h[2] + wz1 * s.h[3];
    return (r.cy + s.t * r.dy) < r0 * wx0 + r1 * wx1;
}

// The first crossing among samples k0 + 1 .. k0 + kGroup (of m) at
// t = lo + k seg, every load issued before the first compare: its index
// within the group, or kGroup.
__device__ __forceinline__ int group_first(const Compact& tab, float hi_cap, const Ray& r,
                                           float lo, float seg, int k0, int m) {
    Sample s[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) s[q] = load(tab, hi_cap, r, lo + (float)(k0 + q + 1) * seg);
    int first = kGroup;
#pragma unroll
    for (int q = kGroup - 1; q >= 0; --q)
        if (k0 + q < m && below(s[q], r)) first = q;
    return first;
}

// The first below-surface crossing among m samples of (lo, hi]; the bracket
// is updated in place when one is found.
__device__ __forceinline__ bool run_round(const Compact& tab, float hi_cap, const Ray& r,
                                          float& lo, float& hi, int m, float inv_m, bool ok) {
    const float seg = (hi - lo) * inv_m;
    if (!ok) return false;
    for (int k0 = 0; k0 < m; k0 += kGroup) {
        const int q = group_first(tab, hi_cap, r, lo, seg, k0, m);
        if (q < kGroup) {
            const float t = lo + (float)(k0 + q + 1) * seg;
            lo = t - seg;
            hi = t;
            return true;
        }
    }
    return false;
}

struct Args {
    const float *dirs, *t0, *t1, *cam, *center;
    const uint8_t* valid;
    uint8_t* found;
    float *lo, *hi;
    float org, inv_cell, inv_steps;
    int pixels, g, steps, rounds;
};

__device__ __forceinline__ void march_pixel(const Compact& tab, const Args& a, int p) {
    const float* d = a.dirs + (int64_t)3 * p;
    const Ray r{(a.cam[0] - a.center[0] - a.org) * a.inv_cell,
                (a.cam[2] - a.center[1] - a.org) * a.inv_cell, a.cam[1],
                d[0] * a.inv_cell, d[2] * a.inv_cell, d[1]};
    const float hi_cap = (float)a.g - 1.001f;
    const float t0 = a.t0[p], t1 = a.t1[p];
    const bool v = a.valid[p] != 0;
    const bool b0 = v && below(load(tab, hi_cap, r, t0), r);
    float lo = t0, hi = t1;
    bool found = run_round(tab, hi_cap, r, lo, hi, a.steps, a.inv_steps, v && !b0);
    if (b0) {
        lo = t0;
        hi = t0 + (t1 - t0) * a.inv_steps;
        found = true;
    }
    for (int k = 0; k < a.rounds; ++k)
        run_round(tab, hi_cap, r, lo, hi, 8, 0.125f, found);
    a.found[p] = found ? 1 : 0;
    a.lo[p] = lo;
    a.hi[p] = hi;
}

// A cooperative grid of resident blocks: the table copied once into the
// compact bf16 scratch, a grid-wide barrier, then the pixels, a thread a
// pixel in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads) march_kernel(Table<T> src, __nv_bfloat16* compact,
                                                         Args a) {
    const int texels = a.g * a.g, stride = gridDim.x * kThreads;
    for (int k = blockIdx.x * kThreads + threadIdx.x; k < texels; k += stride)
        compact[k] = __float2bfloat16_rn(src(k / a.g, k % a.g));
    cooperative_groups::this_grid().sync();
    const Compact tab{compact, a.g};
    for (int p = blockIdx.x * kThreads + threadIdx.x; p < a.pixels; p += stride)
        march_pixel(tab, a, p);
}

template <typename T>
cudaError_t launch(Table<T> tab, __nv_bfloat16* compact, Args a, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, march_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return err;
    // every block resident (the barrier needs it), and no more than the work
    const int64_t work = a.pixels > a.g * a.g ? a.pixels : a.g * a.g;
    const int64_t want = (work + kThreads - 1) / kThreads;
    const int blocks = (int)(want < (int64_t)sms * per_sm ? want : (int64_t)sms * per_sm);
    void* args[] = {&tab, &compact, &a};
    err = cudaLaunchCooperativeKernel((const void*)march_kernel<T>, blocks, kThreads, args, 0,
                                      stream);
    return err == cudaSuccess ? cudaGetLastError() : err;
}

}  // namespace

// table (G, G) by its element strides, bf16 != 0: bf16, else fp32; compact
// G^2 bf16 scratch; dirs (P, 3), t0, t1 (P,) fp32 and valid (P,) bytes
// contiguous; cam (3,), center (2,) fp32; found (P,) bytes (a torch.bool
// tensor), lo, hi (P,) fp32.
extern "C" int march_heightfield(const void* table, int bf16, long long row, long long col,
                                 void* compact, const void* dirs, const void* t0, const void* t1,
                                 const void* valid, const void* cam, const void* center,
                                 float org, float inv_cell, void* found, void* lo, void* hi,
                                 int pixels, int g, int steps, float inv_steps, int rounds,
                                 void* stream) {
    if (pixels == 0) return 0;
    const Args a{(const float*)dirs, (const float*)t0, (const float*)t1, (const float*)cam,
                 (const float*)center, (const uint8_t*)valid, (uint8_t*)found, (float*)lo,
                 (float*)hi, org, inv_cell, inv_steps, pixels, g, steps, rounds};
    const auto st = (cudaStream_t)stream;
    auto* c = (__nv_bfloat16*)compact;
    if (bf16)
        return (int)launch(Table<__nv_bfloat16>{(const __nv_bfloat16*)table, row, col}, c, a, st);
    return (int)launch(Table<float>{(const float*)table, row, col}, c, a, st);
}
