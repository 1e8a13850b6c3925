// Bracket march of a uniform (G, G) height table, one thread per pixel ray.
//
// Replaces godotoceanwaves_tpu/ops/pallas_march.py march_heightfield (the
// Pallas kernel _march_kernel), the renderer's march_impl="pallas". The TPU
// kernel held the table in VMEM and built dense hat-weight rows for an MXU
// product per sample; here each sample reads its 2 x 2 texels.
//
// Per pixel: b0 = below(t0) (camera under a crest: bracket (t0, t0 + seg));
// else the first of march_steps samples t = t0 + (k + 1) seg below the
// surface brackets (t - seg, t]; then refine_rounds rounds of 8 samples
// inside the bracket. A round stops at its first crossing: later samples
// cannot change the first one. The numbers follow the TPU kernel: bf16
// table, z hat weights rounded to bf16 (pallas_march.py:69), x hat weights
// kept fp32 (:73), fp32 sums; fx = ax + t bx with no contraction (built with
// -fmad=false, ops/_build.py).
//
// What bounds it: the table reads, 4 texels a sample (a 256^2 bf16 table is
// 128 KB and stays in L1/L2) and ~56 samples a pixel at the interactive
// settings; 21 bytes in and 9 out per pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

struct Ray {
    float ax, az, cy, bx, bz, dy;
};

__device__ __forceinline__ bool below(const __nv_bfloat16* __restrict__ tab, int g,
                                      float hi_cap, const Ray& r, float t) {
    const float fx = fminf(fmaxf(r.ax + t * r.bx, 0.0f), hi_cap);
    const float fz = fminf(fmaxf(r.az + t * r.bz, 0.0f), hi_cap);
    const int i = (int)fz;                 // fz >= 0: truncation is floor
    const int j = (int)fx;
    const float wz0 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(fz - (float)i)));
    const float wz1 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(fz - (float)(i + 1))));
    const float wx0 = fmaxf(0.0f, 1.0f - fabsf(fx - (float)j));
    const float wx1 = fmaxf(0.0f, 1.0f - fabsf(fx - (float)(j + 1)));
    const __nv_bfloat16* p0 = tab + (int64_t)i * g + j;
    const __nv_bfloat16* p1 = p0 + g;
    const float r0 = wz0 * __bfloat162float(__ldg(p0)) + wz1 * __bfloat162float(__ldg(p1));
    const float r1 = wz0 * __bfloat162float(__ldg(p0 + 1)) + wz1 * __bfloat162float(__ldg(p1 + 1));
    return (r.cy + t * r.dy) < r0 * wx0 + r1 * wx1;
}

// First below-surface crossing among m samples of (lo, hi]; the bracket is
// updated in place when one is found.
__device__ __forceinline__ bool run_round(const __nv_bfloat16* __restrict__ tab, int g,
                                          float hi_cap, const Ray& r, float& lo, float& hi,
                                          int m, float inv_m, bool ok) {
    const float seg = (hi - lo) * inv_m;
    if (!ok) return false;
    for (int k = 0; k < m; ++k) {
        const float t = lo + (float)(k + 1) * seg;
        if (below(tab, g, hi_cap, r, t)) {
            lo = t - seg;
            hi = t;
            return true;
        }
    }
    return false;
}

__global__ void __launch_bounds__(256) march_kernel(
        const __nv_bfloat16* __restrict__ tab, const float* __restrict__ bx,
        const float* __restrict__ bz, const float* __restrict__ dy,
        const float* __restrict__ t0, const float* __restrict__ t1,
        const uint8_t* __restrict__ valid, const float* __restrict__ scal,
        uint8_t* __restrict__ found_out, float* __restrict__ lo_out, float* __restrict__ hi_out,
        int pixels, int g, int steps, float inv_steps, int rounds) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= pixels) return;
    const Ray r{scal[0], scal[1], scal[2], bx[p], bz[p], dy[p]};
    const float hi_cap = (float)g - 1.001f;
    const float a = t0[p], b = t1[p];
    const bool v = valid[p] != 0;
    const bool b0 = v && below(tab, g, hi_cap, r, a);
    float lo = a, hi = b;
    bool found = run_round(tab, g, hi_cap, r, lo, hi, steps, inv_steps, v && !b0);
    if (b0) {
        lo = a;
        hi = a + (b - a) * inv_steps;
        found = true;
    }
    for (int k = 0; k < rounds; ++k)
        run_round(tab, g, hi_cap, r, lo, hi, 8, 0.125f, found);
    found_out[p] = found ? 1 : 0;
    lo_out[p] = lo;
    hi_out[p] = hi;
}

}  // namespace

extern "C" int march_heightfield(const void* table, const void* bx, const void* bz,
                                 const void* dy, const void* t0, const void* t1,
                                 const void* valid, const void* scal, void* found, void* lo,
                                 void* hi, int pixels, int g, int steps, float inv_steps,
                                 int rounds, void* stream) {
    if (pixels == 0) return 0;
    const int threads = 256;
    const int blocks = (pixels + threads - 1) / threads;
    march_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)table, (const float*)bx, (const float*)bz, (const float*)dy,
        (const float*)t0, (const float*)t1, (const uint8_t*)valid, (const float*)scal,
        (uint8_t*)found, (float*)lo, (float*)hi, pixels, g, steps, inv_steps, rounds);
    return (int)cudaGetLastError();
}
