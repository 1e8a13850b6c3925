// The render's LOD gradient taps, every band and cascade in one launch.
//
// Replaces godotoceanwaves_tpu/ops/pallas_tap.py fused_tap (the Pallas
// kernels _tap_kernel_linear and _tap_kernel_blend) as the JAX package calls
// it from models/shading.py cascade_gradient_lod: one call per (band,
// cascade), chosen by lax.switch over the band's mip level and slab window.
//
// One thread per pixel of a band. For each cascade c it reads the band's
// level l (l == nlev skips the cascade), takes level l of the bf16 pyramid
// (R >> l texels a side), and samples the (grad_x, grad_y, foam) planes at
// texel coordinates f = x_world * scale * n - 0.5 with circular weights:
// the 2x2 bilinear hat, or for mix_t = min(1, 0.1 n min(s0, s1)) < 1 the
// 4x4 cubic B-spline blended with it, cub (1 - t) + lin t. Weights are
// computed as pallas_tap.py:63-86 does (circular distance to each texel,
// then the weight rounded to bf16); products of two bf16 numbers are exact
// in fp32 and the sums are fp32. The tap adds tap * (s3, s3, 1) to the
// pixel's gradient.
//
// What bounds it: 8 bytes in (x, z) and 12 out per pixel; the texels it
// reads come from a pyramid of ~25 MB for 3 x 1024^2 bf16 maps, which stays
// in the 50 MB L2, and neighbouring threads read neighbouring texels.
//
// Built with -fmad=false (ops/_build.py): a contracted `u * n - 0.5` or
// `d * d * d` moves a weight by an ulp, which can flip its bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float hat_weight(float d) { return fmaxf(0.0f, 1.0f - d); }

__device__ __forceinline__ float cubic_weight(float d) {
    const float d2 = d * d;
    const float d3 = d2 * d;
    const float near_w = (4.0f - 6.0f * d2 + 3.0f * d3) / 6.0f;
    const float c = fmaxf(2.0f - d, 0.0f);
    const float far_w = c * (c * c) / 6.0f;
    return d < 1.0f ? near_w : far_w;
}

// The K nonzero circular weights at texel coordinate f of an n-texel axis:
// K = 2 (hat, texels floor(f mod n) + {0, 1}) or K = 4 (cubic, + {-1..2}).
template <int K>
__device__ __forceinline__ void wrap_taps(float f, int n, int* idx, float* w) {
    const float nf = (float)n;
    float fw = fmodf(f, nf);               // jnp.mod: fmod, + n if negative
    if (fw < 0.0f) fw += nf;
    const int base = (int)floorf(fw);
    const int first = K == 4 ? -1 : 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        int i = (base + first + j) % n;
        if (i < 0) i += n;
        float d = fabsf(fw - (float)i);
        d = fminf(d, nf - d);
        idx[j] = i;
        w[j] = bf16_round(K == 4 ? cubic_weight(d) : hat_weight(d));
    }
}

// One separable tap of the three (n, n) planes starting at `planes`.
template <int K>
__device__ __forceinline__ void tap(const __nv_bfloat16* __restrict__ planes, int n,
                                    float fx, float fv, float* out) {
    int ix[K], iv[K];
    float wx[K], wv[K];
    wrap_taps<K>(fx, n, ix, wx);
    wrap_taps<K>(fv, n, iv, wv);
    const int64_t plane = (int64_t)n * n;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const __nv_bfloat16* p = planes + ch * plane;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            float row = 0.0f;
#pragma unroll
            for (int i = 0; i < K; ++i)
                row = row + wv[i] * __bfloat162float(p[(int64_t)iv[i] * n + ix[j]]);
            acc = acc + row * wx[j];
        }
        out[ch] = acc;
    }
}

__global__ void __launch_bounds__(256) lod_tap_kernel(
        const __nv_bfloat16* __restrict__ pyr, const float* __restrict__ scales,
        const float* __restrict__ xz, const int* __restrict__ levels,
        float* __restrict__ out, int bands, int pixels, int cascades, int res, int nlev) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)bands * pixels) return;
    const int b = (int)(t / pixels);
    const float x = xz[2 * t];
    const float z = xz[2 * t + 1];
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    for (int c = 0; c < cascades; ++c) {
        // lax.switch clamps its index to [0, nlev]; nlev is the skip branch
        // (adds zeros). Written as two range tests: the form
        // `max(0, min(l, nlev)) == nlev` was miscompiled (true at l = 0).
        const int raw = levels[b * cascades + c];
        if (raw >= nlev) continue;
        const int lev = raw < 0 ? 0 : raw;
        const int n = res >> lev;
        int64_t off = 0;
        for (int l = 0; l < lev; ++l) {
            const int64_t nl = res >> l;
            off += (int64_t)cascades * 3 * nl * nl;
        }
        off += (int64_t)c * 3 * n * n;
        const float s0 = scales[4 * c], s1 = scales[4 * c + 1], s3 = scales[4 * c + 3];
        const float nf = (float)n;
        const float fx = x * s0 * nf - 0.5f;
        const float fv = z * s1 * nf - 0.5f;
        const float mix = fminf(1.0f, nf * fminf(s0, s1) * 0.1f);
        float lin[3];
        tap<2>(pyr + off, n, fx, fv, lin);
        float r0 = lin[0], r1 = lin[1], r2 = lin[2];
        if (!(mix >= 1.0f)) {
            float cub[3];
            tap<4>(pyr + off, n, fx, fv, cub);
            const float u = 1.0f - mix;
            r0 = cub[0] * u + lin[0] * mix;
            r1 = cub[1] * u + lin[1] * mix;
            r2 = cub[2] * u + lin[2] * mix;
        }
        g0 = g0 + r0 * s3;
        g1 = g1 + r1 * s3;
        g2 = g2 + r2;
    }
    out[3 * t] = g0;
    out[3 * t + 1] = g1;
    out[3 * t + 2] = g2;
}

}  // namespace

extern "C" int lod_tap(const void* pyr, const void* scales, const void* xz, const void* levels,
                       void* out, int bands, int pixels, int cascades, int res, int nlev,
                       void* stream) {
    const int64_t total = (int64_t)bands * pixels;
    if (total == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    lod_tap_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)pyr, (const float*)scales, (const float*)xz,
        (const int*)levels, (float*)out, bands, pixels, cascades, res, nlev);
    return (int)cudaGetLastError();
}
