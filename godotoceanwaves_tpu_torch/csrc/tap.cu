// The render's LOD gradient taps, every band and cascade in one launch.
//
// Replaces godotoceanwaves_tpu/ops/pallas_tap.py fused_tap (the Pallas
// kernels _tap_kernel_linear and _tap_kernel_blend) as the JAX package calls
// it from models/shading.py cascade_gradient_lod: one call per (band,
// cascade), chosen by lax.switch over the band's mip level and slab window.
//
// A grid of (blocks per band, bands): every choice that is uniform over a
// band is made once per block, into shared memory, before any pixel is
// tapped: for each cascade c the band's level l (l >= nlev skips the
// cascade), its planes (R >> l texels a side), the scales, and the blend
// mix_t = min(1, 0.1 n min(s0, s1)), whose test (bilinear alone, or the 4x4
// cubic B-spline blended with it, cub (1 - t) + lin t) no warp diverges on.
// One thread a pixel then samples the (grad_x, grad_y, foam) planes at
// texel coordinates f = x_world * scale * n - 0.5 with circular weights,
// computed as pallas_tap.py:63-86 does (circular distance to each texel,
// then the weight rounded to bf16); products of two bf16 numbers are exact
// in fp32 and the sums are fp32. The tap adds tap * (s3, s3, 1) to the
// pixel's gradient.
//
// The levels are the caller's, read in place: a by-value table of level
// pointers, fp32 (the renderer's) or bf16, each texel rounded to bf16 as it
// is loaded (__float2bfloat16_rn, the rounding of .to(torch.bfloat16)). A
// tap issues all its loads (2x2 or 4x4 texels x 3 planes) before its
// arithmetic; the blend's bilinear tap reuses the middle 2x2 of the cubic
// one's texels. The wrap is f - n floor(f / n) for a power-of-two R: f / n
// and n floor(.) are exact there, so the one rounded subtraction gives what
// jnp.mod's fmod-then-add gives; another R keeps fmodf.
//
// What bounds it: 8 bytes in (x, z) and 12 out per pixel, and the distinct
// texels its taps touch; the levels of 3 x 1024^2 maps (~50 MB in fp32)
// are read where the frame's bands look, neighbouring threads on
// neighbouring texels.
//
// Built with -fmad=false (ops/_build.py): a contracted `u * n - 0.5` or
// `d * d * d` moves a weight by an ulp, which can flip its bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

struct Levels {
    const void* ptr[kMaxLevels];
};

// One cascade's tap in a band; mode 0 skips it, 1 taps bilinear, 2 blends.
struct CascadeTap {
    const void* planes;
    int n, mode;
    float s0, s1, s3, mix;
};

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float texel(const float* p) { return bf16_round(__ldg(p)); }
__device__ __forceinline__ float texel(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
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

// The K texels of one axis at texel coordinate f of an n-texel axis (K = 2:
// floor(f mod n) + {0, 1}; K = 4: + {-1..2}) and their circular distances.
template <int K, bool POW2>
__device__ __forceinline__ void wrap_axis(float f, int n, int* idx, float* d) {
    const float nf = (float)n;
    float fw;
    if constexpr (POW2) {
        fw = f - nf * floorf(f / nf);
    } else {
        fw = fmodf(f, nf);                  // jnp.mod: fmod, + n if negative
        if (fw < 0.0f) fw += nf;
    }
    const int base = (int)floorf(fw);
    const int first = K == 4 ? -1 : 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        int i = base + first + j;
        if constexpr (POW2) {
            i &= n - 1;
        } else {
            i %= n;
            if (i < 0) i += n;
        }
        const float e = fabsf(fw - (float)i);
        idx[j] = i;
        d[j] = fminf(e, nf - e);
    }
}

// sum_j (sum_i wv[i] t[i][j]) wx[j] over the K x K texels starting at
// (row r0, column c0) of t, in the TPU kernel's order.
template <int K>
__device__ __forceinline__ float separable(const float (&t)[4][4], int r0, int c0,
                                           const float* wv, const float* wx) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        float row = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i) row = row + wv[i] * t[r0 + i][c0 + j];
        acc = acc + row * wx[j];
    }
    return acc;
}

// One cascade's tap of the three (n, n) planes: bilinear (K = 2) into r, or
// (K = 4) the cubic tap blended with the bilinear one of its middle texels.
// Every load of the tap is issued before its arithmetic.
template <int K, bool POW2, typename T>
__device__ __forceinline__ void tap(const T* __restrict__ planes, const CascadeTap& ct, float fx,
                                    float fv, float* r) {
    const int n = ct.n;
    int ix[K], iv[K];
    float dx[K], dv[K];
    wrap_axis<K, POW2>(fx, n, ix, dx);
    wrap_axis<K, POW2>(fv, n, iv, dv);
    const int64_t plane = (int64_t)n * n;
    float t[3][4][4];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j)
                t[ch][i][j] = texel(planes + ch * plane + (int64_t)iv[i] * n + ix[j]);
    const int m = K == 4 ? 1 : 0;           // the bilinear texels within the K x K
    float lx[2], lv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        lx[j] = bf16_round(hat_weight(dx[m + j]));
        lv[j] = bf16_round(hat_weight(dv[m + j]));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) r[ch] = separable<2>(t[ch], m, m, lv, lx);
    if constexpr (K == 4) {
        float cx[4], cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cx[j] = bf16_round(cubic_weight(dx[j]));
            cv[j] = bf16_round(cubic_weight(dv[j]));
        }
        const float u = 1.0f - ct.mix;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            r[ch] = separable<4>(t[ch], 0, 0, cv, cx) * u + r[ch] * ct.mix;
    }
}

template <typename T, bool POW2>
__global__ void __launch_bounds__(kThreads) lod_tap_kernel(
        Levels lv, const float* __restrict__ scales, const float* __restrict__ xz,
        int64_t xz_band, int64_t xz_pixel, int64_t xz_comp, const int* __restrict__ levels,
        float* __restrict__ out, int pixels, int cascades, int res, int nlev) {
    extern __shared__ CascadeTap taps[];
    const int b = blockIdx.y;
    for (int c = threadIdx.x; c < cascades; c += blockDim.x) {
        // lax.switch clamps its index to [0, nlev]; nlev is the skip branch
        // (adds zeros). Written as two range tests: the form
        // `max(0, min(l, nlev)) == nlev` was miscompiled (true at l = 0).
        const int raw = levels[b * cascades + c];
        CascadeTap ct{};
        if (raw < nlev) {
            const int lev = raw < 0 ? 0 : raw;
            ct.n = res >> lev;
            ct.planes = (const T*)lv.ptr[lev] + (int64_t)c * 3 * ct.n * ct.n;
            ct.s0 = scales[4 * c];
            ct.s1 = scales[4 * c + 1];
            ct.s3 = scales[4 * c + 3];
            ct.mix = fminf(1.0f, (float)ct.n * fminf(ct.s0, ct.s1) * 0.1f);
            ct.mode = ct.mix >= 1.0f ? 1 : 2;
        }
        taps[c] = ct;
    }
    __syncthreads();
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= pixels) return;
    const float* q = xz + b * xz_band + p * xz_pixel;
    const float x = q[0];
    const float z = q[xz_comp];
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    for (int c = 0; c < cascades; ++c) {
        const CascadeTap ct = taps[c];
        if (ct.mode == 0) continue;
        const float nf = (float)ct.n;
        const float fx = x * ct.s0 * nf - 0.5f;
        const float fv = z * ct.s1 * nf - 0.5f;
        float r[3];
        if (ct.mode == 1)
            tap<2, POW2>((const T*)ct.planes, ct, fx, fv, r);
        else
            tap<4, POW2>((const T*)ct.planes, ct, fx, fv, r);
        g0 = g0 + r[0] * ct.s3;
        g1 = g1 + r[1] * ct.s3;
        g2 = g2 + r[2];
    }
    float* o = out + ((int64_t)b * pixels + p) * 3;
    o[0] = g0;
    o[1] = g1;
    o[2] = g2;
}

template <typename T, bool POW2>
cudaError_t launch(const Levels& lv, const float* scales, const float* xz, int64_t xz_band,
                   int64_t xz_pixel, int64_t xz_comp, const int* levels, float* out, int bands,
                   int pixels, int cascades, int res, int nlev, cudaStream_t stream) {
    const dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads), (unsigned)bands);
    const size_t smem = (size_t)cascades * sizeof(CascadeTap);
    lod_tap_kernel<T, POW2><<<grid, kThreads, smem, stream>>>(
        lv, scales, xz, xz_band, xz_pixel, xz_comp, levels, out, pixels, cascades, res, nlev);
    return cudaGetLastError();
}

}  // namespace

// levels: nlev device pointers to contiguous (C, 3, R >> l, R >> l) levels
// of one dtype (bf16 != 0: bf16, else fp32); xz (B, P, 2) fp32 by element
// strides; band_levels (B, C) int32 and scales (C, 4) fp32 contiguous; out
// (B, P, 3) fp32 contiguous.
extern "C" int lod_tap(const void* const* levels_ptrs, int nlev, int bf16, const void* scales,
                       const void* xz, long long xz_band, long long xz_pixel, long long xz_comp,
                       const void* band_levels, void* out, int bands, int pixels, int cascades,
                       int res, void* stream) {
    if ((int64_t)bands * pixels == 0) return 0;
    if (nlev < 1 || nlev > kMaxLevels || bands > 65535) return (int)cudaErrorInvalidValue;
    Levels lv{};
    for (int l = 0; l < nlev; ++l) lv.ptr[l] = levels_ptrs[l];
    const bool pow2 = (res & (res - 1)) == 0;
    const auto* s = (const float*)scales;
    const auto* x = (const float*)xz;
    const auto* bl = (const int*)band_levels;
    auto* o = (float*)out;
    const auto st = (cudaStream_t)stream;
#define TAP_ARGS lv, s, x, xz_band, xz_pixel, xz_comp, bl, o, bands, pixels, cascades, res, nlev, st
    cudaError_t err;
    if (bf16)
        err = pow2 ? launch<__nv_bfloat16, true>(TAP_ARGS) : launch<__nv_bfloat16, false>(TAP_ARGS);
    else
        err = pow2 ? launch<float, true>(TAP_ARGS) : launch<float, false>(TAP_ARGS);
#undef TAP_ARGS
    return (int)err;
}
