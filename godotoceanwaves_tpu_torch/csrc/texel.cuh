// Per-texel math shared by the fused step (fused_step.cu) and the strip step
// (strip_step.cu): the row pass's prologue (modulation and the 4 packed
// layers) and the column pass's epilogue (ifftshift sign, displacement,
// normals, foam). No fast math: the phase, the wavenumbers and the normals
// are rounded as the plain PyTorch version rounds them.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace texel {

// Per-cascade scalar row layout (ops/fused_step.py pack_scalars).
enum { S_TIME = 0, S_LX, S_LY, S_WHITECAP, S_GROW, S_DECAY, S_DT, NUM_SCALARS = 8 };
constexpr int kLayers = 4;

// One spectrum row y of cascade c, modulated at time t.
struct Row {
    const float *h0r, *h0i, *ncr, *nci, *om;
    float half_n, dkx, ky, t;
};

__device__ __forceinline__ Row row_at(const float* h0, const float* h0nc, const float* omega,
                                      const float* sc, int c, int y, int n, float t) {
    const float two_pi = 6.283185307179586f;
    const size_t plane = static_cast<size_t>(n) * n;
    const size_t row = static_cast<size_t>(y) * n;
    Row r;
    r.h0r = h0 + 2 * c * plane + row;
    r.h0i = r.h0r + plane;
    r.ncr = h0nc + 2 * c * plane + row;
    r.nci = r.ncr + plane;
    r.om = omega + c * plane + row;
    r.half_n = static_cast<float>(n) * 0.5f;
    r.dkx = __fdiv_rn(two_pi, sc[S_LX]);
    r.ky = __fmul_rn(static_cast<float>(y) - r.half_n, __fdiv_rn(two_pi, sc[S_LY]));
    r.t = t;
    return r;
}

// The 4 packed layers at column x (spectrum_modulate.glsl:53-89). omega * t
// reaches ~7.6e3 rad at 8192, so sincosf keeps its full range reduction.
__device__ __forceinline__ void modulate(const Row& r, int x, float2* v) {
    const float kx = __fmul_rn(static_cast<float>(x) - r.half_n, r.dkx);
    const float ky = r.ky;
    const float k = __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky))), 1e-6f);
    float s, co;
    sincosf(__fmul_rn(r.om[x], r.t), &s, &co);
    const float ar = r.h0r[x], ai = r.h0i[x], br = r.ncr[x], bi = r.nci[x];
    // h = h0 e^{i w t} + conj(h0(-k)) e^{-i w t}  (spectrum_modulate.glsl:62-68)
    const float hr = co * (ar + br) + s * (bi - ai);
    const float hi = s * (ar - br) + co * (ai + bi);
    const float kux = __fdiv_rn(kx, k);
    const float kuy = __fdiv_rn(ky, k);
    // packed layers, closed real forms of spectrum_modulate.glsl:71-89
    const float a0 = 1.0f + kuy;
    v[0] = make_float2(-hi * a0, hr * a0);
    v[1] = make_float2(-hi * kux - hr * ky, hr * kux - hi * ky);
    const float a2 = kx - ky * kuy;
    v[2] = make_float2(-hi * a2, hr * a2);
    v[3] = make_float2(kux * (hi * ky - hr * kx), -kux * (hr * ky + hi * kx));
}

template <typename T> __device__ __forceinline__ T to_map(float v);
template <> __device__ __forceinline__ float to_map<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_map<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half to_map<__half>(float v) {
    return __float2half_rn(v);
}

// Unpack the 4 transformed layers of output texel (kx, m) into
// displacement d[ch * plane + m], normal nm[ch * plane + m] and foam;
// returns the new foam (fft_unpack.glsl:37-67).
template <typename OutT>
__device__ __forceinline__ float unpack(float2 l0, float2 l1, float2 l2, float2 l3, int kx, int m,
                                        float foam_prev, float keep, float whitecap, float grow,
                                        OutT* d, OutT* nm, size_t plane) {
    // ifftshift (-1)^(x+y), fft_unpack.glsl:37-38
    const float sign = ((kx + m) & 1) ? -1.0f : 1.0f;
    const float hx = l0.x * sign, hy = l0.y * sign;
    const float hz = l1.x * sign, dhy_dx = l1.y * sign;
    const float dhy_dz = l2.x * sign, dhx_dx = l2.y * sign;
    const float dhz_dz = l3.x * sign, dhz_dx = l3.y * sign;
    // Jacobian foam, fft_unpack.glsl:58-64
    const float jac = (1.0f + dhx_dx) * (1.0f + dhz_dz) - dhz_dx * dhz_dx;
    const float foam_factor = -fminf(0.0f, jac - whitecap);
    float foam = foam_prev * keep + foam_factor * grow;
    foam = fminf(fmaxf(foam, 0.0f), 1.0f);
    d[m] = to_map<OutT>(hx);
    d[plane + m] = to_map<OutT>(hy);
    d[2 * plane + m] = to_map<OutT>(hz);
    nm[m] = to_map<OutT>(__fdiv_rn(dhy_dx, 1.0f + fabsf(dhx_dx)));
    nm[plane + m] = to_map<OutT>(__fdiv_rn(dhy_dz, 1.0f + fabsf(dhz_dz)));
    nm[2 * plane + m] = to_map<OutT>(dhx_dx);
    nm[3 * plane + m] = to_map<OutT>(foam);
    return foam;
}

}  // namespace texel
