// Fused ocean step for Hopper (sm_90a): modulate -> 2D IFFT -> unpack + foam.
//
// Replaces godotoceanwaves_tpu/ops/pallas_step.py `_fused_call` (the Pallas
// kernel `_step_kernel` -> `_one_frame`). Two kernels, launched back to back
// on the caller's stream, in the shape of the GLSL reference (one workgroup
// per row, shared-memory Stockham, fft_compute.glsl):
//
//   rows: block (row y, cascade c). Prologue: read one row of h0, h0nc and
//         omega, modulate h(k, t) (phase = omega * t in fp32, accurate
//         sincosf) and synthesize the 4 packed layers. Then a radix-2
//         Stockham IFFT of every layer along x in shared memory. Writes
//         R[c][y][kx][layer][re, im] to an fp32 scratch buffer: the 8 floats
//         of one texel are one 32-byte sector.
//   cols: block (column kx, cascade c). Reads column kx of the scratch (one
//         sector per y), runs the Stockham IFFT along y; the result is OUTPUT
//         ROW kx (Z[kx][m] = sum_y sum_x X[y][x] w^(x kx + y m)), which is
//         the reference's rows -> transpose -> rows chain with no second
//         transpose. Epilogue: (-1)^(kx+m) ifftshift, displacement, normal
//         from fp32 gradients (rounded once), fp32 foam recurrence.
//
// Bound: device memory bandwidth. Per cascade-frame at 1024^2: 20 MB of
// spectra + omega in, 32 MB of scratch written and read back, 4 MB of foam in
// and out, 14 MB of bf16 maps out (~106 MB). The two-pass design pays one
// scratch round trip so that no block ever holds a whole layer; both passes
// read and write full 32-byte sectors.
//
// Accuracy: no fast math. omega * t reaches ~6.7e3 rad at 1024^2 (t ~ 126 s),
// so sincosf keeps its full range reduction, and the FFT twiddles come from
// sincospif(2j/N), whose argument is exact for power-of-two N.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "texel.cuh"

namespace {

using texel::kLayers;
using texel::NUM_SCALARS;
using texel::S_DECAY;
using texel::S_DT;
using texel::S_GROW;
using texel::S_TIME;
using texel::S_WHITECAP;
// 4 layers x N/2 butterflies per stage, over N/4 threads.
constexpr int kButterfliesPerThread = 8;
constexpr int kMinN = 16;
constexpr int kMaxN = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[j] = e^{+2 pi i j / n}, j < n/2.
__device__ void fill_twiddles(float2* tw, int n) {
    for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
        float s, c;
        sincospif(static_cast<float>(2 * j) / static_cast<float>(n), &s, &c);
        tw[j] = make_float2(c, s);
    }
}

// In-place radix-2 Stockham (decimation in frequency, natural-order output)
// of 4 layers of length n held in buf[layer * n + i]; unnormalized, positive
// exponent. Needs blockDim.x == n / 4 and a barrier before the call. Each
// stage reads every element once into registers, syncs, then writes.
__device__ void stockham_layers(float2* buf, const float2* tw, int n, int log2n) {
    const int half = n >> 1;
    for (int ls = 0; ls < log2n; ++ls) {
        const int s = 1 << ls;
        float2 lo[kButterfliesPerThread], hi[kButterfliesPerThread];
        int dst[kButterfliesPerThread];
#pragma unroll
        for (int i = 0; i < kButterfliesPerThread; ++i) {
            const int g = threadIdx.x + i * blockDim.x;
            const int layer = g >> (log2n - 1);
            const int b = g & (half - 1);          // b = q + s * p
            const int q = b & (s - 1);
            const int p = b >> ls;
            const float2* x = buf + layer * n;
            const float2 a = x[b];
            const float2 c = x[b + half];
            lo[i] = make_float2(a.x + c.x, a.y + c.y);
            hi[i] = cmul(make_float2(a.x - c.x, a.y - c.y), tw[p << ls]);
            dst[i] = layer * n + q + (p << (ls + 1));
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kButterfliesPerThread; ++i) {
            buf[dst[i]] = lo[i];
            buf[dst[i] + s] = hi[i];
        }
        __syncthreads();
    }
}

__global__ void rows_kernel(const float* __restrict__ h0,
                            const float* __restrict__ h0nc,
                            const float* __restrict__ omega,
                            const float* __restrict__ scal,
                            float* __restrict__ scratch,
                            int n, int log2n, int frame) {
    extern __shared__ float2 smem[];
    float2* buf = smem;                   // kLayers * n
    float2* tw = smem + kLayers * n;      // n / 2
    const int y = blockIdx.x;
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;
    // frame k modulates at S_TIME + k * S_DT, rounded as two fp32 ops
    const float t = __fadd_rn(sc[S_TIME], __fmul_rn(static_cast<float>(frame), sc[S_DT]));
    const texel::Row r = texel::row_at(h0, h0nc, omega, sc, c, y, n, t);

    fill_twiddles(tw, n);

    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        float2 v[kLayers];
        texel::modulate(r, x, v);
#pragma unroll
        for (int l = 0; l < kLayers; ++l) buf[l * n + x] = v[l];
    }
    __syncthreads();
    stockham_layers(buf, tw, n, log2n);

    float4* out = reinterpret_cast<float4*>(scratch) + ((static_cast<size_t>(c) * n + y) * n) * 2;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const float2 l0 = buf[k], l1 = buf[n + k], l2 = buf[2 * n + k], l3 = buf[3 * n + k];
        out[2 * k] = make_float4(l0.x, l0.y, l1.x, l1.y);
        out[2 * k + 1] = make_float4(l2.x, l2.y, l3.x, l3.y);
    }
}

template <typename OutT>
__global__ void cols_kernel(const float* __restrict__ scratch,
                            const float* foam_in,     // may alias foam_out
                            const float* __restrict__ scal,
                            OutT* __restrict__ disp,
                            OutT* __restrict__ normal,
                            float* foam_out,
                            int n, int log2n,
                            long long disp_cstride, long long norm_cstride) {
    extern __shared__ float2 smem[];
    float2* buf = smem;
    float2* tw = smem + kLayers * n;
    const int kx = blockIdx.x;            // output row
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;

    fill_twiddles(tw, n);

    const size_t plane = static_cast<size_t>(n) * n;
    const float4* in = reinterpret_cast<const float4*>(scratch) + c * plane * 2;
    for (int y = threadIdx.x; y < n; y += blockDim.x) {
        const size_t at = (static_cast<size_t>(y) * n + kx) * 2;
        const float4 a = in[at];
        const float4 b = in[at + 1];
        buf[y] = make_float2(a.x, a.y);
        buf[n + y] = make_float2(a.z, a.w);
        buf[2 * n + y] = make_float2(b.x, b.y);
        buf[3 * n + y] = make_float2(b.z, b.w);
    }
    __syncthreads();
    stockham_layers(buf, tw, n, log2n);

    const float whitecap = sc[S_WHITECAP];
    const float grow = sc[S_GROW];
    const float keep = expf(-sc[S_DECAY]);
    const size_t row = static_cast<size_t>(kx) * n;
    OutT* d = disp + c * disp_cstride + row;
    OutT* nm = normal + c * norm_cstride + row;
    const float* fi = foam_in + c * plane + row;
    float* fo = foam_out + c * plane + row;
    for (int m = threadIdx.x; m < n; m += blockDim.x) {
        fo[m] = texel::unpack<OutT>(buf[m], buf[n + m], buf[2 * n + m], buf[3 * n + m], kx, m,
                                    fi[m], keep, whitecap, grow, d, nm, plane);
    }
}

int log2_of(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return l;
}

bool supported(int c, int n) {
    return c > 0 && c <= 65535 && n >= kMinN && n <= kMaxN && (n & (n - 1)) == 0;
}

size_t smem_bytes(int n) {
    return (kLayers * n + n / 2) * sizeof(float2);
}

template <typename OutT>
int launch_cols(const float* scratch, const float* foam_in, const float* scal,
                void* disp, void* normal, float* foam_out, int c, int n,
                long long disp_cstride, long long norm_cstride, cudaStream_t stream) {
    cols_kernel<OutT><<<dim3(n, c), n / 4, smem_bytes(n), stream>>>(
        scratch, foam_in, scal, static_cast<OutT*>(disp), static_cast<OutT*>(normal),
        foam_out, n, log2_of(n), disp_cstride, norm_cstride);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Row pass for frame `frame` of C cascades at N x N. Returns a cudaError_t.
int fused_step_rows(const float* h0, const float* h0nc, const float* omega,
                    const float* scal, float* scratch, int c, int n, int frame,
                    void* stream) {
    if (!supported(c, n)) return static_cast<int>(cudaErrorInvalidValue);
    rows_kernel<<<dim3(n, c), n / 4, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(
        h0, h0nc, omega, scal, scratch, n, log2_of(n), frame);
    return static_cast<int>(cudaGetLastError());
}

// Column pass + unpack + foam. `dtype`: 0 float32, 1 bfloat16, 2 float16.
// disp / normal point at cascade 0 of this frame; the cascade strides are in
// elements. Returns a cudaError_t.
int fused_step_cols(const float* scratch, const float* foam_in, const float* scal,
                    void* disp, void* normal, float* foam_out, int c, int n, int dtype,
                    long long disp_cstride, long long norm_cstride, void* stream) {
    if (!supported(c, n)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_cols<float>(scratch, foam_in, scal, disp, normal, foam_out,
                                          c, n, disp_cstride, norm_cstride, s);
        case 1: return launch_cols<__nv_bfloat16>(scratch, foam_in, scal, disp, normal,
                                                  foam_out, c, n, disp_cstride, norm_cstride, s);
        case 2: return launch_cols<__half>(scratch, foam_in, scal, disp, normal, foam_out,
                                           c, n, disp_cstride, norm_cstride, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
