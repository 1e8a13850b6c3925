// Strip step for Hopper (sm_90a): the fused ocean step for 1024 < N <= 8192.
//
// Replaces godotoceanwaves_tpu/ops/pallas_strip.py `strip_cascade_step` (the
// Pallas kernels `_pass1_kernel` and `_pass2_kernel`). Same chain as
// fused_step.cu (modulate -> 2D IFFT, sign folded -> unpack + foam), in the
// same two passes with an fp32 scratch between them, rebuilt for large rows:
//
//   rows: block (row y, parity e) x cascade c. Prologue: modulate one row of
//         h0, h0nc and omega and synthesize the 4 packed layers. The FFT along
//         x runs in place in shared memory (radix2.cuh, decimation in
//         frequency), so its output comes out bit-reversed; each thread
//         writes the 32-byte record R[c][y][kx][layer][re, im] of the texel
//         it holds, at kx's natural place.
//   cols: block (column kx, parity e) x cascade c. Reads column kx of the
//         scratch in bit-reversed row order (one 32-byte sector per load) and
//         runs the FFT along y in place (decimation in time), so the result
//         is natural-order OUTPUT ROW kx: the reference's rows -> transpose ->
//         rows chain with no second transpose. Epilogue: (-1)^(kx+m)
//         ifftshift, displacement, normal from fp32 gradients (rounded once),
//         fp32 foam recurrence.
//
// Bound: device memory bandwidth. Per cascade-frame at 2048^2: 84 MB of
// spectra + omega in, 134 MB of scratch written and 134 MB read back, 34 MB
// of foam in and out, 59 MB of bf16 maps out (~445 MB).
//
// What large rows change against fused_step.cu (N <= 1024):
//   - Shared memory: 4 layers + twiddles are 36 N bytes, 144 KB at 4096,
//     above the 48 KB default, so every launch opts in first. At 8192 they
//     would be 288 KB, over a block's 227 KB: there two blocks share a row
//     (or column), one per output parity, each transforming a 4096-point
//     sequence after one radix-2 stage done while loading (split_stage).
//     They read the whole row and write every other output.
//   - Threads: the in-place butterflies loop over their count, so the block
//     size (at most 512) no longer ties to N.
//   - The (C, N, N, 8) scratch is 2 GiB per cascade at 8192: every offset
//     is 64-bit.
//
// Accuracy: no fast math. omega * t reaches ~7.6e3 rad at 8192 on a 64 m
// tile, so sincosf keeps its full range reduction; the phase and the
// wavenumbers are rounded as the plain version rounds them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "radix2.cuh"
#include "texel.cuh"

namespace {

using namespace radix2;
using texel::NUM_SCALARS;
using texel::S_DECAY;
using texel::S_GROW;
using texel::S_TIME;
using texel::S_WHITECAP;

constexpr int kMinN = 2048;
constexpr int kMaxN = 8192;

__global__ void __launch_bounds__(kMaxThreads)
strip_rows_kernel(const float* __restrict__ h0, const float* __restrict__ h0nc,
                  const float* __restrict__ omega, const float* __restrict__ scal,
                  float* __restrict__ scratch, int n, int split, int log2m) {
    extern __shared__ float2 smem[];
    const int m = n / split;
    float2* buf = smem;                 // kSeqs * m
    float2* tw = smem + kSeqs * m;      // m / 2
    const int y = blockIdx.x / split;
    const int e = blockIdx.x % split;
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;
    const texel::Row r = texel::row_at(h0, h0nc, omega, sc, c, y, n, sc[S_TIME]);

    fill_twiddles(tw, m);
    for (int x = threadIdx.x; x < m; x += blockDim.x) {
        float2 v[kSeqs];
        texel::modulate(r, x, v);
        if (split == 2) {
            float2 hi[kSeqs];
            texel::modulate(r, x + m, hi);
#pragma unroll
            for (int s = 0; s < kSeqs; ++s) v[s] = split_stage(v[s], hi[s], e, x, n);
        }
#pragma unroll
        for (int s = 0; s < kSeqs; ++s) buf[s * m + x] = v[s];
    }
    __syncthreads();
    dif_inplace(buf, tw, m, log2m);

    const size_t plane = static_cast<size_t>(n) * n;
    float4* out = reinterpret_cast<float4*>(scratch) + (c * plane + static_cast<size_t>(y) * n) * 2;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const size_t kx = static_cast<size_t>(split) * brev(i, log2m) + e;
        const float2 l0 = buf[i], l1 = buf[m + i], l2 = buf[2 * m + i], l3 = buf[3 * m + i];
        out[2 * kx] = make_float4(l0.x, l0.y, l1.x, l1.y);
        out[2 * kx + 1] = make_float4(l2.x, l2.y, l3.x, l3.y);
    }
}

__device__ __forceinline__ void load_record(const float4* col, size_t y, size_t n, float2* v) {
    const float4 a = col[y * n * 2];
    const float4 b = col[y * n * 2 + 1];
    v[0] = make_float2(a.x, a.y);
    v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(b.x, b.y);
    v[3] = make_float2(b.z, b.w);
}

template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
strip_cols_kernel(const float* __restrict__ scratch, const float* __restrict__ foam_in,
                  const float* __restrict__ scal, OutT* __restrict__ disp,
                  OutT* __restrict__ normal, float* __restrict__ foam_out,
                  int n, int split, int log2m, long long disp_cstride, long long norm_cstride) {
    extern __shared__ float2 smem[];
    const int m = n / split;
    float2* buf = smem;
    float2* tw = smem + kSeqs * m;
    const int kx = blockIdx.x / split;   // output row
    const int e = blockIdx.x % split;
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;
    const size_t plane = static_cast<size_t>(n) * n;

    fill_twiddles(tw, m);
    // column kx of cascade c: record y at col[y * n * 2]
    const float4* col = reinterpret_cast<const float4*>(scratch) + (c * plane + kx) * 2;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int y = brev(i, log2m);
        float2 v[kSeqs];
        load_record(col, y, n, v);
        if (split == 2) {
            float2 hi[kSeqs];
            load_record(col, y + m, n, hi);
#pragma unroll
            for (int s = 0; s < kSeqs; ++s) v[s] = split_stage(v[s], hi[s], e, y, n);
        }
#pragma unroll
        for (int s = 0; s < kSeqs; ++s) buf[s * m + i] = v[s];
    }
    __syncthreads();
    dit_inplace(buf, tw, m, log2m);

    const float whitecap = sc[S_WHITECAP];
    const float grow = sc[S_GROW];
    const float keep = expf(-sc[S_DECAY]);
    const size_t row = static_cast<size_t>(kx) * n;
    OutT* d = disp + c * disp_cstride + row;
    OutT* nm = normal + c * norm_cstride + row;
    const float* fi = foam_in + c * plane + row;
    float* fo = foam_out + c * plane + row;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
        const int mm = split * j + e;    // output column
        fo[mm] = texel::unpack<OutT>(buf[j], buf[m + j], buf[2 * m + j], buf[3 * m + j], kx, mm,
                                     fi[mm], keep, whitecap, grow, d, nm, plane);
    }
}

bool supported(int c, int n) {
    return c > 0 && c <= 65535 && n >= kMinN && n <= kMaxN && (n & (n - 1)) == 0;
}

template <typename OutT>
int launch_cols(const float* scratch, const float* foam_in, const float* scal, void* disp,
                void* normal, float* foam_out, int c, int n, long long disp_cstride,
                long long norm_cstride, cudaStream_t stream) {
    const int split = split_of(n), m = n / split;
    const size_t smem = smem_bytes(m);
    if (int rc = allow_smem(strip_cols_kernel<OutT>, smem)) return rc;
    strip_cols_kernel<OutT><<<dim3(n * split, c), threads_for(m), smem, stream>>>(
        scratch, foam_in, scal, static_cast<OutT*>(disp), static_cast<OutT*>(normal),
        foam_out, n, split, log2_of(m), disp_cstride, norm_cstride);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Row pass of the strip step for C cascades at N x N (2048 <= N <= 8192).
// scratch is (C, N, N, 8) fp32. Returns a cudaError_t.
int strip_step_rows(const float* h0, const float* h0nc, const float* omega, const float* scal,
                    float* scratch, int c, int n, void* stream) {
    if (!supported(c, n)) return static_cast<int>(cudaErrorInvalidValue);
    const int split = split_of(n), m = n / split;
    const size_t smem = smem_bytes(m);
    if (int rc = allow_smem(strip_rows_kernel, smem)) return rc;
    strip_rows_kernel<<<dim3(n * split, c), threads_for(m), smem,
                        static_cast<cudaStream_t>(stream)>>>(
        h0, h0nc, omega, scal, scratch, n, split, log2_of(m));
    return static_cast<int>(cudaGetLastError());
}

// Column pass + unpack + foam. `dtype`: 0 float32, 1 bfloat16, 2 float16.
// foam_in and foam_out must not overlap. The cascade strides of disp and
// normal are in elements. Returns a cudaError_t.
int strip_step_cols(const float* scratch, const float* foam_in, const float* scal, void* disp,
                    void* normal, float* foam_out, int c, int n, int dtype,
                    long long disp_cstride, long long norm_cstride, void* stream) {
    if (!supported(c, n)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_cols<float>(scratch, foam_in, scal, disp, normal, foam_out, c, n,
                                          disp_cstride, norm_cstride, s);
        case 1: return launch_cols<__nv_bfloat16>(scratch, foam_in, scal, disp, normal,
                                                  foam_out, c, n, disp_cstride, norm_cstride, s);
        case 2: return launch_cols<__half>(scratch, foam_in, scal, disp, normal, foam_out, c, n,
                                           disp_cstride, norm_cstride, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
