// 2D IFFT of (L, 2, N, N) fp32 planes for Hopper (sm_90a), 16 <= N <= 8192.
//
// Replaces godotoceanwaves_tpu/ops/pallas_fft.py `ifft2_packed_planes_pallas`
// (the Pallas kernel `_ifft2_kernel`): the unnormalized positive-exponent
// rows -> transpose -> rows chain with no second transpose, so plane l of the
// output is transpose(N^2 ifft2(x_l)), times (-1)^(x+y) with fold_sign. It is
// the FFT of the staged step. Two passes over an fp32 scratch, with the FFT
// core of the strip step (radix2.cuh) and no prologue or epilogue:
//
//   rows: block (4 rows, parity e) x plane l. Reads the Re and Im rows
//         (contiguous), transforms along x in place (decimation in frequency,
//         bit-reversed output).
//   cols: block (column group G, parity e) x plane l. Transforms 4 columns
//         along y in place (decimation in time, natural output) and writes
//         them as 4 output rows, Re and Im planes, coalesced along m.
//
// The column reads are the hard part: a column of one plane is one 4-byte
// word per 4 N-byte stride. The scratch is therefore laid out
// (L, N/4, N, 4) complex: the 4 columns of group G at row y are one 32-byte
// record, and a group's records for all y are one contiguous N * 32-byte
// run. Thread i of the row pass holds outputs kx = brev(i) + {0, 2, 1, 3}
// (scaled by the split), which are exactly one group's 4 columns, so it
// writes whole records; the column pass reads whole records.
//
// Bound: device memory bandwidth. Per plane: 8 N^2 bytes in, 8 N^2 of
// scratch written and read back, 8 N^2 out (32 bytes per element). At
// N = 8192 two blocks share each row and column, as in strip_step.cu.
#include <cuda_runtime.h>

#include "radix2.cuh"

namespace {

using namespace radix2;

constexpr int kMinN = 16;
constexpr int kMaxN = 8192;

__global__ void __launch_bounds__(kMaxThreads)
planes_rows_kernel(const float* __restrict__ x, float* __restrict__ scratch,
                   int n, int split, int log2m) {
    extern __shared__ float2 smem[];
    const int m = n / split;
    float2* buf = smem;                 // kSeqs rows of m
    float2* tw = smem + kSeqs * m;      // m / 2
    const int g = blockIdx.x / split;   // rows 4 g .. 4 g + 3
    const int e = blockIdx.x % split;
    const size_t l = blockIdx.y;
    const size_t plane = static_cast<size_t>(n) * n;
    const float* re = x + l * 2 * plane + static_cast<size_t>(kSeqs) * g * n;
    const float* im = re + plane;

    fill_twiddles(tw, m);
    for (int q = threadIdx.x; q < kSeqs * m; q += blockDim.x) {
        const int j = q & (m - 1);
        const size_t at = static_cast<size_t>(q >> log2m) * n + j;
        float2 v = make_float2(re[at], im[at]);
        if (split == 2) v = split_stage(v, make_float2(re[at + m], im[at + m]), e, j, n);
        buf[q] = v;
    }
    __syncthreads();
    dif_inplace(buf, tw, m, log2m);

    // Record (l, G, y) holds columns split * (4 (G / split) + r) + G % split,
    // r = 0..3. Position i + {0, m/2, m/4, 3m/4} of a row holds output
    // column split * (brev(i) + {0, 1, 2, 3}) + e.
    float4* out = reinterpret_cast<float4*>(scratch) + l * plane / 2;
    const int quarter = m >> 2;
    for (int q = threadIdx.x; q < kSeqs * quarter; q += blockDim.x) {
        const int s = q / quarter;
        const int i = q - s * quarter;
        const size_t group = static_cast<size_t>(split) * (brev(i, log2m) >> 2) + e;
        const size_t y = static_cast<size_t>(kSeqs) * g + s;
        const float2* row = buf + s * m;
        const float2 r0 = row[i], r1 = row[i + 2 * quarter];
        const float2 r2 = row[i + quarter], r3 = row[i + 3 * quarter];
        float4* rec = out + (group * n + y) * 2;
        rec[0] = make_float4(r0.x, r0.y, r1.x, r1.y);
        rec[1] = make_float4(r2.x, r2.y, r3.x, r3.y);
    }
}

__global__ void __launch_bounds__(kMaxThreads)
planes_cols_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                   int n, int split, int log2m, int fold_sign) {
    extern __shared__ float2 smem[];
    const int m = n / split;
    float2* buf = smem;                 // kSeqs columns of m
    float2* tw = smem + kSeqs * m;
    const int group = blockIdx.x / split;
    const int e = blockIdx.x % split;
    const size_t l = blockIdx.y;
    const size_t plane = static_cast<size_t>(n) * n;
    const float4* run = reinterpret_cast<const float4*>(scratch) + l * plane / 2
                        + static_cast<size_t>(group) * n * 2;

    fill_twiddles(tw, m);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int y = brev(i, log2m);
        float4 a = run[2 * y], b = run[2 * y + 1];
        float2 v[kSeqs] = {make_float2(a.x, a.y), make_float2(a.z, a.w),
                           make_float2(b.x, b.y), make_float2(b.z, b.w)};
        if (split == 2) {
            a = run[2 * (y + m)];
            b = run[2 * (y + m) + 1];
            const float2 hi[kSeqs] = {make_float2(a.x, a.y), make_float2(a.z, a.w),
                                      make_float2(b.x, b.y), make_float2(b.z, b.w)};
#pragma unroll
            for (int s = 0; s < kSeqs; ++s) v[s] = split_stage(v[s], hi[s], e, y, n);
        }
#pragma unroll
        for (int s = 0; s < kSeqs; ++s) buf[s * m + i] = v[s];
    }
    __syncthreads();
    dit_inplace(buf, tw, m, log2m);

    float* o_re = out + l * 2 * plane;
    float* o_im = o_re + plane;
    const int first = split * kSeqs * (group / split) + group % split;
    for (int q = threadIdx.x; q < kSeqs * m; q += blockDim.x) {
        const int kx = first + split * (q >> log2m);     // output row
        const int col = split * (q & (m - 1)) + e;      // output column
        const float sign = (fold_sign && ((kx + col) & 1)) ? -1.0f : 1.0f;
        const float2 v = buf[q];
        const size_t at = static_cast<size_t>(kx) * n + col;
        o_re[at] = v.x * sign;
        o_im[at] = v.y * sign;
    }
}

bool supported(int l, int n) {
    return l > 0 && l <= 65535 && n >= kMinN && n <= kMaxN && (n & (n - 1)) == 0;
}

}  // namespace

extern "C" {

// Row pass: x (L, 2, N, N) fp32 -> scratch (L, N/4, N, 4, 2) fp32. Returns a cudaError_t.
int planes_fft_rows(const float* x, float* scratch, int l, int n, void* stream) {
    if (!supported(l, n)) return static_cast<int>(cudaErrorInvalidValue);
    const int split = split_of(n), m = n / split;
    const size_t smem = smem_bytes(m);
    if (int rc = allow_smem(planes_rows_kernel, smem)) return rc;
    planes_rows_kernel<<<dim3(n / kSeqs * split, l), threads_for(m), smem,
                         static_cast<cudaStream_t>(stream)>>>(x, scratch, n, split, log2_of(m));
    return static_cast<int>(cudaGetLastError());
}

// Column pass: scratch -> out (L, 2, N, N) fp32, times (-1)^(x+y) when
// fold_sign is non-zero. Returns a cudaError_t.
int planes_fft_cols(const float* scratch, float* out, int l, int n, int fold_sign, void* stream) {
    if (!supported(l, n)) return static_cast<int>(cudaErrorInvalidValue);
    const int split = split_of(n), m = n / split;
    const size_t smem = smem_bytes(m);
    if (int rc = allow_smem(planes_cols_kernel, smem)) return rc;
    planes_cols_kernel<<<dim3(n / kSeqs * split, l), threads_for(m), smem,
                         static_cast<cudaStream_t>(stream)>>>(scratch, out, n, split,
                                                              log2_of(m), fold_sign);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
