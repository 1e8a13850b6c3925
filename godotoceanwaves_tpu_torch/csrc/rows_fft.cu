// Row DFT of (L, 2, R, N) fp32 planes for Hopper (sm_90a), 16 <= N <= 8192.
//
// Replaces godotoceanwaves_tpu/ops/pallas_fft.py `idft_rows_planes_pallas`
// (the Pallas kernel `_rows_tile_kernel`): the unnormalized positive-exponent
// DFT along the last axis, X[k] = sum_j x[j] e^{+2 pi i j k / N}, times
// (-1)^k with fold_sign. It is the shard-local pass of the row-sharded 2D
// IFFT (parallel/sharding.py): each mesh position transforms its R rows, the
// exchange transposes, and this kernel runs again.
//
// One pass on the in-place FFT core (radix2.cuh), as the row pass of the
// planes IFFT (planes_fft.cu) is: block (kSeqs rows, parity e) x plane l
// reads the Re and Im rows (contiguous), transforms them in shared memory
// (decimation in frequency, bit-reversed order), and writes natural order,
// output k <- buf[brev(k)], to the Re and Im rows of the output plane. The
// bit reversal sits on the shared-memory side; both global sides are
// coalesced. Rows past R (R need not be a multiple of kSeqs) load zeros and
// are not written. At N = 8192 two blocks share a row, one per output
// parity (split_stage).
//
// Bound: device memory bandwidth, 16 bytes per complex element (8 in, 8
// out); the FFT's 5 N log2 N flops a row are far below the card's fp32 rate.
//
// Not carried over from the TPU kernel: its transpose - strip - transpose
// (T C T) form, the bf16 hi/lo Karatsuba matmul DFT, the sigma row un-swap,
// the 128-row and 128-lane alignment and the VMEM cap at N = 1024.
#include <cuda_runtime.h>

#include "radix2.cuh"

namespace {

using namespace radix2;

constexpr int kMinN = 16;
constexpr int kMaxN = 8192;

__global__ void __launch_bounds__(kMaxThreads)
rows_fft_kernel(const float* __restrict__ x, float* __restrict__ out, int r, int n, int split,
                int log2m, int fold_sign) {
    extern __shared__ float2 smem[];
    const int m = n / split;
    float2* buf = smem;                 // kSeqs rows of m
    float2* tw = smem + kSeqs * m;      // m / 2
    const int row0 = kSeqs * (blockIdx.x / split);
    const int e = blockIdx.x % split;
    const size_t l = blockIdx.y;
    const size_t plane = static_cast<size_t>(r) * n;
    const float* re = x + l * 2 * plane;
    const float* im = re + plane;

    fill_twiddles(tw, m);
    for (int q = threadIdx.x; q < kSeqs * m; q += blockDim.x) {
        const int row = row0 + (q >> log2m);
        const int j = q & (m - 1);
        float2 v = make_float2(0.0f, 0.0f);
        if (row < r) {
            const size_t at = static_cast<size_t>(row) * n + j;
            v = make_float2(re[at], im[at]);
            if (split == 2) v = split_stage(v, make_float2(re[at + m], im[at + m]), e, j, n);
        }
        buf[q] = v;
    }
    __syncthreads();
    dif_inplace(buf, tw, m, log2m);

    float* o_re = out + l * 2 * plane;
    float* o_im = o_re + plane;
    for (int q = threadIdx.x; q < kSeqs * m; q += blockDim.x) {
        const int s = q >> log2m;
        const int row = row0 + s;
        if (row >= r) continue;
        const int kk = q & (m - 1);
        const int k = split * kk + e;                       // output column
        const float sign = (fold_sign && (k & 1)) ? -1.0f : 1.0f;
        const float2 v = buf[s * m + brev(kk, log2m)];
        const size_t at = static_cast<size_t>(row) * n + k;
        o_re[at] = v.x * sign;
        o_im[at] = v.y * sign;
    }
}

bool supported(int l, int r, int n) {
    return l > 0 && l <= 65535 && r > 0 && n >= kMinN && n <= kMaxN && (n & (n - 1)) == 0
           && (static_cast<long long>(r) + kSeqs - 1) / kSeqs * split_of(n) <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// x (L, 2, R, N) fp32 -> out (L, 2, R, N) fp32, times (-1)^k on output
// column k when fold_sign is non-zero. Returns a cudaError_t.
int rows_fft(const float* x, float* out, int l, int r, int n, int fold_sign, void* stream) {
    if (!supported(l, r, n)) return static_cast<int>(cudaErrorInvalidValue);
    const int split = split_of(n), m = n / split;
    const size_t smem = smem_bytes(m);
    if (int rc = allow_smem(rows_fft_kernel, smem)) return rc;
    const int groups = (r + kSeqs - 1) / kSeqs;
    rows_fft_kernel<<<dim3(groups * split, l), threads_for(m), smem,
                      static_cast<cudaStream_t>(stream)>>>(x, out, r, n, split, log2_of(m),
                                                           fold_sign);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
