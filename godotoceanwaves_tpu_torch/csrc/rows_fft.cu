// Row DFT of (L, 2, R, N) fp32 planes for Hopper (sm_90a), 16 <= N <= 8192.
//
// Replaces godotoceanwaves_tpu/ops/pallas_fft.py `idft_rows_planes_pallas`
// (the Pallas kernel `_rows_tile_kernel`): the unnormalized positive-exponent
// DFT along the last axis, X[k] = sum_j x[j] e^{+2 pi i j k / N}, times
// (-1)^k with fold_sign. It is the shard-local pass of the row-sharded 2D
// IFFT (parallel/sharding.py): each mesh position transforms its R rows, the
// exchange transposes, and this kernel runs again. The same kernel is the
// row pass of the planes IFFT (planes_fft.cu), storing into that pass's
// intermediate of 32-byte column records (`tile` > 0).
//
// Bound: device memory bandwidth, 16 bytes per complex element (8 in, 8
// out); the FFT's 5 N log2 N flops a row are far below the card's fp32 rate.
// What keeps a shared-memory FFT from that bound on this card is the work
// between the loads and the stores: passes through shared memory that
// conflict on banks (a bit-reversed gather puts a warp on one bank), a
// block-wide barrier per pass, and twiddles computed per block. So a row is
// one pass of the register-resident Stockham core (stockham.cuh): thread t
// of a row loads elements t + m N/16 (4-byte words, contiguous across the
// warp), runs the radix-16 stages in registers with 1-3 conflict-free
// exchanges and table twiddles, and stores the same elements in natural
// order, fold_sign applied at the store. Rows past R load zeros and are not
// written; a block holds `seqs` rows (ops/fft_plan.py), and a row of up to
// 8192 points fits one block, so no row is split across blocks.
//
// Not carried over from the TPU kernel: its transpose - strip - transpose
// (T C T) form, the bf16 hi/lo Karatsuba matmul DFT, the sigma row un-swap,
// the 128-row and 128-lane alignment and the VMEM cap at N = 1024.
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace stockham;

// tile == 0: natural rows out. tile = W > 0: element (y, k) of plane l goes
// to the record layout (L, 2, N / W, N, W) of the planes IFFT.
template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
rows_fft_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float2* __restrict__ tw, int r, int seqs, int pitch, int fold_sign,
                int tile) {
    using Sh = Shape<LOG2N>;
    extern __shared__ float smem[];
    const int s = threadIdx.x >> Sh::kLog2T;
    const int t = threadIdx.x & (Sh::kT - 1);
    const int row = blockIdx.x * seqs + s;
    const bool live = row < r;
    const size_t plane = static_cast<size_t>(r) << LOG2N;
    const size_t at = static_cast<size_t>(blockIdx.y) * 2 * plane
                      + (static_cast<size_t>(live ? row : 0) << LOG2N) + t;

    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m)
        v[m] = live ? make_float2(x[at + m * Sh::kT], x[at + plane + m * Sh::kT])
                    : make_float2(0.0f, 0.0f);
    float* re = smem + s * pitch;
    float* im = re + seqs * pitch;
    transform<LOG2N>(v, t, re, im, t, re, im, tw);
    if (!live) return;

#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        const int k = t + m * Sh::kT;
        const float sign = (fold_sign && (k & 1)) ? -1.0f : 1.0f;
        size_t o = at + m * Sh::kT;
        if (tile) {   // (record k / W, row, k mod W) of plane l
            o = static_cast<size_t>(blockIdx.y) * 2 * plane
                + (static_cast<size_t>(k / tile) * r + row) * tile + (k & (tile - 1));
        }
        out[o] = v[m].x * sign;
        out[o + plane] = v[m].y * sign;
    }
}

template <int LOG2N>
struct Launch {
    static int run(const float* x, float* out, const float2* tw, int l, int r, int fold_sign,
                   int seqs, int pitch, int tile, long long smem, cudaStream_t stream) {
        if (int rc = allow_smem(rows_fft_kernel<LOG2N>, smem)) return rc;
        const int blocks = (r + seqs - 1) / seqs;
        rows_fft_kernel<LOG2N><<<dim3(blocks, l), seqs << Shape<LOG2N>::kLog2T, smem, stream>>>(
            x, out, tw, r, seqs, pitch, fold_sign, tile);
        return static_cast<int>(cudaGetLastError());
    }
};

}  // namespace

extern "C" {

// x (L, 2, R, N) fp32 -> out (L, 2, R, N) fp32 (tile == 0) or the records
// (L, 2, N / tile, R, tile) (tile a power of two <= N; R == N in the planes
// IFFT), times (-1)^k on output column k when fold_sign is non-zero. tw is
// the (N / 2) float2 table e^{+2 pi i j / N}; seqs and pitch are the launch
// plan (rows a block, words between rows in the exchange buffer). Returns a
// cudaError_t.
int rows_fft(const float* x, float* out, const float* tw, int l, int r, int n, int fold_sign,
             int seqs, int pitch, int tile, void* stream) {
    const int log2n = log2_exact(n);
    const long long smem = plan_smem(log2n, seqs, pitch);
    const bool tile_ok = tile == 0 || (tile > 0 && tile <= n && (tile & (tile - 1)) == 0);
    if (l < 1 || l > 65535 || r < 1 || smem < 0 || !tile_ok
        || (static_cast<long long>(r) + seqs - 1) / seqs > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<Launch>(log2n, x, out, reinterpret_cast<const float2*>(tw), l, r, fold_sign,
                            seqs, pitch, tile, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
