// 2D IFFT of (L, 2, N, N) fp32 planes for Hopper (sm_90a), 16 <= N <= 8192:
// the column pass. The row pass is the rows DFT kernel (rows_fft.cu).
//
// Replaces godotoceanwaves_tpu/ops/pallas_fft.py `ifft2_packed_planes_pallas`
// (the Pallas kernel `_ifft2_kernel`): the unnormalized positive-exponent
// rows -> transpose -> rows chain with no second transpose, so plane l of the
// output is transpose(N^2 ifft2(x_l)), times (-1)^(x+y) with fold_sign. It is
// the FFT of the staged step. Two launches over an fp32 intermediate, both on
// the register-resident Stockham core (stockham.cuh):
//
//   rows: rows_fft with tile = W. Transforms each row along x and stores
//         element (y, x) at record (x / W, y, x mod W) of the intermediate
//         (L, 2, N / W, N, W): a row's W consecutive columns are one 32-byte
//         record of each plane (W = 8), written whole, and the N records of
//         a column group are one contiguous run.
//   cols: this kernel. Block (C columns, plane l) reads its columns from the
//         records in natural y order, transforms them along y and writes
//         them as C rows of the output, Re and Im planes, with (-1)^(x+y).
//
// Thread t of column c holds points y = t + m N/16. The column pass loads
// with the column index fastest across the warp (consecutive words of the
// records, so a warp reads whole sectors), runs stage 0 in that mapping and
// the later stages, after the first exchange, with t fastest, so its stores
// are contiguous output rows. C = 256 / (N / 16) columns a block (one at
// N >= 4096, 512 threads at 8192) keeps the block at 256 threads and ~34 KB
// of shared memory (ops/fft_plan.py); below 8 columns a block reads part of
// each record, and the blocks of the neighbouring columns, which run at the
// same time, read the rest of its sectors from L2.
//
// Bound: device memory bandwidth, 16 bytes per element in and out. The pair
// moves 32 (planes in, intermediate out and back, planes out), so its
// floor through device memory is twice the bound unless the intermediate
// is read back from L2. Column reads in any order but the records' natural
// one would cost a scattered sector a lane; the records make them whole.
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace stockham;

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
planes_cols_kernel(const float* __restrict__ mid, float* __restrict__ out,
                   const float2* __restrict__ tw, int cols, int tile, int pitch, int fold_sign) {
    using Sh = Shape<LOG2N>;
    constexpr size_t kPlane = static_cast<size_t>(1) << (2 * LOG2N);
    extern __shared__ float smem[];
    const int x0 = blockIdx.x * cols;
    const size_t l0 = static_cast<size_t>(blockIdx.y) * 2 * kPlane;
    // stage 0: column fastest across the warp
    const int c0 = threadIdx.x % cols;
    const int t0 = threadIdx.x / cols;
    // later stages and the store: t fastest
    const int c1 = threadIdx.x >> Sh::kLog2T;
    const int t1 = threadIdx.x & (Sh::kT - 1);

    const int x = x0 + c0;
    const size_t run = l0 + (static_cast<size_t>(x / tile) << LOG2N) * tile + (x & (tile - 1));
    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        const size_t at = run + static_cast<size_t>(t0 + m * Sh::kT) * tile;
        v[m] = make_float2(mid[at], mid[at + kPlane]);
    }
    float* re0 = smem + c0 * pitch;
    float* re1 = smem + c1 * pitch;
    transform<LOG2N>(v, t0, re0, re0 + cols * pitch, t1, re1, re1 + cols * pitch, tw);

    const int row = x0 + c1;   // output row = the column transformed
    const size_t o = l0 + (static_cast<size_t>(row) << LOG2N) + t1;
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        const int k = t1 + m * Sh::kT;
        const float sign = (fold_sign && ((row + k) & 1)) ? -1.0f : 1.0f;
        out[o + m * Sh::kT] = v[m].x * sign;
        out[o + kPlane + m * Sh::kT] = v[m].y * sign;
    }
}

template <int LOG2N>
struct Launch {
    static int run(const float* mid, float* out, const float2* tw, int l, int fold_sign,
                   int cols, int pitch, int tile, long long smem, cudaStream_t stream) {
        if (int rc = allow_smem(planes_cols_kernel<LOG2N>, smem)) return rc;
        planes_cols_kernel<LOG2N><<<dim3((1 << LOG2N) / cols, l),
                                    cols << Shape<LOG2N>::kLog2T, smem, stream>>>(
            mid, out, tw, cols, tile, pitch, fold_sign);
        return static_cast<int>(cudaGetLastError());
    }
};

}  // namespace

extern "C" {

// Column pass: mid, the records (L, 2, N / tile, N, tile) that rows_fft
// stored, -> out (L, 2, N, N) fp32, times (-1)^(x+y) when fold_sign is
// non-zero. tw is the (N / 2) float2 table e^{+2 pi i j / N}; cols (a power
// of two dividing N) and pitch are the launch plan. Returns a cudaError_t.
int planes_fft_cols(const float* mid, float* out, const float* tw, int l, int n, int fold_sign,
                    int cols, int pitch, int tile, void* stream) {
    const int log2n = log2_exact(n);
    const long long smem = plan_smem(log2n, cols, pitch);
    if (l < 1 || l > 65535 || smem < 0 || cols > n || (cols & (cols - 1)) != 0
        || tile < 1 || tile > n || (tile & (tile - 1)) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<Launch>(log2n, mid, out, reinterpret_cast<const float2*>(tw), l, fold_sign,
                            cols, pitch, tile, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
