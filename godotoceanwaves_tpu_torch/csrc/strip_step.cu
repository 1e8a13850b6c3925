// Strip step for Hopper (sm_90a): the fused ocean step for N = 2048, 4096
// and 8192.
//
// Replaces godotoceanwaves_tpu/ops/pallas_strip.py `strip_cascade_step` (the
// Pallas kernels `_pass1_kernel` and `_pass2_kernel`). Same chain as
// fused_step.cu (modulate -> 2D IFFT, sign folded -> unpack + foam), in the
// same two passes with the (C, N, N, 8) fp32 scratch of texel records
// between them: the pass bodies of step_passes.cuh (see the design note
// there) on the register-resident Stockham core, with the output-parity
// split. S blocks share each row (and each column), block e summing the
// line's S parts by quarter turns while it loads, multiplying by w_N^(e j)
// from the N-point table, and transforming M = N / S points into the
// outputs S k + e. So every block still holds all 4 layers of its texels,
// and the column pass's join and unpack are K1's:
//
//   N = 2048: M = 1024, S = 2, blocks of 4 x 64 threads;
//   N = 4096: M = 2048, S = 2, blocks of 4 x 128 threads;
//   N = 8192: M = 2048, S = 4 (a 4096-point sequence would not fit a block).
//
// At 2048 the split is a choice: one 512-thread block a line (S = 1) would
// modulate each texel once and read each record once, but the 256-thread
// blocks of S = 2 measured faster on the card (ops/fft_plan.py
// strip_length), as 256-thread blocks did for K1.
//
// Bound: device memory bandwidth. Per cascade-frame at 2048^2: 84 MB of
// spectra + omega in, 34 MB of foam in and out, 59 MB of bf16 maps out
// (~176 MB), plus 134 MB of scratch written and 134 MB read back. What the
// split adds: each of a row's S blocks modulates the whole row (S sincosf a
// texel); each column block reads S records a point (the repeats from L2);
// and block e stores map columns S k + e, every S-th element of an output
// row (partial sectors of the maps and of foam, merged in L2).
//
// Accuracy: no fast math. omega * t reaches ~7.6e3 rad at 8192 on a 64 m
// tile, so sincosf keeps its full range reduction; the phase and the
// wavenumbers are rounded as the plain version rounds them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "step_passes.cuh"

namespace {

// The row pass's launch bounds: at 2048, blocks of 256 threads capped at 48
// registers, 5 an SM (68 bytes of spill stores and 100 of loads, ptxas),
// which measured faster than 4 at 64; above, the default 512 threads and 2
// blocks. The column pass keeps the default (at 48 registers it spills and
// slows down).
template <int LOG2M>
constexpr int kRowThreads = LOG2M == 10 ? 256 : kMaxThreads;
template <int LOG2M>
constexpr int kRowBlocks = LOG2M == 10 ? 5 : kMinBlocks;

struct Rows {
    template <int LOG2M, int SPLIT>
    static int launch(const float* h0, const float* h0nc, const float* omega, const float* scal,
                      const float2* tw, const float2* twn, float* scratch, int c, int n,
                      int rows, int pitch, int jpitch, cudaStream_t stream) {
        const auto kernel = step_rows_kernel<LOG2M, SPLIT, kRowThreads<LOG2M>, kRowBlocks<LOG2M>>;
        const int threads = (rows * kLayers) << Shape<LOG2M>::kLog2T;
        const long long smem = step_smem(LOG2M, rows, pitch, jpitch, n);
        if (smem < 0 || threads > kRowThreads<LOG2M>)
            return static_cast<int>(cudaErrorInvalidValue);
        if (int rc = allow_smem(kernel, smem)) return rc;
        kernel<<<dim3(n / rows * SPLIT, c), threads, smem, stream>>>(
            h0, h0nc, omega, scal, tw, twn, scratch, rows, pitch, jpitch, 0);
        return static_cast<int>(cudaGetLastError());
    }
};

template <typename OutT>
struct Cols {
    template <int LOG2M, int SPLIT>
    static int launch(const float* scratch, const float* foam_in, const float* scal,
                      const float2* tw, const float2* twn, void* disp, void* normal,
                      float* foam_out, int c, int n, int cols, int pitch, int jpitch,
                      long long disp_cstride, long long norm_cstride, cudaStream_t stream) {
        const long long smem = step_smem(LOG2M, cols, pitch, jpitch, n);
        if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
        if (int rc = allow_smem(step_cols_kernel<LOG2M, SPLIT, OutT>, smem)) return rc;
        step_cols_kernel<LOG2M, SPLIT, OutT><<<dim3(n / cols * SPLIT, c),
                                               (cols * kLayers) << Shape<LOG2M>::kLog2T, smem,
                                               stream>>>(
            scratch, foam_in, scal, tw, twn, static_cast<OutT*>(disp),
            static_cast<OutT*>(normal), foam_out, cols, pitch, jpitch, disp_cstride,
            norm_cstride);
        return static_cast<int>(cudaGetLastError());
    }
};

// Pass::launch<LOG2M, SPLIT>(args...) at the instantiation of N: the
// transform length of ops/fft_plan.py strip_length and its split.
template <typename Pass, typename... Args>
int of_size(int n, Args... args) {
    switch (n) {
        case 2048: return Pass::template launch<10, 2>(args...);
        case 4096: return Pass::template launch<11, 2>(args...);
        case 8192: return Pass::template launch<11, 4>(args...);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// Row pass of the strip step for C cascades at N x N (N = 2048, 4096 or
// 8192): h0/h0nc (C, 2, N, N), omega (C, N, N) and the scalar rows in, the
// scratch of texel records (C, N, N, 8) fp32 out. tw is the (M / 2) float2
// table e^{+2 pi i j / M} of the transform length M, twn the (N / 2) table
// e^{+2 pi i j / N} of the split; rows (a power of two dividing N), pitch
// and jpitch (>= M) are the launch plan (ops/fft_plan.py strip_rows_plan).
// Returns a cudaError_t.
int strip_step_rows(const float* h0, const float* h0nc, const float* omega, const float* scal,
                    const float* tw, const float* twn, float* scratch, int c, int n, int rows,
                    int pitch, int jpitch, void* stream) {
    if (c < 1 || c > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return of_size<Rows>(n, h0, h0nc, omega, scal, reinterpret_cast<const float2*>(tw),
                         reinterpret_cast<const float2*>(twn), scratch, c, n, rows, pitch, jpitch,
                         static_cast<cudaStream_t>(stream));
}

// Column pass + unpack + foam. `dtype`: 0 float32, 1 bfloat16, 2 float16.
// disp / normal point at cascade 0; the cascade strides are in elements.
// foam_in may alias foam_out. tw, twn as for the row pass; cols, pitch and
// jpitch are the launch plan (ops/fft_plan.py strip_cols_plan). Returns a
// cudaError_t.
int strip_step_cols(const float* scratch, const float* foam_in, const float* scal,
                    const float* tw, const float* twn, void* disp, void* normal, float* foam_out,
                    int c, int n, int dtype, long long disp_cstride, long long norm_cstride,
                    int cols, int pitch, int jpitch, void* stream) {
    if (c < 1 || c > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const auto* w = reinterpret_cast<const float2*>(tw);
    const auto* wn = reinterpret_cast<const float2*>(twn);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return of_size<Cols<float>>(n, scratch, foam_in, scal, w, wn, disp, normal, foam_out,
                                        c, n, cols, pitch, jpitch, disp_cstride, norm_cstride,
                                        s);
        case 1:
            return of_size<Cols<__nv_bfloat16>>(n, scratch, foam_in, scal, w, wn, disp, normal,
                                                foam_out, c, n, cols, pitch, jpitch,
                                                disp_cstride, norm_cstride, s);
        case 2:
            return of_size<Cols<__half>>(n, scratch, foam_in, scal, w, wn, disp, normal,
                                         foam_out, c, n, cols, pitch, jpitch, disp_cstride,
                                         norm_cstride, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
