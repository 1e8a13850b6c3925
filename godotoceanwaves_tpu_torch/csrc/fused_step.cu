// Fused ocean step for Hopper (sm_90a): modulate -> 2D IFFT -> unpack + foam.
//
// Replaces godotoceanwaves_tpu/ops/pallas_step.py `_fused_call` (the Pallas
// kernel `_step_kernel` -> `_one_frame`). It is the planes IFFT's pair
// (rows_fft.cu + planes_fft.cu, K2) over the 4 packed layers of C cascades,
// with the modulation in front of the row pass and the unpack behind the
// column pass: the pass bodies of step_passes.cuh (see the design note
// there) at split 1, one transform length per N = 16..1024, on the
// register-resident Stockham core (stockham.cuh) with the twiddle table and
// launch plans of ops/fft_plan.py. The strip step (strip_step.cu) runs the
// same bodies for larger maps.
//
// Bound: device memory bandwidth. Per cascade-frame at 1024^2: 20 MB of
// spectra + omega in, 4 MB of foam in and 4 out, 14 MB of bf16 maps out
// (~44 MB, 0.013 ms at 3.35 TB/s), plus 32 MB of scratch written and read
// back.
//
// Accuracy: no fast math. omega * t reaches ~6.7e3 rad at 1024^2 (t ~ 126 s),
// so sincosf keeps its full range reduction.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "step_passes.cuh"

namespace {

constexpr int kStepMaxLog2N = 10;   // N <= 1024; larger maps are the strip step's (K4)

// The plan's shared bytes, or -1 if it does not fit the kernels.
long long fused_smem(int log2n, int lines, int pitch, int jpitch, int n) {
    return log2n > kStepMaxLog2N ? -1 : step_smem(log2n, lines, pitch, jpitch, n);
}

template <int LOG2N>
struct RowsLaunch {
    static int run(const float* h0, const float* h0nc, const float* omega, const float* scal,
                   const float2* tw, float* scratch, int c, int frame, int rows, int pitch,
                   int jpitch, long long smem, cudaStream_t stream) {
        if constexpr (LOG2N > kStepMaxLog2N) {
            return static_cast<int>(cudaErrorInvalidValue);
        } else {
            if (int rc = allow_smem(step_rows_kernel<LOG2N, 1>, smem)) return rc;
            step_rows_kernel<LOG2N, 1><<<dim3((1 << LOG2N) / rows, c),
                                         (rows * kLayers) << Shape<LOG2N>::kLog2T, smem, stream>>>(
                h0, h0nc, omega, scal, tw, tw, scratch, rows, pitch, jpitch, frame);
            return static_cast<int>(cudaGetLastError());
        }
    }
};

template <typename OutT>
struct ColsFor {
    template <int LOG2N>
    struct Launch {
        static int run(const float* scratch, const float* foam_in, const float* scal,
                       const float2* tw, void* disp, void* normal, float* foam_out, int c,
                       int cols, int pitch, int jpitch, long long disp_cstride,
                       long long norm_cstride, long long smem, cudaStream_t stream) {
            if constexpr (LOG2N > kStepMaxLog2N) {
                return static_cast<int>(cudaErrorInvalidValue);
            } else {
                if (int rc = allow_smem(step_cols_kernel<LOG2N, 1, OutT>, smem)) return rc;
                step_cols_kernel<LOG2N, 1, OutT><<<dim3((1 << LOG2N) / cols, c),
                                                   (cols * kLayers) << Shape<LOG2N>::kLog2T, smem,
                                                   stream>>>(
                    scratch, foam_in, scal, tw, tw, static_cast<OutT*>(disp),
                    static_cast<OutT*>(normal), foam_out, cols, pitch, jpitch, disp_cstride,
                    norm_cstride);
                return static_cast<int>(cudaGetLastError());
            }
        }
    };
};

}  // namespace

extern "C" {

// Row pass for frame `frame` of C cascades at N x N: h0/h0nc (C, 2, N, N),
// omega (C, N, N) and the scalar rows in, the scratch of texel records
// (C, N, N, 8) out. tw is the (N / 2) float2 table
// e^{+2 pi i j / N}; rows (a power of two dividing N), pitch and jpitch
// (>= N) are the launch plan (ops/fft_plan.py step_rows_plan). Returns a
// cudaError_t.
int fused_step_rows(const float* h0, const float* h0nc, const float* omega, const float* scal,
                    const float* tw, float* scratch, int c, int n, int frame, int rows,
                    int pitch, int jpitch, void* stream) {
    const int log2n = log2_exact(n);
    const long long smem = fused_smem(log2n, rows, pitch, jpitch, n);
    if (c < 1 || c > 65535 || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<RowsLaunch>(log2n, h0, h0nc, omega, scal, reinterpret_cast<const float2*>(tw),
                                scratch, c, frame, rows, pitch, jpitch, smem,
                                static_cast<cudaStream_t>(stream));
}

// Column pass + unpack + foam. `dtype`: 0 float32, 1 bfloat16, 2 float16.
// disp / normal point at cascade 0 of this frame; the cascade strides are in
// elements. cols (a power of two dividing N), pitch and jpitch (>= N) are
// the launch plan (ops/fft_plan.py step_cols_plan). Returns a cudaError_t.
int fused_step_cols(const float* scratch, const float* foam_in, const float* scal,
                    const float* tw, void* disp, void* normal, float* foam_out, int c, int n,
                    int dtype, long long disp_cstride, long long norm_cstride, int cols,
                    int pitch, int jpitch, void* stream) {
    const int log2n = log2_exact(n);
    const long long smem = fused_smem(log2n, cols, pitch, jpitch, n);
    if (c < 1 || c > 65535 || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* w = reinterpret_cast<const float2*>(tw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return dispatch<ColsFor<float>::Launch>(log2n, scratch, foam_in, scal, w, disp, normal,
                                                    foam_out, c, cols, pitch, jpitch,
                                                    disp_cstride, norm_cstride, smem, s);
        case 1:
            return dispatch<ColsFor<__nv_bfloat16>::Launch>(
                log2n, scratch, foam_in, scal, w, disp, normal, foam_out, c, cols, pitch, jpitch,
                disp_cstride, norm_cstride, smem, s);
        case 2:
            return dispatch<ColsFor<__half>::Launch>(log2n, scratch, foam_in, scal, w, disp,
                                                     normal, foam_out, c, cols, pitch, jpitch,
                                                     disp_cstride, norm_cstride, smem, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
