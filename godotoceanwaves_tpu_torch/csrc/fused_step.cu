// Fused ocean step for Hopper (sm_90a): modulate -> 2D IFFT -> unpack + foam.
//
// Replaces godotoceanwaves_tpu/ops/pallas_step.py `_fused_call` (the Pallas
// kernel `_step_kernel` -> `_one_frame`). It is the planes IFFT's pair
// (rows_fft.cu + planes_fft.cu, K2) over the 4 packed layers of C cascades,
// with the modulation in front of the row pass and the unpack behind the
// column pass. Both passes run on the register-resident Stockham core
// (stockham.cuh): a sequence of N points is held by N/16 threads, 16 points
// a thread, radix-16 stages in registers, conflict-free exchanges, twiddles
// from the wrapper's table (ops/fft_plan.py, which also chooses the launch
// plans). Two kernels, launched back to back on the caller's stream:
//
//   rows: block (R rows, cascade c), 4 sequences a row: sequence s is layer
//         s mod 4 of row s / 4. Prologue: each texel of the block's rows is
//         modulated once (phase = omega * t in fp32, accurate sincosf), 4
//         texels a thread, and its 4 layers go through shared memory to the
//         threads of their sequences (thread t holds x = t + m N/16). After
//         the transform along x, a join through shared memory: each thread
//         gathers half-records, so that the 4 layers of texel (y, k) leave
//         as one 32-byte record of the scratch (C, N, N, 8) fp32 and a warp
//         stores 512 contiguous bytes.
//   cols: block (C columns, cascade c), 4 sequences a column. Stage 0 loads
//         with the sequence fastest across the warp, so the 4 lanes of a
//         column read each record whole; the later stages run t fastest.
//         The transform along y of column kx is OUTPUT ROW kx (the
//         reference's rows -> transpose -> rows chain with no second
//         transpose). The join: each thread writes its layer's 16 outputs
//         to shared memory (reusing the exchange buffer), and after a
//         barrier unpacks a quarter of its column's outputs,
//         m = t + (layer + 4 j) N/16, from all 4 layers: consecutive lanes
//         hold consecutive m, so the map and foam accesses stay contiguous.
//         Epilogue: (-1)^(kx+m) ifftshift (once, in texel::unpack),
//         displacement, normal from fp32 gradients (rounded once), fp32
//         foam recurrence. The thread that reads foam_in[m] writes
//         foam_out[m], so the two may alias.
//
// Bound: device memory bandwidth. Per cascade-frame at 1024^2: 20 MB of
// spectra + omega in, 4 MB of foam in and 4 out, 14 MB of bf16 maps out
// (~44 MB, 0.013 ms at 3.35 TB/s), plus 32 MB of scratch written and read
// back, which the two-pass form pays so that no block holds a whole layer.
// What keeps a shared-memory FFT from that bound is the work between its
// loads and its stores: passes through shared memory with their barriers
// and bank conflicts, and twiddles computed per block. The Stockham core
// needs 1-2 conflict-free exchanges and reads a float64-built table. What
// remains is the modulation (one sincosf, a square root and four divisions
// a texel) and the joins' barriers and shared-memory round trips, which a
// block runs between its loads and its stores; at 64 registers a thread an
// SM holds 1024 threads of either pass to hide them.
//
// Accuracy: no fast math. omega * t reaches ~6.7e3 rad at 1024^2 (t ~ 126 s),
// so sincosf keeps its full range reduction.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "stockham.cuh"
#include "texel.cuh"

namespace {

using namespace stockham;
using texel::kLayers;
using texel::NUM_SCALARS;
using texel::S_DECAY;
using texel::S_DT;
using texel::S_GROW;
using texel::S_TIME;
using texel::S_WHITECAP;
constexpr int kStepMaxLog2N = 10;   // N <= 1024; larger maps are the strip step's (K4)

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
step_rows_kernel(const float* __restrict__ h0, const float* __restrict__ h0nc,
                 const float* __restrict__ omega, const float* __restrict__ scal,
                 const float2* __restrict__ tw, float* __restrict__ scratch, int rows,
                 int pitch, int jpitch, int frame) {
    using Sh = Shape<LOG2N>;
    constexpr int kN = 1 << LOG2N;
    extern __shared__ float smem[];
    const int seqs = rows * kLayers;
    const int y0 = blockIdx.x * rows;
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;
    // frame k modulates at S_TIME + k * S_DT, rounded as two fp32 ops
    const float time = __fadd_rn(sc[S_TIME], __fmul_rn(static_cast<float>(frame), sc[S_DT]));

    // Prologue: the block's rows x N texels, 4 a thread, each modulated
    // once; layer l of texel (y0 + r, x) goes to word x of sequence
    // 4 r + l in the buffer that the exchanges use later.
    float* jre = smem;
    float* jim = smem + seqs * jpitch;
#pragma unroll
    for (int j = 0; j < kPoints / kLayers; ++j) {
        const int q = threadIdx.x + j * blockDim.x;
        const int r = q >> LOG2N;
        const int x = q & (kN - 1);
        const texel::Row row = texel::row_at(h0, h0nc, omega, sc, c, y0 + r, kN, time);
        float2 lay[kLayers];
        texel::modulate(row, x, lay);
#pragma unroll
        for (int l = 0; l < kLayers; ++l) {
            jre[(r * kLayers + l) * jpitch + x] = lay[l].x;
            jim[(r * kLayers + l) * jpitch + x] = lay[l].y;
        }
    }
    __syncthreads();
    const int s = threadIdx.x >> Sh::kLog2T;
    const int t = threadIdx.x & (Sh::kT - 1);
    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m)
        v[m] = make_float2(jre[s * jpitch + t + m * Sh::kT], jim[s * jpitch + t + m * Sh::kT]);
    __syncthreads();   // the exchanges reuse the buffer
    float* re = smem + s * pitch;
    float* im = re + seqs * pitch;
    transform<LOG2N>(v, t, re, im, t, re, im, tw);

    // The join: the sequences' outputs back to the buffer, then each half
    // of a texel record (layers 2h and 2h + 1 of texel (y0 + r, k), 16
    // bytes) is one thread's, so that a warp stores 512 contiguous bytes.
    __syncthreads();   // every thread has read the last exchange
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        jre[s * jpitch + t + m * Sh::kT] = v[m].x;
        jim[s * jpitch + t + m * Sh::kT] = v[m].y;
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(scratch)
                  + ((static_cast<size_t>(c) << LOG2N) + y0) * (2 << LOG2N);
#pragma unroll
    for (int u = 0; u < 2 * kPoints / kLayers; ++u) {
        const int slot = threadIdx.x + u * blockDim.x;
        const int q = slot >> 1;
        const int w0 = ((q >> LOG2N) * kLayers + (slot & 1) * 2) * jpitch + (q & (kN - 1));
        const int w1 = w0 + jpitch;
        out[slot] = make_float4(jre[w0], jim[w0], jre[w1], jim[w1]);
    }
}

template <int LOG2N, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
step_cols_kernel(const float* __restrict__ scratch,
                 const float* foam_in,     // may alias foam_out
                 const float* __restrict__ scal, const float2* __restrict__ tw,
                 OutT* __restrict__ disp, OutT* __restrict__ normal, float* foam_out, int cols,
                 int pitch, int jpitch, long long disp_cstride, long long norm_cstride) {
    using Sh = Shape<LOG2N>;
    constexpr size_t kPlane = static_cast<size_t>(1) << (2 * LOG2N);
    extern __shared__ float smem[];
    const int seqs = cols * kLayers;
    const int x0 = blockIdx.x * cols;
    const int c = blockIdx.y;
    // stage 0: sequence (column s / 4, layer s mod 4) fastest across the warp
    const int s0 = threadIdx.x % seqs;
    const int t0 = threadIdx.x / seqs;
    // later stages, the join and the epilogue: t fastest
    const int s1 = threadIdx.x >> Sh::kLog2T;
    const int t1 = threadIdx.x & (Sh::kT - 1);

    float2 v[kPoints];
    {
        // layer `layer` of texel (y, x): word pair `layer` of record (c, y, x)
        const int layer = s0 % kLayers;
        const int x = x0 + s0 / kLayers;
        const float2* run = reinterpret_cast<const float2*>(scratch)
                            + ((static_cast<size_t>(c) << (2 * LOG2N)) + x) * kLayers + layer;
#pragma unroll
        for (int m = 0; m < kPoints; ++m)
            v[m] = run[static_cast<size_t>(t0 + m * Sh::kT) << (LOG2N + 2)];
    }
    float* re0 = smem + s0 * pitch;
    float* re1 = smem + s1 * pitch;
    transform<LOG2N>(v, t0, re0, re0 + seqs * pitch, t1, re1, re1 + seqs * pitch, tw);

    // the join: layer outputs t1 + m T of every sequence in shared memory
    __syncthreads();   // every thread has read the last exchange
    float* jre = smem;
    float* jim = smem + seqs * jpitch;
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        jre[s1 * jpitch + t1 + m * Sh::kT] = v[m].x;
        jim[s1 * jpitch + t1 + m * Sh::kT] = v[m].y;
    }
    __syncthreads();

    const int layer = s1 % kLayers;
    const int col = s1 / kLayers;
    const int kx = x0 + col;   // output row
    const float* sc = scal + c * NUM_SCALARS;
    const float whitecap = sc[S_WHITECAP];
    const float grow = sc[S_GROW];
    const float keep = expf(-sc[S_DECAY]);
    const size_t row = static_cast<size_t>(kx) << LOG2N;
    OutT* d = disp + c * disp_cstride + row;
    OutT* nm = normal + c * norm_cstride + row;
    const float* fi = foam_in + c * kPlane + row;
    float* fo = foam_out + c * kPlane + row;
#pragma unroll
    for (int j = 0; j < kPoints / kLayers; ++j) {
        const int m = t1 + (layer + kLayers * j) * Sh::kT;
        float2 l[kLayers];
#pragma unroll
        for (int q = 0; q < kLayers; ++q) {
            const int w = (col * kLayers + q) * jpitch + m;
            l[q] = make_float2(jre[w], jim[w]);
        }
        // the thread that reads fi[m] writes fo[m]: in place is safe
        fo[m] = texel::unpack<OutT>(l[0], l[1], l[2], l[3], kx, m, fi[m], keep, whitecap, grow,
                                    d, nm, kPlane);
    }
}

// The dynamic shared bytes of a plan (the exchange buffer, or the join
// buffer where that is larger), or -1 if it does not fit the kernels.
long long step_smem(int log2n, int lines, int pitch, int jpitch, int n) {
    if (log2n < kMinLog2N || log2n > kStepMaxLog2N || lines < 1 || lines > n
        || (lines & (lines - 1)) != 0 || jpitch < 0)
        return -1;
    const int seqs = lines * kLayers;
    const long long exchange = plan_smem(log2n, seqs, pitch);
    const long long join = 2LL * seqs * jpitch * sizeof(float);
    if (exchange < 0) return -1;
    const long long bytes = exchange > join ? exchange : join;
    return bytes > 232448 ? -1 : bytes;
}

template <int LOG2N>
struct RowsLaunch {
    static int run(const float* h0, const float* h0nc, const float* omega, const float* scal,
                   const float2* tw, float* scratch, int c, int frame, int rows, int pitch,
                   int jpitch, long long smem, cudaStream_t stream) {
        if constexpr (LOG2N > kStepMaxLog2N) {
            return static_cast<int>(cudaErrorInvalidValue);
        } else {
            if (int rc = allow_smem(step_rows_kernel<LOG2N>, smem)) return rc;
            step_rows_kernel<LOG2N><<<dim3((1 << LOG2N) / rows, c),
                                      (rows * kLayers) << Shape<LOG2N>::kLog2T, smem, stream>>>(
                h0, h0nc, omega, scal, tw, scratch, rows, pitch, jpitch, frame);
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
                if (int rc = allow_smem(step_cols_kernel<LOG2N, OutT>, smem)) return rc;
                step_cols_kernel<LOG2N, OutT><<<dim3((1 << LOG2N) / cols, c),
                                                (cols * kLayers) << Shape<LOG2N>::kLog2T, smem,
                                                stream>>>(
                    scratch, foam_in, scal, tw, static_cast<OutT*>(disp),
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
    const long long smem = step_smem(log2n, rows, pitch, jpitch, n);
    if (c < 1 || c > 65535 || smem < 0 || jpitch < n)
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
    const long long smem = step_smem(log2n, cols, pitch, jpitch, n);
    if (c < 1 || c > 65535 || smem < 0 || jpitch < n)
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
