// The two passes of the fused ocean step (modulate -> 2D IFFT, sign folded
// -> unpack + foam) on the register-resident Stockham core (stockham.cuh),
// shared by the fused step (fused_step.cu, K1: N <= 1024) and the strip step
// (strip_step.cu, K4: N = 2048..8192).
//
// The kernels are templated on the transform length M = 2^LOG2M and the
// split S (1, 2 or 4): the map is N = S M points a side, and S blocks share
// each row (row pass) or column (column pass), block e taking the outputs of
// parity e mod S:
//
//   X[S k + e] = sum_{j < M} ( sum_{q < S} x[j + M q] e^{+2 pi i e q / S} ) w_N^(e j) w_M^(j k)
//
// a radix-S pre-stage done while loading (the inner sum by quarter turns,
// which are exact, then one multiplication by w_N^(e j) from the wrapper's
// N-point table), then the M-point transform. K1 runs S = 1, where the
// pre-stage and its table are compiled out; K4 runs S = 2 at N = 2048 and
// 4096 and S = 4 at 8192 (strip_step.cu). Two kernels, launched back to back
// on the caller's stream:
//
//   rows: block (R rows, parity e, cascade c), 4 sequences a row: sequence s
//         is layer s mod 4 of row s / 4. Prologue: each texel of the
//         block's rows is modulated (phase = omega * t in fp32, accurate
//         sincosf), 4 S texels a thread (each texel once at S = 1, once per
//         parity block above), and the pre-stage's sum of its 4 layers goes
//         through shared memory to the threads of their sequences (thread t
//         holds x = t + m M/16). After the transform along x, a join through
//         shared memory: each thread gathers half-records, so that the 4
//         layers of texel (y, S k + e) leave as one 32-byte record of the
//         scratch (C, N, N, 8) fp32 (at S = 1 a warp stores 512 contiguous
//         bytes; above, 16 whole records S x 32 bytes apart).
//   cols: block (C columns, parity e, cascade c), 4 sequences a column.
//         Stage 0 loads with the sequence fastest across the warp, so the 4
//         lanes of a column read each record whole (S records a point at
//         S > 1, summed by the pre-stage); the later stages run t fastest.
//         The transform along y of column kx is OUTPUT ROW kx (the
//         reference's rows -> transpose -> rows chain with no second
//         transpose). The join: each thread writes its layer's 16 outputs
//         to shared memory (reusing the exchange buffer), and after a
//         barrier unpacks a quarter of its column's outputs,
//         k = t + (layer + 4 j) M/16, from all 4 layers, into map column
//         S k + e: at S = 1 consecutive lanes hold consecutive columns, so
//         the map and foam accesses stay contiguous; above, they are S
//         elements apart. Epilogue: (-1)^(kx+m) ifftshift (once, in
//         texel::unpack), displacement, normal from fp32 gradients (rounded
//         once), fp32 foam recurrence. The thread that reads foam_in[m]
//         writes foam_out[m], so the two may alias.
//
// Bound: device memory bandwidth. The function moves 20 N^2 bytes of
// spectra + omega in, 4 N^2 of foam in and 4 out and the maps out (14 N^2
// in bf16) a cascade; the two-pass form adds the 32 N^2-byte scratch written
// and read back, so that no block holds a whole layer. What keeps a
// shared-memory FFT from that bound is the work between its loads and its
// stores: the modulation (one sincosf, a square root and four divisions a
// texel), the exchanges and the joins' barriers and round trips. At 64
// registers a thread an SM holds 1024 threads of either pass to hide them.
//
// Accuracy: no fast math. omega * t reaches ~7.6e3 rad at 8192^2, so sincosf
// keeps its full range reduction. Every offset that can pass 2^31 (the
// scratch is 2 GiB a cascade at 8192^2) is computed in size_t.
#pragma once

#include <cuda_runtime.h>

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

__host__ __device__ constexpr int log2_split(int split) {
    return split == 4 ? 2 : split == 2 ? 1 : 0;
}

// z e^{+i pi k / 2}: exact.
__device__ __forceinline__ float2 quarter_turns(float2 z, int k) {
    switch (k & 3) {
        case 0: return z;
        case 1: return make_float2(-z.y, z.x);
        case 2: return make_float2(-z.x, -z.y);
        default: return make_float2(z.y, -z.x);
    }
}

// Term q of block e's pre-stage: z e^{+2 pi i e q / S}.
template <int SPLIT>
__device__ __forceinline__ float2 split_term(float2 z, int e, int q) {
    return quarter_turns(z, e * q * (4 / SPLIT));
}

// e^{+2 pi i k / n}, 0 <= k < n, from the table tw[j] = e^{+2 pi i j / n},
// j < n / 2 (the second half is the first negated).
__device__ __forceinline__ float2 unit_root(const float2* __restrict__ tw, int k, int half) {
    const float2 w = __ldg(tw + (k < half ? k : k - half));
    return k < half ? w : make_float2(-w.x, -w.y);
}

// MAX_THREADS and MIN_BLOCKS are the launch bounds: the default caps a
// thread at 64 registers; the strip step's 256-thread row blocks at 2048
// take 48, 5 blocks an SM.
template <int LOG2M, int SPLIT, int MAX_THREADS = kMaxThreads, int MIN_BLOCKS = kMinBlocks>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
step_rows_kernel(const float* __restrict__ h0, const float* __restrict__ h0nc,
                 const float* __restrict__ omega, const float* __restrict__ scal,
                 const float2* __restrict__ tw, const float2* __restrict__ twn,
                 float* __restrict__ scratch, int rows, int pitch, int jpitch, int frame) {
    using Sh = Shape<LOG2M>;
    constexpr int kM = 1 << LOG2M;
    constexpr int kLog2S = log2_split(SPLIT);
    constexpr int kLog2N = LOG2M + kLog2S;
    extern __shared__ float smem[];
    const int seqs = rows * kLayers;
    [[maybe_unused]] const int e = blockIdx.x & (SPLIT - 1);
    const int y0 = (blockIdx.x >> kLog2S) * rows;
    const int c = blockIdx.y;
    const float* sc = scal + c * NUM_SCALARS;
    // frame k modulates at S_TIME + k * S_DT, rounded as two fp32 ops
    const float time = __fadd_rn(sc[S_TIME], __fmul_rn(static_cast<float>(frame), sc[S_DT]));

    // Prologue: the block's rows x M points, 4 a thread; layer l of point
    // (y0 + r, x) goes to word x of sequence 4 r + l in the buffer that the
    // exchanges use later.
    float* jre = smem;
    float* jim = smem + seqs * jpitch;
#pragma unroll
    for (int j = 0; j < kPoints / kLayers; ++j) {
        const int q = threadIdx.x + j * blockDim.x;
        const int r = q >> LOG2M;
        const int x = q & (kM - 1);
        const texel::Row row = texel::row_at(h0, h0nc, omega, sc, c, y0 + r, 1 << kLog2N, time);
        float2 lay[kLayers];
        texel::modulate(row, x, lay);
        if constexpr (SPLIT > 1) {
#pragma unroll 1
            for (int p = 1; p < SPLIT; ++p) {
                float2 more[kLayers];
                texel::modulate(row, x + p * kM, more);
#pragma unroll
                for (int l = 0; l < kLayers; ++l)
                    lay[l] = cadd(lay[l], split_term<SPLIT>(more[l], e, p));
            }
            const float2 w = unit_root(twn, e * x, 1 << (kLog2N - 1));
#pragma unroll
            for (int l = 0; l < kLayers; ++l) lay[l] = cmul(lay[l], w);
        }
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
    transform<LOG2M>(v, t, re, im, t, re, im, tw);

    // The join: the sequences' outputs back to the buffer, then each half
    // of a texel record (layers 2h and 2h + 1 of output k of row y0 + r, 16
    // bytes) is one thread's, stored at map column S k + e.
    __syncthreads();   // every thread has read the last exchange
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        jre[s * jpitch + t + m * Sh::kT] = v[m].x;
        jim[s * jpitch + t + m * Sh::kT] = v[m].y;
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(scratch)
                  + ((static_cast<size_t>(c) << kLog2N) + y0) * (2 << kLog2N);
#pragma unroll
    for (int u = 0; u < 2 * kPoints / kLayers; ++u) {
        const int slot = threadIdx.x + u * blockDim.x;
        const int q = slot >> 1;
        const int w0 = ((q >> LOG2M) * kLayers + (slot & 1) * 2) * jpitch + (q & (kM - 1));
        const int w1 = w0 + jpitch;
        const float4 rec = make_float4(jre[w0], jim[w0], jre[w1], jim[w1]);
        if constexpr (SPLIT == 1) {
            out[slot] = rec;
        } else {
            const int col = ((q & (kM - 1)) << kLog2S) + e;
            out[((((q >> LOG2M) << kLog2N) + col) << 1) + (slot & 1)] = rec;
        }
    }
}

template <int LOG2M, int SPLIT, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
step_cols_kernel(const float* __restrict__ scratch,
                 const float* foam_in,     // may alias foam_out
                 const float* __restrict__ scal, const float2* __restrict__ tw,
                 const float2* __restrict__ twn, OutT* __restrict__ disp,
                 OutT* __restrict__ normal, float* foam_out, int cols, int pitch, int jpitch,
                 long long disp_cstride, long long norm_cstride) {
    using Sh = Shape<LOG2M>;
    constexpr int kM = 1 << LOG2M;
    constexpr int kLog2S = log2_split(SPLIT);
    constexpr int kLog2N = LOG2M + kLog2S;
    constexpr size_t kPlane = static_cast<size_t>(1) << (2 * kLog2N);
    extern __shared__ float smem[];
    const int seqs = cols * kLayers;
    const int e = blockIdx.x & (SPLIT - 1);
    const int x0 = (blockIdx.x >> kLog2S) * cols;
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
                            + ((static_cast<size_t>(c) << (2 * kLog2N)) + x) * kLayers + layer;
#pragma unroll
        for (int m = 0; m < kPoints; ++m) {
            const int y = t0 + m * Sh::kT;
            v[m] = run[static_cast<size_t>(y) << (kLog2N + 2)];
            if constexpr (SPLIT > 1) {
#pragma unroll
                for (int p = 1; p < SPLIT; ++p) {
                    const float2 part = run[static_cast<size_t>(y + p * kM) << (kLog2N + 2)];
                    v[m] = cadd(v[m], split_term<SPLIT>(part, e, p));
                }
                v[m] = cmul(v[m], unit_root(twn, e * y, 1 << (kLog2N - 1)));
            }
        }
    }
    float* re0 = smem + s0 * pitch;
    float* re1 = smem + s1 * pitch;
    transform<LOG2M>(v, t0, re0, re0 + seqs * pitch, t1, re1, re1 + seqs * pitch, tw);

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
    const size_t row = static_cast<size_t>(kx) << kLog2N;
    OutT* d = disp + c * disp_cstride + row;
    OutT* nm = normal + c * norm_cstride + row;
    const float* fi = foam_in + c * kPlane + row;
    float* fo = foam_out + c * kPlane + row;
#pragma unroll
    for (int j = 0; j < kPoints / kLayers; ++j) {
        const int k = t1 + (layer + kLayers * j) * Sh::kT;
        float2 l[kLayers];
#pragma unroll
        for (int q = 0; q < kLayers; ++q) {
            const int w = (col * kLayers + q) * jpitch + k;
            l[q] = make_float2(jre[w], jim[w]);
        }
        const int m = (k << kLog2S) + e;   // map column
        // the thread that reads fi[m] writes fo[m]: in place is safe
        fo[m] = texel::unpack<OutT>(l[0], l[1], l[2], l[3], kx, m, fi[m], keep, whitecap, grow,
                                    d, nm, kPlane);
    }
}

// The dynamic shared bytes of a plan over sequences of 2^log2m points with
// `lines` of the map's n rows or columns a block (the exchange buffer, or
// the join buffer where that is larger), or -1 if it does not fit the
// kernels.
inline long long step_smem(int log2m, int lines, int pitch, int jpitch, int n) {
    if (log2m < kMinLog2N || log2m > kMaxLog2N || lines < 1 || lines > n
        || (lines & (lines - 1)) != 0 || jpitch < (1 << log2m))
        return -1;
    const int seqs = lines * kLayers;
    const long long exchange = plan_smem(log2m, seqs, pitch);
    const long long join = 2LL * seqs * jpitch * sizeof(float);
    if (exchange < 0) return -1;
    const long long bytes = exchange > join ? exchange : join;
    return bytes > 232448 ? -1 : bytes;
}

}  // namespace
