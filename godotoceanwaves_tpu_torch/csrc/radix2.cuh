// Shared-memory radix-2 FFT core of the strip step (strip_step.cu). The rows
// DFT and the planes IFFT run on the register-resident core, stockham.cuh.
//
// A block transforms kSeqs sequences of length m (a power of two, m <= kMaxM)
// held in shared memory as buf[s * m + i], next to a twiddle table of m / 2
// entries: 36 * m bytes, 144 KB at m = 4096. Both transforms are in place, so
// no stage needs a second buffer or a register copy of the block's data, and
// any block size works:
//
//   dif_inplace: decimation in frequency, natural-order input, output in
//                bit-reversed order (buf[s * m + i] = X_s[brev(i)]);
//   dit_inplace: decimation in time, bit-reversed input, natural output.
//
// Each pass over the buffer runs kFuse radix-2 stages on 2^kFuse elements in
// registers, so a 2048-point transform makes 4 passes instead of 11. On the
// card that cut the strip step's time at 2048^2 from 1.42 to 0.94 ms/frame
// (one stage per pass -> three; NVIDIA H100 80GB HBM3, 700 W).
//
// Callers pick the form that puts the bit reversal on their global-memory
// side, where every access is a whole 32-byte record anyway, and keep their
// shared-memory loads and stores at consecutive addresses.
//
// A length n = 2 m (n = 8192) is split by one radix-2 stage done while
// loading (split_stage): the block of parity e transforms
//   a_e[j] = (x[j] + (-1)^e x[j + m]) * w_n^(e j),   j < m,
// whose transform is X[2 k + e]. Two blocks share a row and each writes
// every other output.
//
// Unnormalized, positive exponent: X[k] = sum_j x[j] e^{+2 pi i j k / m}.
// No fast math: twiddles come from sincospif(2 j / m), whose argument is
// exact for power-of-two m.
#pragma once

#include <cuda_runtime.h>

namespace radix2 {

constexpr int kSeqs = 4;
constexpr int kMaxM = 4096;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{+2 pi i j / n}
__device__ __forceinline__ float2 twiddle(int j, int n) {
    float s, c;
    sincospif(static_cast<float>(2 * j) / static_cast<float>(n), &s, &c);
    return make_float2(c, s);
}

// i with its low log2m bits reversed (log2m >= 1)
__device__ __forceinline__ int brev(int i, int log2m) {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2m));
}

// tw[j] = e^{+2 pi i j / m}, j < m / 2. The caller syncs before reading it.
__device__ __forceinline__ void fill_twiddles(float2* tw, int m) {
    for (int j = threadIdx.x; j < m / 2; j += blockDim.x) tw[j] = twiddle(j, m);
}

// The split stage for parity e of an n-point sequence: lo = x[j], hi = x[j + n/2].
__device__ __forceinline__ float2 split_stage(float2 lo, float2 hi, int e, int j, int n) {
    return e ? cmul(csub(lo, hi), twiddle(j, n)) : cadd(lo, hi);
}

// Radix-2 stages fused per pass over the shared buffer: each thread runs
// kFuse consecutive stages on 2^kFuse elements held in registers. The
// arithmetic is that of one stage per pass; the shared-memory traffic and
// the barriers are divided by kFuse.
constexpr int kFuse = 3;
static_assert(kFuse >= 1 && kFuse <= 4, "leftover stages are dispatched for up to 3");

// Group g of a pass whose lowest stage has half-span h = 2^lh and which
// fuses K stages: the group is i0 + t h, t < 2^K, and j = i0 mod h.
template <int K>
__device__ __forceinline__ void group_at(int g, int lh, int log2m, int& i0, int& j) {
    const int s = g >> (log2m - K);
    const int r = g & ((1 << (log2m - K)) - 1);
    j = r & ((1 << lh) - 1);
    i0 = (s << log2m) + ((r >> lh) << (lh + K)) + j;
}

// Twiddle of element t of a group in the stage with half-span 2^(lh + st).
__device__ __forceinline__ float2 stage_twiddle(const float2* tw, int t, int st, int lh, int j,
                                                int log2m) {
    return tw[(((t & ((1 << st) - 1)) << lh) + j) << (log2m - 1 - lh - st)];
}

// K decimation-in-frequency stages, half-spans 2^(lh + K - 1) down to 2^lh.
template <int K>
__device__ __forceinline__ void dif_pass(float2* buf, const float2* tw, int m, int log2m, int lh) {
    constexpr int R = 1 << K;
    const int h = 1 << lh;
    for (int g = threadIdx.x; g < kSeqs * (m >> K); g += blockDim.x) {
        int i0, j;
        group_at<K>(g, lh, log2m, i0, j);
        float2 v[R];
#pragma unroll
        for (int t = 0; t < R; ++t) v[t] = buf[i0 + t * h];
#pragma unroll
        for (int st = K - 1; st >= 0; --st) {
#pragma unroll
            for (int t = 0; t < R; ++t) {
                if (t & (1 << st)) continue;
                const float2 a = v[t], c = v[t + (1 << st)];
                v[t] = cadd(a, c);
                v[t + (1 << st)] = cmul(csub(a, c), stage_twiddle(tw, t, st, lh, j, log2m));
            }
        }
#pragma unroll
        for (int t = 0; t < R; ++t) buf[i0 + t * h] = v[t];
    }
    __syncthreads();
}

// K decimation-in-time stages, half-spans 2^lh up to 2^(lh + K - 1).
template <int K>
__device__ __forceinline__ void dit_pass(float2* buf, const float2* tw, int m, int log2m, int lh) {
    constexpr int R = 1 << K;
    const int h = 1 << lh;
    for (int g = threadIdx.x; g < kSeqs * (m >> K); g += blockDim.x) {
        int i0, j;
        group_at<K>(g, lh, log2m, i0, j);
        float2 v[R];
#pragma unroll
        for (int t = 0; t < R; ++t) v[t] = buf[i0 + t * h];
#pragma unroll
        for (int st = 0; st < K; ++st) {
#pragma unroll
            for (int t = 0; t < R; ++t) {
                if (t & (1 << st)) continue;
                const float2 a = v[t];
                const float2 x = cmul(v[t + (1 << st)], stage_twiddle(tw, t, st, lh, j, log2m));
                v[t] = cadd(a, x);
                v[t + (1 << st)] = csub(a, x);
            }
        }
#pragma unroll
        for (int t = 0; t < R; ++t) buf[i0 + t * h] = v[t];
    }
    __syncthreads();
}

// Decimation in frequency: natural order in, bit-reversed order out. Needs
// a barrier before the call; ends with one.
__device__ __forceinline__ void dif_inplace(float2* buf, const float2* tw, int m, int log2m) {
    int lh = log2m - kFuse;
    for (; lh >= 0; lh -= kFuse) dif_pass<kFuse>(buf, tw, m, log2m, lh);
    switch (lh + kFuse) {   // the stages left over at the bottom
        case 3: dif_pass<3>(buf, tw, m, log2m, 0); break;
        case 2: dif_pass<2>(buf, tw, m, log2m, 0); break;
        case 1: dif_pass<1>(buf, tw, m, log2m, 0); break;
        default: break;
    }
}

// Decimation in time: bit-reversed order in, natural order out. Needs a
// barrier before the call; ends with one.
__device__ __forceinline__ void dit_inplace(float2* buf, const float2* tw, int m, int log2m) {
    const int rest = log2m % kFuse;
    switch (rest) {   // the stages left over at the bottom go first
        case 3: dit_pass<3>(buf, tw, m, log2m, 0); break;
        case 2: dit_pass<2>(buf, tw, m, log2m, 0); break;
        case 1: dit_pass<1>(buf, tw, m, log2m, 0); break;
        default: break;
    }
    for (int lh = rest; lh < log2m; lh += kFuse) dit_pass<kFuse>(buf, tw, m, log2m, lh);
}

inline int log2_of(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return l;
}

// Blocks per row (1, or 2 when n > kMaxM) and the threads of a block.
inline int split_of(int n) { return n > kMaxM ? 2 : 1; }

inline int threads_for(int m) {
    return m < 32 ? 32 : (m > kMaxThreads ? kMaxThreads : m);
}

inline size_t smem_bytes(int m) {
    return (static_cast<size_t>(kSeqs) * m + m / 2) * sizeof(float2);
}

// Shared memory above 48 KB needs an opt-in per kernel; returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace radix2
