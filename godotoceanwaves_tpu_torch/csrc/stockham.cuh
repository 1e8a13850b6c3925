// Register-resident, self-sorting (Stockham) FFT core of the rows DFT
// (rows_fft.cu), the planes IFFT's column pass (planes_fft.cu) and both
// passes of the fused and strip steps (step_passes.cuh).
//
// A sequence of n = 2^LOG2N points (16 <= n <= 8192) is held by T = n / 16
// threads, 16 points a thread: thread t holds elements t + m T, m < 16, both
// before and after the transform, so the first loads and the last stores of
// a warp are contiguous in the sequence (natural order, no bit reversal).
// The transform runs radix-16 stages, the last one of radix 2^(LOG2N mod 4)
// when 4 does not divide LOG2N (2048 = 16 16 8). Stage s (stride
// Ns = 16^s, radix Rs) is the self-sorting form of Govindaraju et al.
// (SC'08): butterfly j < n / Rs reads elements j + r n / Rs, multiplies them
// by w^(r (j mod Ns)), w = e^{+2 pi i / (Ns Rs)}, takes their radix-Rs DFT
// in registers (constant twiddles) and writes output r to
// (j / Ns) Ns Rs + j mod Ns + r Ns. A thread runs the 16 / Rs butterflies
// j = t + u T, whose inputs are exactly its own registers, so only the
// writes move data between threads: one exchange through shared memory
// between two stages (three at 8192), none after the last.
//
// The exchange buffer holds Re and Im as separate fp32 arrays (4-byte
// words, one per bank per access). The exchange after stage 0 (Ns = 1)
// writes element 16 t + r and reads t + m T; the one after stage 1
// (Ns = 16) writes 256 (t / 16) + t mod 16 + 16 r. The padded index
// pad<S>(a) puts a warp's 32 words of each access on 32 banks: one word
// every 32 after stage 0, 16 words every 256 after stage 1, none later
// (Ns >= 32 writes are contiguous). ops/fft_plan.py models the accesses and
// checks that bound; a sequence's pitch in the buffer is chosen there.
//
// Twiddles come from a table tw[j] = e^{+2 pi i j / n}, j < n / 2, built
// once per (n, device) by the wrapper in float64 and rounded to fp32: a
// butterfly loads w, w^2, w^4 and w^8 (read-only path) and forms the other
// powers with at most three multiplications. No sincos on the card.
//
// Unnormalized, positive exponent: X[k] = sum_j x[j] e^{+2 pi i j k / n}.
#pragma once

#include <cuda_runtime.h>

namespace stockham {

constexpr int kPoints = 16;        // points a thread holds
constexpr int kLog2Points = 4;
constexpr int kMinLog2N = 4;
constexpr int kMaxLog2N = 13;
constexpr int kMaxThreads = 512;   // a block; 8192 points take 512 threads
constexpr int kMinBlocks = 2;      // per SM: caps a thread at 64 registers

__host__ __device__ constexpr int stages(int log2n) {
    return (log2n + kLog2Points - 1) / kLog2Points;
}

// log2 of the radix of stage s: 4 until the last stage, which takes the rest.
__host__ __device__ constexpr int log2_radix(int log2n, int s) {
    return s < stages(log2n) - 1 ? kLog2Points : log2n - kLog2Points * (stages(log2n) - 1);
}

template <int LOG2N>
struct Shape {
    static constexpr int kLog2T = LOG2N - kLog2Points;
    static constexpr int kT = 1 << kLog2T;       // threads a sequence
    static constexpr int kStages = stages(LOG2N);
};

// Padded word index of element a in the exchange after stage S.
template <int S>
__host__ __device__ constexpr int pad(int a) {
    return S == 0 ? a + (a >> 5) : S == 1 ? a + ((a >> 8) << 4) : a;
}

// Words a sequence spans in the exchange buffer (0 with no exchange).
__host__ __device__ constexpr int extent(int log2n) {
    return stages(log2n) < 2    ? 0
           : stages(log2n) == 2 ? pad<0>((1 << log2n) - 1) + 1
                                : pad<1>((1 << log2n) - 1) + 1;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// z e^{+i pi q / 8}, q < 8. q is a constant once the callers' loops are
// unrolled, so the branches fold and the multiplications by 0 and 1 go.
__device__ __forceinline__ float2 rot16(float2 z, int q) {
    constexpr float kC1 = 0.92387953251128674f;   // cos(pi / 8)
    constexpr float kS1 = 0.38268343236508977f;   // sin(pi / 8)
    constexpr float kH = 0.70710678118654752f;    // cos(pi / 4)
    switch (q) {
        case 0: return z;
        case 1: return cmul(z, make_float2(kC1, kS1));
        case 2: return make_float2((z.x - z.y) * kH, (z.x + z.y) * kH);
        case 3: return cmul(z, make_float2(kS1, kC1));
        case 4: return make_float2(-z.y, z.x);
        case 5: return cmul(z, make_float2(-kS1, kC1));
        case 6: return make_float2(-(z.x + z.y) * kH, (z.x - z.y) * kH);
        default: return cmul(z, make_float2(-kC1, kS1));
    }
}

__host__ __device__ constexpr int brev(int k, int bits) {
    int r = 0;
    for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
    return r;
}

// In-register DFT of RS <= 16 points, natural order in and out: radix-2
// decimation in frequency, then the bit reversal as a register renaming.
template <int LOG2RS>
__device__ __forceinline__ void dft(float2 (&a)[1 << LOG2RS]) {
    constexpr int RS = 1 << LOG2RS;
#pragma unroll
    for (int lh = LOG2RS - 1; lh >= 0; --lh) {
        const int h = 1 << lh;
#pragma unroll
        for (int i = 0; i < RS; ++i) {
            if (i & h) continue;
            const float2 x = a[i], y = a[i + h];
            a[i] = cadd(x, y);
            a[i + h] = rot16(csub(x, y), (i & (h - 1)) << (3 - lh));   // w_{2h}^(i mod h)
        }
    }
    float2 b[RS];
#pragma unroll
    for (int k = 0; k < RS; ++k) b[k] = a[brev(k, LOG2RS)];
#pragma unroll
    for (int k = 0; k < RS; ++k) a[k] = b[k];
}

// a[r] *= w^r, w = tw[step]: w, w^2, w^4, w^8 from the table, the rest as
// products of those.
template <int LOG2RS>
__device__ __forceinline__ void twiddle(float2 (&a)[1 << LOG2RS], const float2* __restrict__ tw,
                                        int step) {
    constexpr int RS = 1 << LOG2RS;
    float2 w[LOG2RS];
#pragma unroll
    for (int b = 0; b < LOG2RS; ++b) w[b] = __ldg(tw + (step << b));
#pragma unroll
    for (int r = 1; r < RS; ++r) {
        float2 p = make_float2(0.0f, 0.0f);
        bool first = true;
#pragma unroll
        for (int b = 0; b < LOG2RS; ++b) {
            if (!((r >> b) & 1)) continue;
            p = first ? w[b] : cmul(p, w[b]);
            first = false;
        }
        a[r] = cmul(a[r], p);
    }
}

// Stage S on thread t's registers: in, v[m] is element t + m T of the
// stage's input; out, v[u + r (16 / Rs)] is output r of butterfly t + u T.
template <int LOG2N, int S>
__device__ __forceinline__ void stage(float2 (&v)[kPoints], int t, const float2* __restrict__ tw) {
    using Sh = Shape<LOG2N>;
    constexpr int LOG2RS = log2_radix(LOG2N, S);
    constexpr int RS = 1 << LOG2RS;
    constexpr int GROUPS = kPoints / RS;
    constexpr int LOG2NS = kLog2Points * S;
#pragma unroll
    for (int u = 0; u < GROUPS; ++u) {
        float2 a[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) a[r] = v[u + r * GROUPS];
        if constexpr (S > 0) {
            const int k = (t + u * Sh::kT) & ((1 << LOG2NS) - 1);
            twiddle<LOG2RS>(a, tw, k << (LOG2N - LOG2NS - LOG2RS));   // k n / (Ns Rs)
        }
        dft<LOG2RS>(a);
#pragma unroll
        for (int r = 0; r < RS; ++r) v[u + r * GROUPS] = a[r];
    }
}

// The exchange after stage S (a radix-16 stage: one butterfly a thread):
// output r of butterfly t goes to (t / Ns) 16 Ns + t mod Ns + r Ns.
template <int LOG2N, int S>
__device__ __forceinline__ void exchange_store(const float2 (&v)[kPoints], int t, float* re,
                                               float* im) {
    constexpr int LOG2NS = kLog2Points * S;
    const int base = ((t >> LOG2NS) << (LOG2NS + kLog2Points)) + (t & ((1 << LOG2NS) - 1));
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
        const int at = pad<S>(base + (r << LOG2NS));
        re[at] = v[r].x;
        im[at] = v[r].y;
    }
}

template <int LOG2N, int S>
__device__ __forceinline__ void exchange_load(float2 (&v)[kPoints], int t, const float* re,
                                              const float* im) {
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
        const int at = pad<S>(t + m * Shape<LOG2N>::kT);
        v[m] = make_float2(re[at], im[at]);
    }
}

// Stages S.. of the transform, each after an exchange; v[m] holds element
// t + m T of stage S - 1's output (as exchange_load left it) on entry.
template <int LOG2N, int S>
__device__ __forceinline__ void later_stages(float2 (&v)[kPoints], int t, float* re, float* im,
                                             const float2* __restrict__ tw) {
    if constexpr (S < Shape<LOG2N>::kStages) {
        stage<LOG2N, S>(v, t, tw);
        if constexpr (S + 1 < Shape<LOG2N>::kStages) {
            __syncthreads();   // every thread has read the last exchange
            exchange_store<LOG2N, S>(v, t, re, im);
            __syncthreads();
            exchange_load<LOG2N, S>(v, t, re, im);
            later_stages<LOG2N, S + 1>(v, t, re, im, tw);
        }
    }
}

// The n-point transform of one sequence, v[m] = x[t + m T] in and
// v[m] = X[t + m T] out. Stage 0 runs as thread t0 of the sequence whose
// exchange words are (re0, im0); the later stages as thread t1 of the
// sequence at (re1, im1). Callers with one mapping pass the same pair
// twice; the column pass maps its loads and its stores differently. Every
// thread of the block calls it (it holds barriers).
template <int LOG2N>
__device__ __forceinline__ void transform(float2 (&v)[kPoints], int t0, float* re0, float* im0,
                                          int t1, float* re1, float* im1,
                                          const float2* __restrict__ tw) {
    stage<LOG2N, 0>(v, t0, tw);
    if constexpr (Shape<LOG2N>::kStages > 1) {
        exchange_store<LOG2N, 0>(v, t0, re0, im0);
        __syncthreads();
        exchange_load<LOG2N, 0>(v, t1, re1, im1);
        later_stages<LOG2N, 1>(v, t1, re1, im1, tw);
    }
}

// Launch<log2n>::run(args...), the kernels being instantiated per length.
template <template <int> class Launch, typename... Args>
int dispatch(int log2n, Args... args) {
    switch (log2n) {
        case 4: return Launch<4>::run(args...);
        case 5: return Launch<5>::run(args...);
        case 6: return Launch<6>::run(args...);
        case 7: return Launch<7>::run(args...);
        case 8: return Launch<8>::run(args...);
        case 9: return Launch<9>::run(args...);
        case 10: return Launch<10>::run(args...);
        case 11: return Launch<11>::run(args...);
        case 12: return Launch<12>::run(args...);
        case 13: return Launch<13>::run(args...);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

inline int log2_exact(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return (1 << l) == n ? l : -1;
}

// The launch plan the wrapper chose (ops/fft_plan.py): `seqs` sequences a
// block, each `pitch` words apart in the exchange buffer. Returns the
// dynamic shared bytes, or -1 if the plan does not fit the kernel.
inline long long plan_smem(int log2n, int seqs, int pitch) {
    if (log2n < kMinLog2N || log2n > kMaxLog2N || seqs < 1) return -1;
    const long long threads = static_cast<long long>(seqs) << (log2n - kLog2Points);
    if (threads > kMaxThreads || pitch < extent(log2n)) return -1;
    const long long bytes = 2LL * seqs * pitch * sizeof(float);
    return bytes > 232448 ? -1 : bytes;
}

// Shared memory above 48 KB needs an opt-in per kernel; returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, long long bytes) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace stockham
