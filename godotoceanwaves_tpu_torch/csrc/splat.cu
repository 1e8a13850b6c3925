// The spray composite: every sprite lobe of a frame splatted and composited
// onto the image, with no lobe-weight matrix in device memory.
//
// Replaces no TPU kernel. The JAX package's splat (models/shading.py
// splat_spray) is an einsum over (lobes x H) and (lobes x W) weight
// matrices left to XLA, and the port's plain route
// (models/shading.py _splat_spray_plain) forms the same two matrices, about
// 1.6 GB in fp32 for 32768 six-lobe puffs at 1280x720, rounds them to bf16
// and contracts them with a matrix product. Nearly every weight is exactly 0:
// a lobe's sigma lies in [0.24, 2.2] px and fp32 exp(t) is 0 for
// t < -103.97, so exp(-d^2 / (2 sigma^2)) is 0 beyond |d| = 14.42 sigma. This
// chain forms only the weights inside a window of 16 sigma about each lobe,
// with the plain route's operations in its order:
//
//   d = (i + 0.5) - centre, then d * d, negated, times 1 / (2 sigma^2), expf;
//   the row weight times the lobe's amplitude, rounded to bf16; the column
//   weight rounded to bf16; their product in fp32 (exact: 8 by 8 significant
//   bits), summed in fp32.
//
// So every nonzero product of the contraction is formed bit for bit; only
// the order of the fp32 sum differs (here: ascending lobe index, one pixel
// at a time), as it already differs between the card's matrix product and
// the CPU's. Built with -fmad=false (ops/_build.py): a contracted multiply-add
// moves a weight by an ulp, which can flip its bf16 rounding. The sum uses
// fmaf on purpose: its product is exact, so fmaf rounds what a multiply and
// an add would.
//
// The chain, on the caller's stream, with no host sync and no allocation:
//   1. memset: the NaN flag and the per-tile lobe counts;
//   2. setup, a thread a lobe (row r = particle * L + lobe, the plain route's
//      order): the particle's screen centre, alpha and sigma from its camera
//      terms, the lobe's centre, sigma and amplitude, its window and the
//      16 x 16 px tiles the window overlaps (int atomics count them);
//   3. scan, one block: each tile's segment of the lobe list;
//   4. scatter, a thread a lobe: the lobe's index into each of its tiles'
//      segments (int atomics pick the slot, so a segment is unordered);
//   5. gather, a block a tile: the segment sorted by a bitmap of lobe indices
//      in shared memory (ascending, whatever the scatter's order), then each
//      pixel's sum over it in that order, then the composite
//      clamp(img (1 - o) + boost o, 0, 1) with o = clamp(sum, 0, 1). The
//      overlay never reaches device memory. No float is added with atomics,
//      so two calls, and a graph replay, give the same bits.
//
// What bounds it: the lobes' inputs (~3 MB at 32768 puffs), the image read
// and written (22 MB at 1280x720), the bin tables; at most 72 x 72 weight
// products a lobe (window <= 71 px at sigma = 2.2), and only for lobes whose
// amplitude is not 0. A window spans at most 6 x 6 tiles, which sizes the
// lobe list (ops/splat.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;            // a tile is kTile x kTile pixels
constexpr int kThreads = 256;        // a gather block: one thread a pixel of its tile
constexpr int kScanThreads = 1024;
constexpr int kMaxLobes = 8;
constexpr float kWindowSigmas = 16.0f;
constexpr int kBatch = 64;           // lobes whose tile weights a gather block forms at once
constexpr int kBitmapWords = 2048;   // lobe indices a sorting pass covers: 65536
constexpr int kWordsPerThread = kBitmapWords / kThreads;

// The puff's lobe table (shading._puff_lobes): off_x, off_y, sigma_frac, amplitude.
struct LobeTable {
    float v[kMaxLobes][4];
};

// A particle's inputs, each (P,) fp32 unless noted. custom_z and turns may be
// null (no dissolve cut; the one-lobe gaussian sprite).
struct Particles {
    const float* x;          // camera-space terms, as the plain route forms them
    const float* y;
    const float* z;
    const float* dist;
    const float* world_r;
    const float* scales;     // (P, 3)
    const float* dissolve;
    const unsigned char* visible;  // bool
    const float* custom_z;
    const float* turns;      // (P, 2): cos and sin of the particle's golden-angle turn
    const float* tan_half;   // 0-d
    const float* focal;      // 0-d
};

// torch.clamp and clamp_min: a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The plain route's weight of pixel i for a lobe at `centre`.
__device__ __forceinline__ float weight(int i, float centre, float inv2s2) {
    const float d = ((float)i + 0.5f) - centre;
    return expf(-(d * d) * inv2s2);
}

// [first, last] pixels of an n-pixel axis inside a lobe's window (first >
// last: none): pixel centres within 16 sigma of the lobe's centre.
// ops/splat.py lobe_window is the same arithmetic.
__device__ __forceinline__ int2 window(float centre, float sigma, int n) {
    const float c = centre - 0.5f;
    const float reach = kWindowSigmas * sigma;
    const float lo = c - reach;
    const float hi = c + reach;
    return make_int2((int)ceilf(fminf(fmaxf(lo, 0.0f), (float)n)),
                     (int)floorf(fmaxf(fminf(hi, (float)(n - 1)), -1.0f)));
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. Every thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* total) {
    __shared__ int warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int s = lane < warps ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += u;
        }
        warp_sums[lane] = s;
    }
    __syncthreads();
    const int out = (warp > 0 ? warp_sums[warp - 1] : 0) + inc - v;
    *total = warp_sums[warps - 1];
    __syncthreads();
    return out;
}

__global__ void __launch_bounds__(kThreads) splat_setup_kernel(
        Particles pt, LobeTable tab, int lobes, int particles, int h, int w, float aspect,
        float max_alpha, int tiles_x, float4* __restrict__ recs, int4* __restrict__ rects,
        int* __restrict__ flag, int* __restrict__ counts) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= particles * lobes) return;
    const int p = r / lobes;
    const int l = r - p * lobes;
    // the particle, as splat_spray projects it (camera basis applied by the caller)
    const float z = pt.z[p];
    const float zt = z * *pt.tan_half;
    const float px = ((pt.x[p] / zt + 1.0f) * 0.5f) * (float)w;
    const float py = (0.5f - pt.y[p] / ((zt * 2.0f) * aspect)) * (float)h;
    const float fade = max_alpha * (1.0f - expf(-pt.dist[p] * (float)0.04));
    const float dissolve = pt.dissolve[p];
    const float d01 = clamp_nan(dissolve, 0.0f, 1.0f);
    float alpha;
    if (pt.custom_z == nullptr) {
        alpha = fade * d01;
    } else {
        const float cz = pt.custom_z[p];
        float m = fmodf(cz * (float)7.31 + dissolve * (float)1.37, 1.0f);
        if (m < 0.0f) m += 1.0f;            // torch.remainder: the divisor's sign
        const float noise = m * (float)0.45;
        alpha = fade * clamp_min_nan((d01 + cz) * 0.5f - noise, 0.0f);
    }
    alpha = alpha * clamp_nan(pt.scales[3 * p], 0.0f, 1.0f);
    if (!(pt.visible[p] && z > 0.5f)) alpha = 0.0f;
    const float sigma = clamp_nan(pt.world_r[p] * *pt.focal / clamp_min_nan(z, 0.5f),
                                  (float)0.6, (float)2.2);
    // the lobe
    float cx = px, cy = py, sg = sigma, amp = alpha;
    if (pt.turns != nullptr) {
        const float ct = pt.turns[2 * p], st = pt.turns[2 * p + 1];
        const float* t = tab.v[l];
        const float off = sigma * (float)1.3;
        cx = px + off * (ct * t[0] - st * t[1]);
        cy = py + off * (st * t[0] + ct * t[1]);
        sg = sigma * t[2];
        amp = alpha * t[3];
    }
    recs[r] = make_float4(cx, cy, 1.0f / ((2.0f * sg) * sg), amp);
    int4 rect = make_int4(0, 0, -1, -1);    // no tile
    if (isnan(cx) || isnan(cy) || isnan(sg) || isnan(amp)) {
        // the plain route's weights of this row are NaN, so is every sum of
        // its contraction: the whole composite turns NaN
        *flag = 1;
    } else if (amp != 0.0f && isfinite(cx) && isfinite(cy)) {
        // (amplitude 0, or an infinite centre: every product of the row is 0)
        const int2 rows = window(cy, sg, h), cols = window(cx, sg, w);
        if (rows.x <= rows.y && cols.x <= cols.y) {
            rect = make_int4(cols.x / kTile, rows.x / kTile, cols.y / kTile, rows.y / kTile);
            for (int ty = rect.y; ty <= rect.w; ++ty)
                for (int tx = rect.x; tx <= rect.z; ++tx) atomicAdd(counts + ty * tiles_x + tx, 1);
        }
    }
    rects[r] = rect;
}

__global__ void __launch_bounds__(kScanThreads) splat_scan_kernel(
        const int* __restrict__ counts, int* __restrict__ start, int* __restrict__ fill,
        int tiles) {
    const int per = (tiles + kScanThreads - 1) / kScanThreads;
    const int first = threadIdx.x * per;
    const int last = min(first + per, tiles);
    int sum = 0;
    for (int t = first; t < last; ++t) sum += counts[t];
    int total;
    int run = block_exclusive_scan(sum, &total);
    for (int t = first; t < last; ++t) {
        start[t] = run;
        fill[t] = run;
        run += counts[t];
    }
    if (threadIdx.x == 0) start[tiles] = total;
}

__global__ void __launch_bounds__(kThreads) splat_scatter_kernel(
        const int4* __restrict__ rects, int n, int tiles_x, int* __restrict__ fill,
        int* __restrict__ list) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= n) return;
    const int4 rect = rects[r];
    for (int ty = rect.y; ty <= rect.w; ++ty)
        for (int tx = rect.x; tx <= rect.z; ++tx) list[atomicAdd(fill + ty * tiles_x + tx, 1)] = r;
}

// `sorted` is written and read back by the same block: plain loads, no
// read-only cache.
__global__ void __launch_bounds__(kThreads) splat_gather_kernel(
        const float* __restrict__ img, const float* __restrict__ boost,
        const float4* __restrict__ recs, const int* __restrict__ flag,
        const int* __restrict__ start, const int* __restrict__ list, int* sorted,
        float* __restrict__ out, int n_lobes, int h, int w, int tiles_x) {
    __shared__ unsigned bitmap[kBitmapWords];
    __shared__ float wy[kBatch][kTile];
    __shared__ float wx[kBatch][kTile];
    const int t = blockIdx.y * tiles_x + blockIdx.x;
    const int s0 = start[t];
    const int n = start[t + 1] - s0;
    const int ly = threadIdx.x / kTile, lx = threadIdx.x % kTile;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float sum = 0.0f;
    if (n > 0) {
        // sort the segment: a bitmap of lobe indices, base .. base + 65535 a pass
        int written = 0;
        for (int base = 0; base < n_lobes; base += kBitmapWords * 32) {
            for (int i = threadIdx.x; i < kBitmapWords; i += kThreads) bitmap[i] = 0u;
            __syncthreads();
            for (int e = threadIdx.x; e < n; e += kThreads) {
                const unsigned k = (unsigned)(list[s0 + e] - base);
                if (k < kBitmapWords * 32u) atomicOr(bitmap + (k >> 5), 1u << (k & 31));
            }
            __syncthreads();
            const int w0 = threadIdx.x * kWordsPerThread;
            int count = 0;
            for (int i = 0; i < kWordsPerThread; ++i) count += __popc(bitmap[w0 + i]);
            int total;
            int at = s0 + written + block_exclusive_scan(count, &total);
            for (int i = 0; i < kWordsPerThread; ++i) {
                for (unsigned bits = bitmap[w0 + i]; bits; bits &= bits - 1)
                    sorted[at++] = base + (w0 + i) * 32 + __ffs(bits) - 1;
            }
            written += total;
            __syncthreads();
        }
        // each pixel's sum over the tile's lobes, ascending; a warp forms one
        // lobe's 16 row weights (lanes 0-15) and 16 column weights (16-31)
        for (int k0 = 0; k0 < n; k0 += kBatch) {
            const int kb = min(kBatch, n - k0);
            for (int k = warp; k < kb; k += kThreads / 32) {
                const float4 q = recs[sorted[s0 + k0 + k]];
                if (lane < kTile)
                    wy[k][lane] = bf16_round(weight(blockIdx.y * kTile + lane, q.y, q.z) * q.w);
                else
                    wx[k][lane - kTile] = bf16_round(weight(blockIdx.x * kTile + lane - kTile,
                                                            q.x, q.z));
            }
            __syncthreads();
            for (int k = 0; k < kb; ++k) sum = fmaf(wy[k][ly], wx[k][lx], sum);
            __syncthreads();
        }
    }
    const int row = blockIdx.y * kTile + ly, col = blockIdx.x * kTile + lx;
    if (row >= h || col >= w) return;
    float o = *flag ? __int_as_float(0x7fc00000) : sum;
    o = clamp_nan(o, 0.0f, 1.0f);
    const float keep = 1.0f - o;
    const int64_t at = ((int64_t)row * w + col) * 3;
    for (int c = 0; c < 3; ++c) out[at + c] = clamp_nan(img[at + c] * keep + boost[c] * o, 0.0f, 1.0f);
}

}  // namespace

// img and out (H, W, 3) fp32 contiguous; the particles' inputs as in
// Particles, contiguous; table (lobes, 4) fp32 on the host (read here, by
// value to the kernel); recs (P * lobes, 4) fp32 and rects (P * lobes, 4)
// int32 scratch; tiles 3 T + 2 int32 scratch (T tiles of kTile x kTile);
// lists 2 x capacity int32 scratch, capacity >= P * lobes x the most tiles a
// window overlaps (ops/splat.py).
extern "C" int splat_spray(const void* img, const void* x, const void* y, const void* z,
                           const void* dist, const void* world_r, const void* scales,
                           const void* dissolve, const void* visible, const void* custom_z,
                           const void* turns, const void* tan_half, const void* focal,
                           const void* boost, const float* table, int lobes, int particles,
                           int h, int w, float aspect, float max_alpha, void* recs, void* rects,
                           void* tiles, void* lists, long long capacity, void* out,
                           void* stream) {
    if (h <= 0 || w <= 0) return 0;
    if (lobes < 1 || lobes > kMaxLobes || particles < 0) return (int)cudaErrorInvalidValue;
    const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
    if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
    const int ntiles = tiles_x * tiles_y;
    const int n = particles * lobes;
    LobeTable tab{};
    for (int l = 0; l < lobes; ++l)
        for (int k = 0; k < 4; ++k) tab.v[l][k] = table[4 * l + k];
    Particles pt{(const float*)x, (const float*)y, (const float*)z, (const float*)dist,
                 (const float*)world_r, (const float*)scales, (const float*)dissolve,
                 (const unsigned char*)visible, (const float*)custom_z, (const float*)turns,
                 (const float*)tan_half, (const float*)focal};
    int* flag = (int*)tiles;
    int* counts = flag + 1;
    int* start = counts + ntiles;
    int* fill = start + ntiles + 1;
    int* list = (int*)lists;
    int* sorted = list + capacity;
    const auto st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(flag, 0, (size_t)(ntiles + 1) * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (n > 0)
        splat_setup_kernel<<<blocks, kThreads, 0, st>>>(
            pt, tab, lobes, particles, h, w, aspect, max_alpha, tiles_x, (float4*)recs,
            (int4*)rects, flag, counts);
    splat_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, start, fill, ntiles);
    if (n > 0)
        splat_scatter_kernel<<<blocks, kThreads, 0, st>>>((const int4*)rects, n, tiles_x, fill,
                                                          list);
    splat_gather_kernel<<<dim3((unsigned)tiles_x, (unsigned)tiles_y), kThreads, 0, st>>>(
        (const float*)img, (const float*)boost, (const float4*)recs, flag, start, list, sorted,
        (float*)out, n, h, w, tiles_x);
    return (int)cudaGetLastError();
}
