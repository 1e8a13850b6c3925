// The fan march's bracket select: each pixel's first crossing of its depth
// profile, with no (H/g, g, W, J) candidate tensor in device memory.
//
// Replaces no TPU kernel. The JAX package's fan march
// (godotoceanwaves_tpu/models/geometry.py _fan_select) writes the select as
// broadcast operations over (H/g, g, W, J) and leaves them to XLA, which
// fuses them into one loop. The port's plain route (ops/fan.py
// fan_tsel_plain) runs the same chain as separate PyTorch launches: at
// 1280x720 with g = 8 and J = 320 each of its tensors has 294,912,000
// elements, about 10.8 GB of device traffic a frame. This kernel is that
// fusion written by hand.
//
// The chain's answer, per pixel (row r, column c, group q = r / g):
//
//   tsel = min over j of tau_j where
//     fl(fl(s * tau_j) + cam_y) < fl(fl(w0 * hfan[i0, j]) + fl(w1 * hfan[i0 + 1, j]))
//     and tau_j > fl(t0 * dxz) and tau_j <= fl(t1 * dxz) and marchable,
//   +inf where no j qualifies.
//
// tau is strictly increasing (np.geomspace in fp32; tests/test_torch_fan.py
// holds every tier's table to it), so {j : tau_j > tau0} is a suffix of the
// table, {j : tau_j <= tau1} a prefix, and the smallest qualifying tau_j is
// tau at the first qualifying index. The kernel finds the suffix's start by
// binary search on the same fp32 compare, walks j up while tau_j <= tau1, and
// stops at the first crossing: the same value the chain's amin gives, bit for
// bit. Each product and sum is rounded as the chain rounds it, one operation
// at a time (__fmul_rn, __fadd_rn, and the build's -fmad=false). A NaN height,
// weight, slope or window compares false, as in the chain: a NaN bound leaves
// the search empty, a NaN profile or slope never crosses. A pixel that is not
// marchable, or whose window holds no tau, returns inf without reading the
// fan.
//
// The epilogue is the plain route's too: found = tsel finite (a crossing
// needs marchable); where found, t_hi = fl(tsel / dxz) and
// t_lo = max(t0, fl(t_hi * ratio)), NaN-propagating as torch.maximum; else
// t_hi = t1 and t_lo = t0.
//
// What bounds it: per pixel s, t0, t1 and dxz (16 B) and marchable (1 B)
// come in, found, t_lo and t_hi (9 B) go out, and i0, w0, w1 (16 B) once a
// group: ~26 MB a 1280x720 frame, ~8 us at 3.35 TB/s. The fan (phi x J fp32,
// 328 KB at 256 x 320) stays in L2. The worst case, every pixel walking all
// of J, is 295 M compares of ~6 fp32 operations each (1.8 GFLOP); a frame
// walks far fewer, since each walk ends at its crossing or its window's end
// (~16.5 M compares at 1280x720 on the frame cell's pose). The walks gather
// from the fan through L1, one thread a pixel. A block is 16 columns x 8
// rows, so with g = 8 a block's rows share one group and its 16 columns span
// few fan rows. Timed on the card, all bit-equal: 16 x 8 beat 32 x 8 by 28 %
// at 1280x720, and 8 x 8 and 16 x 16 by ~2 %; walks unrolled 2, 4 or 8
// deep, a start index from a log estimate, and tau or the block's fan rows
// staged in shared memory tied or lost (PERF.md, section 6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;
constexpr int kRows = 8;

struct Args {
    const float* hfan;          // (phi, taus)
    const float* tau;           // (taus,)
    const long long* i0;        // (h / g, w)
    const float* w0;            // (h / g, w)
    const float* w1;            // (h / g, w)
    const float* s;             // (h, w)
    const float* t0;
    const float* t1;
    const float* dxz;
    const uint8_t* marchable;   // bool
    const float* cam_y;         // 0-d, read on the device
    float* tsel;                // (h, w) or null
    uint8_t* found;             // bool
    float* t_lo;
    float* t_hi;
    float ratio;
    int phi, taus, g, h, w;
};

// torch.maximum: NaN if either is NaN, else the larger.
__device__ __forceinline__ float torch_max(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__global__ void __launch_bounds__(kCols * kRows) fan_kernel(Args a) {
    const int c = blockIdx.x * kCols + threadIdx.x;
    const int r = blockIdx.y * kRows + threadIdx.y;
    if (c >= a.w || r >= a.h) return;
    const int64_t p = (int64_t)r * a.w + c;
    const float t0 = a.t0[p], t1 = a.t1[p];
    float best = INFINITY;
    float dv = 1.0f;
    if (a.marchable[p]) {
        dv = a.dxz[p];
        const float tau0 = __fmul_rn(t0, dv), tau1 = __fmul_rn(t1, dv);
        // the first j with tau_j > tau0 (none: a NaN or too large tau0)
        int lo = 0, hi = a.taus;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(a.tau + mid) > tau0) hi = mid;
            else lo = mid + 1;
        }
        if (lo < a.taus && __ldg(a.tau + lo) <= tau1) {
            const int64_t q = (int64_t)(r / a.g) * a.w + c;
            // a NaN group mean makes both weights NaN and the index
            // arbitrary: clamp it for the loads, the NaN product decides
            long long i = a.i0[q];
            i = i < 0 ? 0 : (i > a.phi - 2 ? a.phi - 2 : i);
            const float* h0 = a.hfan + i * a.taus;
            const float* h1 = h0 + a.taus;
            const float w0 = a.w0[q], w1 = a.w1[q];
            const float sv = a.s[p], cy = __ldg(a.cam_y);
            for (int j = lo; j < a.taus; ++j) {
                const float tj = __ldg(a.tau + j);
                if (!(tj <= tau1)) break;
                const float z = __fadd_rn(__fmul_rn(sv, tj), cy);
                const float prof = __fadd_rn(__fmul_rn(w0, __ldg(h0 + j)),
                                             __fmul_rn(w1, __ldg(h1 + j)));
                if (z < prof) {
                    best = tj;
                    break;
                }
            }
        }
    }
    if (a.tsel) a.tsel[p] = best;
    const bool found = best < INFINITY;
    a.found[p] = found;
    if (found) {
        const float t_hi = __fdiv_rn(best, dv);
        a.t_hi[p] = t_hi;
        a.t_lo[p] = torch_max(t0, __fmul_rn(t_hi, a.ratio));
    } else {
        a.t_hi[p] = t1;
        a.t_lo[p] = t0;
    }
}

}  // namespace

// The bracket select of one frame or band (see the head of this file). The
// row group g is h / (rows of i0); every pointer is to contiguous data; tsel
// may be null. Returns the launch's cudaError.
extern "C" int fan_bracket(const void* hfan, const void* tau, const void* i0, const void* w0,
                           const void* w1, const void* s, const void* t0, const void* t1,
                           const void* dxz, const void* marchable, const void* cam_y,
                           float ratio, int phi, int taus, int g, int h, int w, void* tsel,
                           void* found, void* t_lo, void* t_hi, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    if (phi < 2 || taus < 1 || g < 1 || h % g != 0) return (int)cudaErrorInvalidValue;
    const unsigned gy = (unsigned)((h + kRows - 1) / kRows);
    if (gy > 65535u) return (int)cudaErrorInvalidValue;
    const Args a{(const float*)hfan, (const float*)tau, (const long long*)i0, (const float*)w0,
                 (const float*)w1, (const float*)s, (const float*)t0, (const float*)t1,
                 (const float*)dxz, (const uint8_t*)marchable, (const float*)cam_y,
                 (float*)tsel, (uint8_t*)found, (float*)t_lo, (float*)t_hi, ratio,
                 phi, taus, g, h, w};
    const dim3 grid((unsigned)((w + kCols - 1) / kCols), gy);
    fan_kernel<<<grid, dim3(kCols, kRows), 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
