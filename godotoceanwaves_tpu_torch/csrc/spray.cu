// The spray step: every particle of the sea-spray state machine advanced in
// one launch, one thread a particle.
//
// Replaces no TPU kernel. The JAX package's spray step
// (godotoceanwaves_tpu/models/spray.py spray_step) is elementwise work over
// the particles and a bilinear gather from the maps, left to XLA's fusion.
// The port's plain route (models/spray.py spray_step_plain) runs the same
// chain as ~440 separate PyTorch launches: the int64 emulation of the uint32
// hash, a (3, N, N) fp32 copy of each cascade's normal and displacement
// planes before each gather, and ~40 wheres, stacks and shaping operations.
// This kernel is that fusion written by hand.
//
// What a thread does, in the plain route's order (sea_spray_particle.gdshader
// line refs in models/spray.py):
//   expiry: now > fl(start_time + lifetime) respawns the particle into the
//     next cycle: the hash of (idx + cycle P, 1 + cycle + seed) in native
//     uint32 arithmetic (:31-38; the plain route's int64 words masked to 32
//     bits wrap the same), the ragged grid of floor(sqrt(P)) columns with the
//     last partial row's overshoot (docs/PARITY.md), lifetime and start time;
//   activation: where the particle starts now, bilinear taps of normal
//     channels 0, 1 and 3 of each cascade at xz * scale (repeat wrap, the
//     half-texel centre), the gradient summed over the cascades in order,
//     normal.y = 1 / |(-gx, 1, -gz)|, normal_factor, foam_factor and the
//     activation test with its vacuous upper band (docs/PARITY.md);
//   animation: t, the three cascades' displacement taps times (0.75, 1,
//     0.75), the parabola, size, the scale envelope, dissolve and visible.
// A particle that does not start this step skips the normal taps: the plain
// route computes them for every particle and keeps them only where one
// starts, so the outputs are the same.
//
// Precision: the plain route's. Each product, sum and quotient is rounded as
// its separate launch rounds it (__fmul_rn, __fadd_rn, __fdiv_rn, and the
// build's -fmad=false for the rest); a texel is widened to fp32 exactly, as
// `.float()` does; expf, log1pf and sqrtf are the libm functions PyTorch's
// kernels call. A Python number that the plain route divides by reaches the
// card as the fp32 reciprocal PyTorch's CUDA division multiplies by, and the
// other Python numbers as fp32: the wrapper rounds them (ops/spray.py). The
// state and attributes equal the plain route's on the card bit for bit
// (tests/test_torch_cuda.py).
//
// What bounds it: per particle ~46 B of state in and out, 29 B of
// attributes, and 3 cascades x 24 texels (2-byte maps) gathered, ~265 B:
// ~8.7 MB a step at 32768 particles, ~2.6 us at 3.35 TB/s. The gathers of
// neighbouring particles (a 181 x 181 grid) fall on neighbouring texels
// through L1 and L2; one launch of 256 blocks is latency-bound, and each
// thread's taps are independent loads in flight together.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// The SprayParams numbers as the plain route's launches see them (fp32).
enum {
    K_INV_GRID = 0,    // 1 / (floor(sqrt(P)) - 1)
    K_EXTENT,          // emitter_extent
    K_LIFETIME,        // lifetime
    K_LIFETIME_RAND,   // lifetime * lifetime_randomness (a Python product)
    K_SYSTEM,          // system_lifetime
    K_INV_LIFETIME,    // 1 / lifetime
    K_INV_BAND,        // 1 / (0.99 - 0.92)
    K_INV_FOAM,        // 1 / (1.0 - 0.9)
    K_PSCALE,          // particle_scale x, y, z
    NUM_CONSTS = K_PSCALE + 3
};

struct Maps {
    const void* disp;       // (C, 3, N, N)
    const void* normal;     // (C, 4, N, N)
    long long ds[4];        // disp's element strides: cascade, channel, row, column
    long long ns[4];
    const float* scales;    // (C, 4): 1/Lx, 1/Ly, displacement scale, normal scale
    int cascades, n;
};

struct Args {
    // the state in
    const float* start_pos;     // (P, 3)
    const float* start_time;
    const float* lifetime;
    const float* custom_z;
    const float* scale_factor;
    const float* base_scale;    // (P, 3)
    const uint8_t* active;
    const uint8_t* has_started;
    const int* cycle;
    const float* now;           // 0-d, read on the device
    Maps maps;
    float k[NUM_CONSTS];
    int particles, grid;
    unsigned seed1;             // 1 + seed, mod 2^32
    // the state out
    float* o_start_pos;
    float* o_start_time;
    float* o_lifetime;
    float* o_custom_z;
    float* o_scale_factor;
    float* o_base_scale;
    uint8_t* o_active;
    uint8_t* o_has_started;
    int* o_cycle;
    // the attributes
    float* position;            // (P, 3)
    float* scale;               // (P, 3)
    float* dissolve;
    uint8_t* visible;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// fl(x - y): a sum with the negation (exact), as PyTorch's sub rounds it.
__device__ __forceinline__ float sub_rn(float x, float y) { return __fadd_rn(x, -y); }

// The hash's uniform: (word >> 1) to fp32, times 2^-31 (exact).
__device__ __forceinline__ float unit(unsigned w) {
    return __fmul_rn(__uint2float_rn(w >> 1), 0x1p-31f);
}

// torch.clamp_max(x, hi) and torch.clamp(x, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clamp_max(float x, float hi) {
    return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// iq's impulse h exp(1 - h), h = k x (gdshader:69-72).
__device__ __forceinline__ float exp_impulse(float x, float k) {
    const float h = __fmul_rn(x, k);
    return __fmul_rn(h, expf(sub_rn(1.0f, h)));
}

// torch.remainder on int64: the sign of n.
__device__ __forceinline__ long long wrap(long long i, int n) {
    const long long r = i % n;
    return r < 0 ? r + n : r;
}

// One cascade's tap coordinates (shading.sample_bilinear): the four texel
// offsets within a plane and the weights 1 - fx, fx, 1 - fy, fy.
struct Tap {
    long long o00, o10, o01, o11;
    float wx0, wx1, wy0, wy1;
};

__device__ __forceinline__ Tap tap_at(float x, float z, float sx, float sz, int n,
                                      long long row, long long col) {
    const float nf = (float)n;
    const float xu = sub_rn(__fmul_rn(__fmul_rn(x, sx), nf), 0.5f);
    const float yv = sub_rn(__fmul_rn(__fmul_rn(z, sz), nf), 0.5f);
    const float flx = floorf(xu), fly = floorf(yv);
    const float fx = sub_rn(xu, flx), fy = sub_rn(yv, fly);
    const long long ix = (long long)flx, iy = (long long)fly;
    const long long x0 = wrap(ix, n) * col, x1 = wrap(ix + 1, n) * col;
    const long long y0 = wrap(iy, n) * row, y1 = wrap(iy + 1, n) * row;
    Tap t;
    t.o00 = y0 + x0;
    t.o10 = y0 + x1;
    t.o01 = y1 + x0;
    t.o11 = y1 + x1;
    t.wx0 = sub_rn(1.0f, fx);
    t.wx1 = fx;
    t.wy0 = sub_rn(1.0f, fy);
    t.wy1 = fy;
    return t;
}

// The bilinear sample of one plane: (t00 wx0 + t10 wx1) wy0 + (t01 wx0 + t11 wx1) wy1.
template <typename T>
__device__ __forceinline__ float sample(const T* plane, const Tap& t) {
    const float top = __fadd_rn(__fmul_rn(widen(plane[t.o00]), t.wx0),
                                __fmul_rn(widen(plane[t.o10]), t.wx1));
    const float bot = __fadd_rn(__fmul_rn(widen(plane[t.o01]), t.wx0),
                                __fmul_rn(widen(plane[t.o11]), t.wx1));
    return __fadd_rn(__fmul_rn(top, t.wy0), __fmul_rn(bot, t.wy1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spray_kernel(Args a) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= a.particles) return;
    const long long i3 = 3LL * i;
    const float now = __ldg(a.now);
    const float* k = a.k;

    // --- expiry and respawn (gdshader:45-66) ---
    float sp[3] = {a.start_pos[i3], a.start_pos[i3 + 1], a.start_pos[i3 + 2]};
    float st = a.start_time[i], lt = a.lifetime[i], cz = a.custom_z[i];
    const bool expired = now > __fadd_rn(st, lt);
    const int cycle = (int)((unsigned)a.cycle[i] + (expired ? 1u : 0u));
    bool active = a.active[i] && !expired;
    bool has_started = a.has_started[i] && !expired;
    if (expired) {
        const unsigned px = (unsigned)i + (unsigned)cycle * (unsigned)a.particles;
        const unsigned py = (unsigned)cycle + a.seed1;
        const unsigned qx = ((px >> 1) ^ py) * 1103515245u;
        const unsigned qy = ((py >> 1) ^ px) * 1103515245u;
        const unsigned h = (qx ^ (qy >> 3)) * 1103515245u;
        const unsigned w = h ^ (h >> 16);
        const float r0 = unit(w), r1 = unit(w * 16807u), r2 = unit(w * 48271u);
        const float gx = (float)(i / a.grid), gy = (float)(i % a.grid);
        sp[0] = __fmul_rn(__fmul_rn(sub_rn(__fmul_rn(gx, k[K_INV_GRID]), 0.5f), 2.0f),
                          k[K_EXTENT]);
        sp[1] = 0.0f;
        sp[2] = __fmul_rn(__fmul_rn(sub_rn(__fmul_rn(gy, k[K_INV_GRID]), 0.5f), 2.0f),
                          k[K_EXTENT]);
        lt = sub_rn(k[K_LIFETIME], __fmul_rn(r1, k[K_LIFETIME_RAND]));
        st = __fadd_rn(now, __fmul_rn(r2, sub_rn(k[K_SYSTEM], lt)));
        cz = r0;
    }
    const bool started_now = now >= st && !has_started;
    const Maps& m = a.maps;
    const T* disp = static_cast<const T*>(m.disp);
    const T* normal = static_cast<const T*>(m.normal);

    // --- activation (gdshader:76-95), kept only where the particle starts ---
    float sf = a.scale_factor[i];
    float base[3] = {a.base_scale[i3], a.base_scale[i3 + 1], a.base_scale[i3 + 2]};
    if (started_now) {
        float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
        for (int c = 0; c < m.cascades; ++c) {
            const Tap t = tap_at(sp[0], sp[2], __ldg(m.scales + 4 * c), __ldg(m.scales + 4 * c + 1),
                                 m.n, m.ns[2], m.ns[3]);
            const T* nc = normal + c * m.ns[0];
            g0 = __fadd_rn(g0, sample(nc, t));
            g1 = __fadd_rn(g1, sample(nc + m.ns[1], t));
            g2 = __fadd_rn(g2, sample(nc + 3 * m.ns[1], t));
        }
        // |(-g0, 1, -g1)|^2 in the order of PyTorch's CUDA sum over a last
        // dim of 3 (two lanes, x, z then y: (x^2 + z^2) + 1), then
        // normal.y = 1 / |n|
        const float len2 = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)), 1.0f);
        const float ny = __fdiv_rn(1.0f, sqrtf(len2));
        const float foam = g2;
        // Reference quirk (gdshader:87-90): normal_factor <= 1 always; the
        // activation band is [~0.8967, 1] in normal.y (docs/PARITY.md).
        const float nf = __fadd_rn(__fmul_rn(clamp_max(__fmul_rn(sub_rn(ny, 0.92f),
                                                                 k[K_INV_BAND]), 1.0f), 0.75f),
                                   0.25f);
        const float ff = __fadd_rn(__fmul_rn(clamp_max(__fmul_rn(sub_rn(foam, 0.9f),
                                                                 k[K_INV_FOAM]), 1.0f), 0.75f),
                                   0.25f);
        const bool activate = nf >= 0.0f && nf <= 1.0f && foam > 0.9f;
        active = activate;
        sf = __fmul_rn(nf, ff);
        const float amp = __fmul_rn(ff, __fadd_rn(activate ? 1.0f : 0.0f, 1e-3f));
        base[0] = __fmul_rn(__fmul_rn(amp, 1.0f), k[K_PSCALE]);
        base[1] = __fmul_rn(__fmul_rn(amp, nf), k[K_PSCALE + 1]);
        base[2] = __fmul_rn(__fmul_rn(amp, 1.0f), k[K_PSCALE + 2]);
    }
    has_started = has_started || started_now;

    // --- alive-particle animation (gdshader:98-125) ---
    const float t = clamp(__fdiv_rn(sub_rn(now, st), lt), 0.0f, 1.0f);
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    for (int c = 0; c < m.cascades; ++c) {
        const float* s = m.scales + 4 * c;
        const Tap tp = tap_at(sp[0], sp[2], __ldg(s), __ldg(s + 1), m.n, m.ds[2], m.ds[3]);
        const T* dc = disp + c * m.ds[0];
        const float s2 = __ldg(s + 2);
        d0 = __fadd_rn(d0, __fmul_rn(sample(dc, tp), s2));
        d1 = __fadd_rn(d1, __fmul_rn(sample(dc + m.ds[1], tp), s2));
        d2 = __fadd_rn(d2, __fmul_rn(sample(dc + 2 * m.ds[1], tp), s2));
    }
    d0 = __fmul_rn(d0, 0.75f);
    d1 = __fmul_rn(d1, 1.0f);
    d2 = __fmul_rn(d2, 0.75f);
    const float q = sub_rn(__fmul_rn(t, 2.5f), 0.45f);
    const float parabola = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(q, q), -5.0f), sf), 0.5f);
    const float rel = __fmul_rn(lt, k[K_INV_LIFETIME]);
    const float size = __fmul_rn(rel, rel);
    const float grow = __fmul_rn(log1pf(t), size);
    const float lift = __fmul_rn(exp_impulse(t, 3.0f), size);

    a.o_start_pos[i3] = sp[0];
    a.o_start_pos[i3 + 1] = sp[1];
    a.o_start_pos[i3 + 2] = sp[2];
    a.o_start_time[i] = st;
    a.o_lifetime[i] = lt;
    a.o_custom_z[i] = cz;
    a.o_scale_factor[i] = sf;
    a.o_base_scale[i3] = base[0];
    a.o_base_scale[i3 + 1] = base[1];
    a.o_base_scale[i3 + 2] = base[2];
    a.o_active[i] = active;
    a.o_has_started[i] = has_started;
    a.o_cycle[i] = cycle;
    a.position[i3] = __fadd_rn(__fadd_rn(sp[0], d0), 0.0f);
    a.position[i3 + 1] = __fadd_rn(__fadd_rn(sp[1], d1), parabola);
    a.position[i3 + 2] = __fadd_rn(__fadd_rn(sp[2], d2), 0.0f);
    a.scale[i3] = __fmul_rn(base[0], grow);
    a.scale[i3 + 1] = __fmul_rn(base[1], lift);
    a.scale[i3 + 2] = __fmul_rn(base[2], grow);
    a.dissolve[i] = exp_impulse(t, 10.0f);
    a.visible[i] = active && has_started && now >= st;
}

}  // namespace

// One spray step of `particles` particles (see the head of this file). The
// state's pointers are to contiguous data; the maps are addressed by their
// element strides (`strides`: disp's cascade, channel, row and column, then
// normal's), of one dtype (0 fp32, 1 bf16, 2 fp16); `consts` holds the
// NUM_CONSTS numbers in the enum's order; `now` is a 0-d fp32 on the card.
// Returns the launch's cudaError.
extern "C" int spray_step(const void* start_pos, const void* start_time, const void* lifetime,
                          const void* custom_z, const void* scale_factor, const void* base_scale,
                          const void* active, const void* has_started, const void* cycle,
                          const void* disp, const void* normal, const long long* strides,
                          int dtype, int cascades, int n, const void* scales, const void* now,
                          const float* consts, int particles, int grid, unsigned seed1,
                          void* o_start_pos, void* o_start_time, void* o_lifetime,
                          void* o_custom_z, void* o_scale_factor, void* o_base_scale,
                          void* o_active, void* o_has_started, void* o_cycle, void* position,
                          void* scale, void* dissolve, void* visible, void* stream) {
    if (particles <= 0) return 0;
    if (cascades < 1 || n < 1 || grid < 1 || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    Args a{};
    a.start_pos = (const float*)start_pos;
    a.start_time = (const float*)start_time;
    a.lifetime = (const float*)lifetime;
    a.custom_z = (const float*)custom_z;
    a.scale_factor = (const float*)scale_factor;
    a.base_scale = (const float*)base_scale;
    a.active = (const uint8_t*)active;
    a.has_started = (const uint8_t*)has_started;
    a.cycle = (const int*)cycle;
    a.now = (const float*)now;
    a.maps.disp = disp;
    a.maps.normal = normal;
    for (int j = 0; j < 4; ++j) {
        a.maps.ds[j] = strides[j];
        a.maps.ns[j] = strides[4 + j];
    }
    a.maps.scales = (const float*)scales;
    a.maps.cascades = cascades;
    a.maps.n = n;
    for (int j = 0; j < NUM_CONSTS; ++j) a.k[j] = consts[j];
    a.particles = particles;
    a.grid = grid;
    a.seed1 = seed1;
    a.o_start_pos = (float*)o_start_pos;
    a.o_start_time = (float*)o_start_time;
    a.o_lifetime = (float*)o_lifetime;
    a.o_custom_z = (float*)o_custom_z;
    a.o_scale_factor = (float*)o_scale_factor;
    a.o_base_scale = (float*)o_base_scale;
    a.o_active = (uint8_t*)o_active;
    a.o_has_started = (uint8_t*)o_has_started;
    a.o_cycle = (int*)o_cycle;
    a.position = (float*)position;
    a.scale = (float*)scale;
    a.dissolve = (float*)dissolve;
    a.visible = (uint8_t*)visible;
    const unsigned blocks = (unsigned)((particles + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        spray_kernel<float><<<blocks, kThreads, 0, s>>>(a);
    else if (dtype == 1)
        spray_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(a);
    else
        spray_kernel<__half><<<blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
}
