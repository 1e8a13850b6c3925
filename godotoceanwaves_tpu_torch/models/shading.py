"""Water-surface shading math (reference C12) in PyTorch.

Counterpart of `godotoceanwaves_tpu/models/shading.py`: cascade summation
with per-cascade map scales, bicubic B-spline filtering with the
pixels-per-meter bilinear blend, Jacobian-foam albedo, fresnel, GGX + Smith
specular, the SSS-ish diffuse term, the procedural sky and the scene's
environment post (assets/shaders/spatial/water.gdshader, main.tscn).

Samplers. "gather" reads texels by index in fp32, as the JAX package's
gather sampler does. "mxu" keeps the NUMBERS of the JAX package's
hat-weight sampler (tables and weights rounded to bf16, fp32 accumulation)
but not its dense (P, N) weight matrices, which exist there only because
TPU gathers are slow: `_mxu_tap` and `cascade_displacement_grid` read the 2
(bilinear) or 4 (cubic) texels per axis whose weight is nonzero, with the
same circular-distance weights. Zero terms change no fp32 sum, so only the
order of the nonzero terms differs.

Gradient LOD. `cascade_gradient_lod` with tap_impl="einsum" is the plain
version of the gradient-tap kernel (`ops/tap.py`, `csrc/tap.cu`, which
replaces `godotoceanwaves_tpu/ops/pallas_tap.py` `fused_tap`): the JAX
package's band scan, mip switch, slab windows and einsum taps, transcribed.
It reads the band levels and slab choices on the host, one sync per
(band, cascade); the kernel takes every band and cascade in one launch.

Conventions: world-space, y up; `maps` are the channel-first OceanMaps
planes; UV = world xz (water.gdshader:28). Device-side constants are made
once per device (`_const`), so a frame makes no host-to-device copy.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils import graphs

REFLECTANCE = 0.02           # air->water, eta=1.33 (water.gdshader:9)
DEFAULT_WATER_COLOR = (0.1, 0.15, 0.18)    # water.gd:15
DEFAULT_FOAM_COLOR = (0.73, 0.67, 0.62)    # water.gd:17
SSS_MODIFIER = (0.9, 1.15, 0.85)           # water.gdshader:122
FOG_LIGHT_COLOR = (0.272954, 0.419272, 0.484632)   # main.tscn:27


@functools.lru_cache(maxsize=256)
def _const_table(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A small fp32 constant on `device`, copied there once (a CUDA graph
    that reads it holds it: `graphs.keep`). Shared: never write to it."""
    return graphs.keep(_const_table(values, device))


def _rgb(color, device: torch.device) -> torch.Tensor:
    """A colour as a (3,) fp32 tensor on `device`: a tensor moves (no copy
    where it is), host numbers (rounded to fp32) are a `_const`."""
    if isinstance(color, torch.Tensor):
        return color.to(device=device, dtype=torch.float32)
    return _const(tuple(float(v) for v in np.asarray(color, np.float32).reshape(3)), device)


def _f32(x: float) -> float:
    """A Python scalar rounded to fp32, as JAX rounds a weak-typed scalar."""
    return float(np.float32(x))


def _fmod_pos(f: torch.Tensor, n: int) -> torch.Tensor:
    """`jnp.mod(f, n)` for n > 0: fmod, then + n where the remainder is
    negative."""
    r = torch.fmod(f, n)
    return torch.where(r < 0, r + n, r)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


# --- texture sampling -------------------------------------------------------

def sample_bilinear(planes: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (ch, N, N) planes at uv (tile units, wrapped).

    uv[..., 0] is the x/u coordinate (last array axis). Matches GL
    repeat-wrap + half-texel center convention. Returns (ch, ...).
    """
    n = planes.shape[-1]
    xy = uv * n - 0.5
    fl = torch.floor(xy)
    f = xy - fl
    i0 = fl.long()
    ix0 = torch.remainder(i0[..., 0], n)
    iy0 = torch.remainder(i0[..., 1], n)
    ix1 = torch.remainder(i0[..., 0] + 1, n)
    iy1 = torch.remainder(i0[..., 1] + 1, n)
    fx = f[..., 0]
    fy = f[..., 1]

    def tap(iy, ix):
        return planes[:, iy, ix]

    t00, t10 = tap(iy0, ix0), tap(iy0, ix1)
    t01, t11 = tap(iy1, ix0), tap(iy1, ix1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def cubic_weights(a: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Cubic B-spline filter weights (water.gdshader:42-52)."""
    a2 = a * a
    a3 = a2 * a
    w0 = (-a3 + a2 * 3.0 - a * 3.0 + 1.0) / 6.0
    w1 = (a3 * 3.0 - a2 * 6.0 + 4.0) / 6.0
    w2 = (-a3 * 3.0 + a2 * 3.0 + a * 3.0 + 1.0) / 6.0
    w3 = a3 / 6.0
    return w0, w1, w2, w3


def sample_bicubic(planes: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bicubic B-spline via 4 bilinear taps (water.gdshader:55-70): the
    GPU-Gems-2 grouping of the 4x4 footprint into 4 bilinear fetches."""
    n = planes.shape[-1]
    xy = uv * n + 0.5
    fuv = xy - torch.floor(xy)
    wx0, wx1, wx2, wx3 = cubic_weights(fuv[..., 0])
    wy0, wy1, wy2, wy3 = cubic_weights(fuv[..., 1])
    gx0, gx1 = wx0 + wx1, wx2 + wx3
    gy0, gy1 = wy0 + wy1, wy2 + wy3
    hx0 = (wx1 / gx0 - 1.5 + torch.floor(xy[..., 0])) / n
    hx1 = (wx3 / gx1 + 0.5 + torch.floor(xy[..., 0])) / n
    hy0 = (wy1 / gy0 - 1.5 + torch.floor(xy[..., 1])) / n
    hy1 = (wy3 / gy1 + 0.5 + torch.floor(xy[..., 1])) / n
    wxb = gx0 / (gx0 + gx1)
    wyb = gy0 / (gy0 + gy1)

    def at(hx, hy):
        return sample_bilinear(planes, torch.stack([hx, hy], dim=-1))

    top = at(hx1, hy1) * (1 - wxb) + at(hx0, hy1) * wxb
    bot = at(hx1, hy0) * (1 - wxb) + at(hx0, hy0) * wxb
    return top * (1 - wyb) + bot * wyb


# --- "mxu" sampling: bf16 tables and weights, fp32 accumulation ---------------

def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - d, 0.0)


def _cubic(d: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: PyTorch's CUDA kernels turn division by a Python
    # scalar into multiplication by its reciprocal, which moves a weight by
    # an ulp and can flip its bf16 rounding
    six = torch.full((), 6.0, dtype=d.dtype, device=d.device)
    d2 = d * d
    d3 = d2 * d
    near = (4.0 - 6.0 * d2 + 3.0 * d3) / six          # d < 1
    c = torch.clamp_min(2.0 - d, 0.0)
    farr = c * (c * c) / six                          # 1 <= d < 2
    return torch.where(d < 1.0, near, farr)


def _wrap_weights(f: torch.Tensor, n: int, cubic: bool) -> torch.Tensor:
    """(..., n) dense interpolation weights at absolute texel coordinate f
    (circular distance: 2-sparse linear hats or 4-sparse cubic B-spline
    rows), rounded to bf16. The dense form, for the einsum taps."""
    fw = _fmod_pos(f, n)
    iota = torch.arange(n, dtype=torch.float32, device=f.device)
    d = torch.abs(fw[..., None] - iota)
    d = torch.minimum(d, n - d)
    return (_cubic(d) if cubic else _hat(d)).to(torch.bfloat16)


def _wrap_taps(f: torch.Tensor, n: int, cubic: bool):
    """The nonzero entries of `_wrap_weights(f, n, cubic)`: lists of
    (texel index (long), weight (fp32 holding the bf16 value)), 2 or 4 per
    point, from the same fp32 distance arithmetic."""
    fw = _fmod_pos(f, n)
    base = torch.floor(fw).long()
    taps = []
    for off in ((-1, 0, 1, 2) if cubic else (0, 1)):
        idx = torch.remainder(base + off, n)
        d = torch.abs(fw - idx.float())
        d = torch.minimum(d, n - d)
        w = (_cubic(d) if cubic else _hat(d)).to(torch.bfloat16).float()
        taps.append((idx, w))
    return taps


def _mxu_tap(planes: torch.Tensor, uv: torch.Tensor, cubic: bool) -> torch.Tensor:
    """Separable weighted sample of (ch, N, N) planes at uv -> (ch, ...):
    bf16 table and weights, fp32 sums over the nonzero texels."""
    n = planes.shape[-1]
    tb = planes.to(torch.bfloat16)
    xy = uv * n - 0.5
    wx = _wrap_taps(xy[..., 0], n, cubic)
    wy = _wrap_taps(xy[..., 1], n, cubic)
    out = None
    for ix, w_x in wx:
        rows = None
        for iy, w_y in wy:
            term = w_y * tb[:, iy, ix].float()
            rows = term if rows is None else rows + term
        term = rows * w_x
        out = term if out is None else out + term
    return out


def sample_bilinear_mxu(planes: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """"mxu" twin of `sample_bilinear` (bf16 weights/planes, fp32 accum)."""
    return _mxu_tap(planes, uv, cubic=False)


def sample_bicubic_mxu(planes: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """"mxu" twin of `sample_bicubic`: the 4-sparse cubic B-spline rows."""
    return _mxu_tap(planes, uv, cubic=True)


def _samplers(sampler: str):
    if sampler == "mxu":
        return sample_bilinear_mxu, sample_bicubic_mxu
    return sample_bilinear, sample_bicubic


# --- vertex stage: cascade displacement sum (water.gdshader:27-39) ----------

def cascade_displacement(displacement_maps: torch.Tensor, map_scales: torch.Tensor,
                         xz: torch.Tensor, camera_xz=None,
                         sampler: str = "gather") -> torch.Tensor:
    """Summed world displacement at positions xz (..., 2) -> (..., 3).

    displacement_maps: (C, 3, N, N); map_scales: (C, 4) [1/Lx, 1/Ly, dscale, -].
    Distance falloff after 150 m (water.gdshader:30) if camera_xz given.
    """
    bilinear, _ = _samplers(sampler)
    disp = torch.zeros(xz.shape[:-1] + (3,), dtype=torch.float32, device=xz.device)
    for i in range(displacement_maps.shape[0]):
        s = map_scales[i]
        uv = xz * s[:2]
        tap = bilinear(displacement_maps[i].float(), uv)
        disp = disp + torch.movedim(tap, 0, -1) * s[2]
    if camera_xz is not None:
        d = _norm(xz - camera_xz)
        disp = disp * torch.clamp_max(torch.exp(-(d - 150.0) * 0.007), 1.0)
    return disp


def cascade_displacement_grid(displacement_maps: torch.Tensor,
                              map_scales: torch.Tensor, coords: torch.Tensor,
                              center_xz: torch.Tensor, camera_xz=None) -> torch.Tensor:
    """`cascade_displacement` ("mxu" numbers) on the tensor-product grid
    coords x coords: sampling factorizes into one 2-tap read per axis per
    cascade. Returns (k, k, 3) indexed [z_row, x_col], matching
    `cascade_displacement` on meshgrid(coords, coords, indexing="xy")."""
    k = coords.shape[0]
    n = displacement_maps.shape[-1]
    disp = torch.zeros((k, k, 3), dtype=torch.float32, device=coords.device)
    wx_world = coords + center_xz[0]
    wz_world = coords + center_xz[1]
    for i in range(displacement_maps.shape[0]):
        s = map_scales[i]
        fx = wx_world * s[0] * n - 0.5
        fz = wz_world * s[1] * n - 0.5
        planes = displacement_maps[i].to(torch.bfloat16)          # (3, N, N)
        (iz0, wz0), (iz1, wz1) = _wrap_taps(fz, n, cubic=False)
        rows = (wz0[:, None] * planes[:, iz0].float()
                + wz1[:, None] * planes[:, iz1].float())          # (3, k, N)
        (ix0, wx0), (ix1, wx1) = _wrap_taps(fx, n, cubic=False)
        tap = rows[:, :, ix0] * wx0 + rows[:, :, ix1] * wx1      # (3, k, k)
        disp = disp + torch.movedim(tap, 0, -1) * s[2]
    if camera_xz is not None:
        dx = wx_world - camera_xz[0]
        dz = wz_world - camera_xz[1]
        d = torch.sqrt(dx[None, :, None] ** 2 + dz[:, None, None] ** 2)
        disp = disp * torch.clamp_max(torch.exp(-(d - 150.0) * 0.007), 1.0)
    return disp


# --- fragment stage: gradient/foam accumulation (water.gdshader:72-94) ------

def _channel_scale(s: torch.Tensor) -> torch.Tensor:
    """(normal_scale, normal_scale, 1): the .xyw channels' scale."""
    return torch.cat([s[3:4], s[3:4], torch.ones_like(s[:1])])


def _gradient_planes(normal_maps: torch.Tensor) -> torch.Tensor:
    """The (grad_x, grad_y, foam) = .xyw channels of (C, 4, N, N) maps, fp32."""
    return torch.cat([normal_maps[:, 0:2], normal_maps[:, 3:4]], dim=1).float()


def cascade_gradient(normal_maps: torch.Tensor, map_scales: torch.Tensor,
                     xz: torch.Tensor, sampler: str = "gather") -> torch.Tensor:
    """Summed (dh/dx, dh/dz, foam) at xz -> (..., 3).

    Blends bicubic with bilinear by world pixels-per-meter (gdshader:76-82);
    channels sampled are .xyw = (grad_x, grad_y, foam), scaled by
    (normal_scale, normal_scale, 1).
    """
    bilinear, bicubic = _samplers(sampler)
    n = normal_maps.shape[-1]
    planes_all = _gradient_planes(normal_maps)
    grad = torch.zeros(xz.shape[:-1] + (3,), dtype=torch.float32, device=xz.device)
    for i in range(normal_maps.shape[0]):
        s = map_scales[i]
        planes = planes_all[i]
        if sampler == "mxu":
            tap = _gradient_tap(planes, s, xz)
        else:
            uv = xz * s[:2]
            ppm = n * torch.minimum(s[0], s[1])
            mix_t = torch.clamp_max(ppm * 0.1, 1.0)
            tap = bicubic(planes, uv) * (1 - mix_t) + bilinear(planes, uv) * mix_t
        grad = grad + torch.movedim(tap, 0, -1) * _channel_scale(s)
    return grad


def _gradient_tap(planes: torch.Tensor, s: torch.Tensor, xz: torch.Tensor) -> torch.Tensor:
    """One cascade's blended gradient tap at world xz on the "mxu" sampler.

    planes: (3, R, R); s: the cascade's map_scales row. The reference's
    bicubic<->bilinear blend by pixels-per-meter (water.gdshader:76-82)
    against THIS table's resolution; when the blend factor saturates at 1
    the result is the bilinear tap alone (the JAX package's lax.cond; here
    a choice on the device between the two, both computed, so nothing is
    read back to the host). Returns (3, ...).
    """
    n = planes.shape[-1]
    uv = xz * s[:2]
    ppm = n * torch.minimum(s[0], s[1])
    mix_t = torch.clamp_max(ppm * 0.1, 1.0)
    linear = sample_bilinear_mxu(planes, uv)
    blend = sample_bicubic_mxu(planes, uv) * (1 - mix_t) + linear * mix_t
    return torch.where(mix_t >= 1.0, linear, blend)


def _window_weights(rel: torch.Tensor, m: int, cubic: bool) -> torch.Tensor:
    """(..., m) interpolation weights at WINDOW-relative coordinate rel
    (non-circular twin of `_wrap_weights`: the caller guarantees the whole
    2-/4-sparse footprint lies inside the m-row window)."""
    iota = torch.arange(m, dtype=torch.float32, device=rel.device)
    d = torch.abs(rel[..., None] - iota)
    return (_cubic(d) if cubic else _hat(d)).to(torch.bfloat16)


def _slab_tap(planes_pad: torch.Tensor, s: torch.Tensor, xz: torch.Tensor,
              slab: int) -> torch.Tensor:
    """`_gradient_tap` with the v-axis contraction cropped to a `slab`-row
    window of the (v-duplicated) table, in the JAX package's einsum form.

    planes_pad: (3, 2R, R), the table duplicated along v so any R-row
    window is contiguous. The caller guarantees max(fv) - min(fv) + 4 <=
    slab. The x axis keeps the circular weights. Same blend and saturated
    choice as `_gradient_tap`. Returns (3, ...).
    """
    n = planes_pad.shape[-1]
    uv = xz * s[:2]
    fx = uv[..., 0] * n - 0.5
    fv = uv[..., 1] * n - 0.5          # unwrapped: contiguous per band
    v0 = torch.floor(fv.min()) - 1.0   # cubic footprint margin
    rel = fv - v0                      # in [1, extent + 2)
    start = torch.remainder(v0.to(torch.int32), n)
    rows_idx = start + torch.arange(slab, device=xz.device)
    win16 = planes_pad.index_select(1, rows_idx).to(torch.bfloat16).float()
    ppm = n * torch.minimum(s[0], s[1])
    mix_t = torch.clamp_max(ppm * 0.1, 1.0)
    flat_x = fx.reshape(-1)
    flat_rel = rel.reshape(-1)
    wx_lin = _wrap_weights(flat_x, n, cubic=False).float()

    def tap(cubic):
        wy = _window_weights(flat_rel, slab, cubic).float()            # (P, slab)
        rows = torch.einsum("pg,cgk->pck", wy, win16)                  # (P, 3, n)
        wx = _wrap_weights(flat_x, n, True).float() if cubic else wx_lin
        out = torch.einsum("pck,pk->pc", rows, wx)
        return out.T.reshape((3,) + xz.shape[:-1])

    linear = tap(False)
    return torch.where(mix_t >= 1.0, linear, tap(True) * (1 - mix_t) + linear * mix_t)


# --- screen-space LOD for the gradient taps ---------------------------------
# The frame is cut into horizontal bands; each band picks a per-cascade mip
# level from its MINIMUM hit distance (removed wavelengths stay below one
# pixel for every pixel in the band), and bands with no water pixels skip
# their taps (sky overwrites them). Near bands select level 0 and equal the
# dense path. The reference has no mips; gradient_lod=False reproduces it.

def normal_gradient_pyramid(normal_maps: torch.Tensor, levels: int = 4) -> list:
    """Per-cascade mip pyramid of the (grad_x, grad_y, foam) channels.

    normal_maps: (C, 4, N, N) -> list of (C, 3, N/2^l, N/2^l) fp32, level 0
    the original channels; 2x2 average pooling keeps the half-texel center
    convention exactly.
    """
    pyr = [_gradient_planes(normal_maps)]
    for _ in range(levels - 1):
        c, ch, n, m = pyr[-1].shape
        if n % 2 or m % 2 or min(n, m) <= 8:
            break
        pyr.append(pyr[-1].reshape(c, ch, n // 2, 2, m // 2, 2).mean((3, 5)))
    return pyr


def gradient_band_levels(dist_b: torch.Tensor, hit_b: torch.Tensor,
                         map_scales: torch.Tensor, theta_pix,
                         base_res: int, nlevels: int,
                         bias: float = 1.0) -> torch.Tensor:
    """Per-band per-cascade mip level -> (B, C) int32 in [0, nlevels].

    dist_b/hit_b: (B, P) banded hit distances and water mask. Content
    removed by level l must stay below one screen pixel (angular size
    theta_pix) at the band's minimum hit distance. A band with no hit
    pixels returns `nlevels`, the skip value. `bias` > 1 coarsens by
    ~log2(bias) levels.
    """
    dmin = torch.where(hit_b, dist_b, math.inf).amin(dim=1)              # (B,)
    tiles = 1.0 / torch.minimum(map_scales[:, 0], map_scales[:, 1])      # (C,)
    r_req = tiles[None, :] / torch.clamp_min(dmin[:, None] * theta_pix * _f32(bias), 1e-9)
    lev = torch.floor(torch.log2(torch.clamp_min(
        base_res / torch.clamp(r_req, 1.0, float(base_res)), 1.0)))
    lev = torch.clamp(lev, 0, nlevels - 1).to(torch.int32)
    return torch.where(torch.isfinite(dmin)[:, None], lev,
                       torch.full_like(lev, nlevels))


def cascade_gradient_lod(pyramid: list, map_scales: torch.Tensor,
                         xz_bands: torch.Tensor, band_levels: torch.Tensor,
                         slab_crop: bool = True,
                         tap_impl: str = "einsum") -> torch.Tensor:
    """`cascade_gradient` ("mxu" numbers) with per-band mip levels.

    pyramid: from `normal_gradient_pyramid`; xz_bands: (B, P, 2) banded
    world coords; band_levels: (B, C) from `gradient_band_levels` (level ==
    len(pyramid) skips the cascade's tap for that band). Returns (B, P, 3).

    tap_impl: "einsum" runs the JAX package's taps, the plain version of
    the gradient-tap kernel: per (band, cascade) the mip level, and with
    `slab_crop` the smallest v-window in {R/8, R/4, R/2} covering the band
    (else the full circular tap), read on the host. "pallas" runs
    `ops.tap.gradient_lod_tap`: one kernel launch for every band and
    cascade on a CUDA tensor (circular taps on the full mip level, the
    same texels and weights), its plain version (this function) on a CPU
    tensor.
    """
    if tap_impl == "pallas":
        from ..ops import tap
        return tap.gradient_lod_tap(pyramid, map_scales, xz_bands, band_levels)
    if tap_impl != "einsum":
        raise ValueError(f"unknown tap_impl {tap_impl!r}; expected 'einsum' or 'pallas'")
    nlev = len(pyramid)
    ncasc = pyramid[0].shape[0]
    pyr_pad = [torch.cat([p, p], dim=2) for p in pyramid] if slab_crop else None
    levels = band_levels.tolist()

    def tap_at(lev, i, s, xz_b):
        if not slab_crop:
            return _gradient_tap(pyramid[lev][i], s, xz_b)
        n_l = pyramid[lev].shape[-1]
        sizes = [m for m in (n_l // 8, n_l // 4, n_l // 2) if m >= 16]
        if not sizes:
            return _gradient_tap(pyramid[lev][i], s, xz_b)
        fv = xz_b[..., 1] * s[1] * n_l
        ext = float(fv.max() - fv.min())
        idx = sum(ext + 5.0 > m for m in sizes)
        if idx == len(sizes):
            return _gradient_tap(pyramid[lev][i], s, xz_b)
        return _slab_tap(pyr_pad[lev][i], s, xz_b, sizes[idx])

    out = []
    for b in range(xz_bands.shape[0]):
        xz_b = xz_bands[b]
        grad = torch.zeros(xz_b.shape[:-1] + (3,), dtype=torch.float32, device=xz_b.device)
        for i in range(ncasc):
            lev = min(levels[b][i], nlev)
            if lev == nlev:
                continue        # the skip branch adds zeros
            s = map_scales[i]
            tap = tap_at(lev, i, s, xz_b)
            grad = grad + torch.movedim(tap, 0, -1) * _channel_scale(s)
        out.append(grad)
    return torch.stack(out)


# --- shading -----------------------------------------------------------------

def smith_masking_shadowing(cos_theta, alpha: torch.Tensor) -> torch.Tensor:
    """Rational Smith approximation (water.gdshader:96-100).

    NOTE: the reference CALLS this with arguments swapped (water.gdshader:
    115-116); `shade` replicates the call site, this keeps the signature.
    """
    a = cos_theta / (alpha * torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1e-8)))
    a_sq = a * a
    return torch.where(a < 1.6, (1.0 - 1.259 * a + 0.396 * a_sq) / (3.535 * a + 2.181 * a_sq),
                       0.0)


def ggx_distribution(cos_theta: torch.Tensor, alpha) -> torch.Tensor:
    """GGX NDF (water.gdshader:103-107)."""
    a_sq = alpha * alpha
    d = 1.0 + (a_sq - 1.0) * cos_theta * cos_theta
    return a_sq / (math.pi * d * d)


def shade(
    gradient: torch.Tensor,      # (..., 3) from cascade_gradient
    wave_height: torch.Tensor,   # (...,) displacement.y at the point
    view_dir: torch.Tensor,      # (..., 3) unit, surface -> camera
    light_dir: torch.Tensor,     # (3,) unit, surface -> sun
    distance: torch.Tensor,      # (...,) camera distance
    water_color=DEFAULT_WATER_COLOR,
    foam_color=DEFAULT_FOAM_COLOR,
    light_color=(1.0, 1.0, 1.0),
    roughness: float = 0.4,
    normal_strength: float = 1.0,
    sky_ambient: bool = True,
    specular_aa: bool = False,
) -> torch.Tensor:
    """Full fragment+light shading (water.gdshader:72-127) -> linear RGB.

    ``sky_ambient`` adds the engine's reflected-environment term (the view
    ray reflected about the shading normal samples the sky prefiltered by
    the fragment's ROUGHNESS write, water.gdshader:93, weighted by
    fresnel). ``specular_aa`` (opt-in, not in the reference) widens the GGX
    lobe by the shading normal's screen-space variance; it needs
    (..., H, W, 3) screen structure.
    """
    dev = gradient.device
    water_color = _rgb(water_color, dev)
    foam_color = _rgb(foam_color, dev)
    light_color = _rgb(light_color, dev)
    rough = torch.full((), _f32(roughness), dtype=torch.float32, device=dev)

    # fragment() (gdshader:85-93)
    g2 = torch.clamp(gradient[..., 2] * 0.75, 0, 1)
    foam_factor = 3.0 * torch.square(g2) - 2.0 * (g2 * (g2 * g2))    # smoothstep
    foam_factor = foam_factor * torch.exp(-distance * 0.0075)
    albedo = (water_color * (1.0 - foam_factor[..., None])
              + foam_color * foam_factor[..., None])

    g = gradient[..., :2] * (0.015 + (normal_strength - 0.015)
                             * torch.exp(-distance * 0.0175))[..., None]
    normal = torch.stack([-g[..., 0], torch.ones_like(g[..., 0]), -g[..., 1]], dim=-1)
    normal = normal / _norm(normal)

    dot_nv = torch.clamp_min((normal * view_dir).sum(-1), 2e-5)
    expo = _f32(5.0 * np.float32(np.exp(np.float32(-2.69 * roughness))))
    fresnel = (torch.pow(torch.clamp_min(1.0 - dot_nv, 0.0), expo)
               / (1.0 + 22.7 * roughness ** 1.5))
    fresnel = fresnel * (1.0 - REFLECTANCE) + REFLECTANCE

    # light() (gdshader:109-127)
    halfway = light_dir + view_dir
    halfway = halfway / _norm(halfway)
    dot_nl = torch.clamp_min((normal * light_dir).sum(-1), 2e-5)
    # reference quirk preserved: smith called as (roughness, dot)
    light_mask = smith_masking_shadowing(rough, dot_nv)
    view_mask = smith_masking_shadowing(rough, dot_nl)
    if specular_aa:
        if gradient.ndim < 3:
            raise ValueError("specular_aa needs (..., H, W, 3) screen structure, got "
                             f"gradient shape {tuple(gradient.shape)}")
        dnx = torch.zeros_like(normal)
        dnx[..., 1:, :, :] = normal[..., 1:, :, :] - normal[..., :-1, :, :]
        dny = torch.zeros_like(normal)
        dny[..., :, 1:, :] = normal[..., :, 1:, :] - normal[..., :, :-1, :]
        sigma2 = torch.clamp(0.25 * (dnx * dnx + dny * dny).sum(-1), 0.0, 0.18)
        alpha_ndf = torch.sqrt(rough * rough + sigma2)
    else:
        alpha_ndf = rough
    dist_ggx = ggx_distribution((normal * halfway).sum(-1), alpha_ndf)
    geom = 1.0 / (1.0 + light_mask + view_mask)
    specular = fresnel * dist_ggx * geom / (4.0 * dot_nv + 0.1)

    sss_mod = _const(SSS_MODIFIER, dev)
    dot_lv = torch.clamp_min((-view_dir * light_dir).sum(-1), 0.0)
    sss_height = (torch.clamp_min(wave_height + 2.5, 0.0) * torch.pow(dot_lv, 4.0)
                  * torch.pow(0.5 - 0.5 * dot_nl, 3.0))
    sss_near = 0.5 * dot_nv ** 2
    lambertian = 0.5 * dot_nl
    diffuse_base = ((sss_height + sss_near)[..., None] * sss_mod
                    / (1.0 + light_mask[..., None]) + lambertian[..., None])
    diffuse = (diffuse_base * (1.0 - foam_factor[..., None])
               + foam_color * foam_factor[..., None])
    diffuse = diffuse * (1.0 - fresnel[..., None]) * light_color

    # reference quirk preserved: SPECULAR_LIGHT without LIGHT_COLOR
    # (water.gdshader:119) while DIFFUSE_LIGHT carries it (:126)
    rgb = albedo * diffuse + specular[..., None]

    if sky_ambient:
        rough_px = (1.0 - fresnel) * foam_factor + 0.4
        refl = 2.0 * dot_nv[..., None] * normal - view_dir
        rgb = rgb + sky_color_rough(refl, light_dir, rough_px) * fresnel[..., None]
    return rgb


def render_ocean(
    maps,                        # OceanMaps (channel-first planes)
    map_scales: torch.Tensor,    # (C, 4)
    width: int = 960,
    height: int = 540,
    camera_pos=(0.0, 12.0, 0.0),
    pitch_deg: float = -12.0,
    yaw_deg: float = 0.0,
    fov_deg: float = 70.0,
    light_dir=(0.3, 0.55, 0.9),
    environment: bool = False,
    sampler: str = "gather",
    **shade_kwargs,
) -> torch.Tensor:
    """Offline perspective render of the flat water plane -> (H, W, 3) RGB.

    Rays from a pinhole camera intersect the y=0 plane (no displacement
    parallax); sky via the procedural panorama. environment=True applies
    the scene's fog/tonemap/adjustment post (main.tscn:22-41).
    """
    from .geometry import _vec, camera_rays
    dev = maps.displacement.device
    cam = _vec(camera_pos, dev)
    d = camera_rays(width, height, pitch_deg, yaw_deg, fov_deg, device=dev)

    t_hit = -cam[1] / d[..., 1]
    hits = t_hit > 0
    t_hit = torch.where(hits, t_hit, 1e9)
    p = cam + t_hit[..., None] * d
    xz = p[..., 0::2]

    light = _vec(light_dir, dev)
    light = light / _norm(light)

    disp = cascade_displacement(maps.displacement, map_scales, xz,
                                camera_xz=cam[0::2], sampler=sampler)
    grad = cascade_gradient(maps.normal, map_scales, xz, sampler=sampler)
    dist = _norm(p - cam)[..., 0]
    rgb = shade(grad, disp[..., 1], -d, light, dist, **shade_kwargs)

    rgb = torch.where(hits[..., None], rgb, sky_color(d, light))
    if environment:
        rgb = apply_environment(rgb, dist, hits)
    return torch.clamp(rgb, 0.0, 1.0)


def apply_environment(rgb: torch.Tensor, dist: torch.Tensor, hits=None, *,
                      fog_depth_begin: float = 200.0,
                      fog_depth_end: float = 350.0,
                      fog_depth_curve: float = 0.25,
                      fog_color=FOG_LIGHT_COLOR,
                      brightness: float = 0.85,
                      contrast: float = 1.07,
                      saturation: float = 1.5,
                      tonemap: bool = True,
                      tonemap_white: float = 4.0) -> torch.Tensor:
    """The reference scene's environment post (main.tscn:22-41) on linear RGB:
    depth fog on water pixels (`hits`), an extended-Reinhard tonemap in
    linear space, brightness, contrast about mid-gray and saturation."""
    dev = rgb.device
    f = torch.clamp((dist - fog_depth_begin) / (fog_depth_end - fog_depth_begin), 0.0, 1.0)
    f = f ** _f32(fog_depth_curve)
    if hits is not None:
        f = torch.where(hits, f, 0.0)
    rgb = rgb + (_const(tuple(fog_color), dev) - rgb) * f[..., None]
    if tonemap:
        w2 = _f32(tonemap_white * tonemap_white)
        rgb = rgb * (1.0 + rgb / w2) / (1.0 + rgb)
    rgb = rgb * _f32(brightness)
    rgb = 0.5 + (rgb - 0.5) * _f32(contrast)
    luma = (rgb * _const((0.2126, 0.7152, 0.0722), dev)).sum(-1, keepdim=True)
    rgb = luma + (rgb - luma) * _f32(saturation)
    return torch.clamp(rgb, 0.0, 1.0)


def sky_color(d: torch.Tensor, light: torch.Tensor) -> torch.Tensor:
    """Procedural panoramic sky for view directions d (..., 3) -> linear RGB
    (the analog of the reference's skybox panorama, main.tscn:16-20)."""
    dev = d.device
    up = torch.clamp(d[..., 1], 0.0, 1.0)[..., None]
    zenith = _const((0.20, 0.42, 0.74), dev)
    horizon = _const((0.66, 0.76, 0.86), dev)
    base = horizon + (zenith - horizon) * torch.sqrt(up)
    haze = torch.exp(-torch.abs(d[..., 1]) * 9.0)[..., None]
    base = base * (1 - haze) + _const((0.78, 0.82, 0.87), dev) * haze
    cos_sun = torch.clamp((d * light).sum(-1), -1.0, 1.0)[..., None]
    disk = torch.exp((cos_sun - 1.0) * 6000.0)
    bloom = torch.exp((cos_sun - 1.0) * 80.0)
    scatter = torch.exp((cos_sun - 1.0) * 6.0)
    sun_col = _const((1.0, 0.95, 0.85), dev)
    return (base + sun_col * (3.0 * disk + 0.35 * bloom)
            + _const((0.18, 0.14, 0.08), dev) * scatter)


def sky_color_rough(d: torch.Tensor, light: torch.Tensor,
                    roughness: torch.Tensor) -> torch.Tensor:
    """`sky_color` prefiltered by a GGX reflection lobe of `roughness`.

    Every directional term of the sky is a spherical gaussian exp(k(cos-1));
    the lobe at roughness a acts as an SG of sharpness k_r ~ 2/a^2, and SG
    convolution closes to sharpness k k_r/(k + k_r) with the peak scaled by
    k_eff/k. The gradient and haze relax toward their spherical means with
    the same lobe width. roughness -> 0 recovers `sky_color`.
    """
    dev = d.device
    d = d / _norm(d)
    a2 = torch.square(torch.clamp(torch.as_tensor(roughness, dtype=torch.float32,
                                                  device=dev), 0.0, 1.0))
    k_r = 2.0 / torch.clamp_min(a2, 1e-9)

    up = torch.clamp(d[..., 1], 0.0, 1.0)
    t = torch.clamp(a2, 0.0, 1.0)
    up = (up * (1.0 - t) + 0.25 * t)[..., None]
    zenith = _const((0.20, 0.42, 0.74), dev)
    horizon = _const((0.66, 0.76, 0.86), dev)
    base = horizon + (zenith - horizon) * torch.sqrt(up)
    k_haze = (9.0 * k_r / (9.0 + k_r))[..., None]
    haze = torch.exp(-torch.abs(d[..., 1])[..., None] * k_haze)
    base = base * (1 - haze) + _const((0.78, 0.82, 0.87), dev) * haze

    cos_sun = torch.clamp((d * light).sum(-1), -1.0, 1.0)[..., None]

    def lobe(k, amp):
        k_eff = k * k_r / (k + k_r)
        return (amp * k_eff / k)[..., None] * torch.exp((cos_sun - 1.0) * k_eff[..., None])

    sun_col = _const((1.0, 0.95, 0.85), dev)
    ones = torch.ones_like(a2)
    sun = lobe(6000.0, 3.0 * ones) + 0.35 * lobe(80.0, ones)
    scatter = lobe(6.0, ones)
    return base + sun_col * sun + _const((0.18, 0.14, 0.08), dev) * scatter


# --- spray billboards (sea_spray.gdshader) -----------------------------------

@functools.lru_cache(maxsize=2)
def _puff_lobes(n_lobes: int = 6) -> np.ndarray:
    """(L, 4) [off_x, off_y, sigma_frac, amplitude] lobe table for the
    procedural spray sprite (the JAX package's table, bit for bit).

    The reference's billboard samples an irregular puff albedo texture
    (sea_spray.gdshader:27,31 x mat_spray.tres sea_spray.png). Here the
    puff is a fixed mixture of isotropic gaussian lobes (a core plus an
    offset ring, some negative to chew the rim), so every lobe is
    separable and the whole composite is one outer-product contraction
    with L x the particle count. Deterministic (fixed seed), normalized to
    unit peak on a dense probe grid. Shared: never write to it.
    """
    rng = np.random.default_rng(7)
    lobes = [(0.0, 0.0, 1.0, 1.0)]
    for i in range(n_lobes - 1):
        ang = 2 * np.pi * i / (n_lobes - 1) + rng.uniform(-0.4, 0.4)
        r = rng.uniform(0.5, 0.85)
        neg = i % 3 == 2
        amp = -0.4 if neg else rng.uniform(0.35, 0.6)
        sig = rng.uniform(0.4, 0.62)
        lobes.append((r * np.cos(ang), r * np.sin(ang), sig, amp))
    tab = np.asarray(lobes, np.float32)
    # normalize: unit peak over a probe grid (so max_alpha keeps its meaning)
    xs = np.linspace(-2.0, 2.0, 81)
    gx, gy = np.meshgrid(xs, xs)
    field = sum(a * np.exp(-((gx - ox) ** 2 + (gy - oy) ** 2) / (2 * s * s))
                for ox, oy, s, a in tab)
    tab[:, 3] /= max(float(field.max()), 1e-6)
    return tab


def splat_spray(
    img: torch.Tensor,            # (H, W, 3) linear RGB to composite onto
    positions: torch.Tensor,      # (P, 3) world positions (spray_step output)
    scales: torch.Tensor,         # (P, 3)
    dissolve: torch.Tensor,       # (P,) CUSTOM.a driver
    visible: torch.Tensor,        # (P,) bool
    camera_pos=(0.0, 12.0, 0.0),
    pitch_deg=-12.0,
    yaw_deg=0.0,
    fov_deg=70.0,
    foam_color=DEFAULT_FOAM_COLOR,
    max_alpha: float = 0.666,
    custom_z=None,                # (P,) dissolve offset (CUSTOM.z), optional
    sprite: str = "puff",         # "puff" (textured look) | "gaussian" (1 lobe)
) -> torch.Tensor:
    """Composite spray particles as scale-aware soft billboards
    (sea_spray.gdshader), the JAX package's `splat_spray`.

    View-aligned gaussian sprites whose screen footprint follows the
    particle's world scale and distance (billboards keep model scale,
    sea_spray.gdshader:20-21), alpha by the shader's distance fade x
    dissolve envelope; with `custom_z`, the scrolling-noise dissolve cut
    (:30-33, a per-particle procedural noise phase) sculpts the puff
    edges. Brightness uses the foam-colour boost (:27-28). The projection
    is the renderers' camera; pose arguments and `foam_color` may be
    numbers or tensors on the image's device.

    The sprites are separable gaussian lobes, so the composite is one
    contraction overlay = (wy * alpha)^T @ wx over (lobes x particles)
    rows, with the JAX package's precision: both operands rounded to
    bf16, the products and the sum in fp32. On a CUDA device that is a
    bf16 matrix product with an fp32 output (`torch.mm(..., out_dtype=)`,
    tensor cores); the CPU has no such product, so there the rounded
    operands are widened to fp32, which is exact in every product (an
    8-bit by 8-bit significand fits fp32). Only the order of the fp32 sum
    differs between the two.
    """
    from .geometry import _scalar, _vec
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    cam = _vec(camera_pos, dev)
    pitch = torch.deg2rad(_scalar(pitch_deg, dev))
    tan_half = torch.tan(torch.deg2rad(_scalar(fov_deg, dev)) / 2)
    v = positions - cam
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    yaw = torch.deg2rad(_scalar(yaw_deg, dev))
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    # camera basis (render_ocean / FlyCamera.basis): pitch about x, then yaw
    # about y; yaw = 0 gives f = (0, sin p, cos p)
    f = torch.stack([-sy * cp, sp, cy * cp])
    u = torch.stack([-sy * -sp, cp, cy * -sp])
    r = torch.stack([cy, torch.zeros_like(cy), sy])
    z = v @ f
    x = v @ r
    y = v @ u
    in_front = z > 0.5
    px = (x / (z * tan_half) + 1.0) * 0.5 * w
    aspect = h / w
    py = (0.5 - y / (z * tan_half * 2 * aspect)) * h
    dist = _norm(v)[..., 0]

    fade = max_alpha * (1.0 - torch.exp(-dist * 0.04))
    if custom_z is None:
        alpha = fade * torch.clamp(dissolve, 0.0, 1.0)
    else:
        # (fade + offset)/2 - noise, clamped: the dissolve cut; the
        # scrolling noise texture becomes a per-particle phase scroll
        noise = 0.45 * torch.remainder(custom_z * 7.31 + dissolve * 1.37, 1.0)
        alpha = fade * torch.clamp_min(
            (torch.clamp(dissolve, 0.0, 1.0) + custom_z) * 0.5 - noise, 0.0)
    alpha = alpha * torch.clamp(scales[:, 0], 0.0, 1.0)
    alpha = torch.where(visible & in_front, alpha, 0.0)

    # screen-space sprite radius from the world-scale billboard size
    focal = (w * 0.5) / tan_half
    world_r = 0.5 * torch.abs(scales).mean(-1)
    sigma = torch.clamp(world_r * focal / torch.clamp_min(z, 0.5), 0.6, 2.2)

    if sprite == "puff":
        # the procedural sea_spray.png: a fixed lobe mixture, rotated per
        # particle slot (golden-angle hash) so puffs vary across billboards
        tab = _const(tuple(map(tuple, _puff_lobes().tolist())), dev)   # (L, 4)
        theta = torch.arange(px.shape[0], dtype=torch.float32, device=dev) * 2.3999632
        ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        off = sigma[:, None] * 1.3                          # lobe ring radius
        cx = px[:, None] + off * (ct * tab[:, 0] - st * tab[:, 1])
        cy_ = py[:, None] + off * (st * tab[:, 0] + ct * tab[:, 1])
        sig = sigma[:, None] * tab[:, 2]
        amp = alpha[:, None] * tab[:, 3]
        px_, py_ = cx.reshape(-1), cy_.reshape(-1)
        sigma_, amp_ = sig.reshape(-1), amp.reshape(-1)
    else:
        px_, py_, sigma_, amp_ = px, py, sigma, alpha
    inv2s2 = (1.0 / (2.0 * sigma_ * sigma_))[:, None]
    rows = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    cols = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    wy = torch.exp(-torch.square(rows[None, :] - py_[:, None]) * inv2s2)
    wx = torch.exp(-torch.square(cols[None, :] - px_[:, None]) * inv2s2)
    a = (wy * amp_[:, None]).to(torch.bfloat16)
    b = wx.to(torch.bfloat16)
    if dev.type == "cuda":
        product = torch.mm(a.T, b, out_dtype=torch.float32)
    else:
        product = a.float().T @ b.float()
    overlay = torch.clamp(product, 0.0, 1.0)[..., None]
    boost = _rgb(foam_color, dev) * _const((1.65, 1.75, 1.65), dev)
    return torch.clamp(img * (1 - overlay) + boost * overlay, 0.0, 1.0)
