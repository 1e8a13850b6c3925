"""The fan march's bracket select: the kernel's premise, its semantics and its
wrapper, on the CPU.

The kernel (`ops/fan.py`, `csrc/fan.cu`) finds each pixel's first crossing by
a binary search for the window's first tau and a walk up the table, where the
plain route takes the `amin` of a broadcast chain over (H/g, g, W, J). Here:
every tier's tau table is strictly increasing in fp32, which makes the two
the same; a loop-form twin of the kernel, in fp32 scalar arithmetic, equals
the chain bit for bit on small inputs with NaN heights and slopes, empty
windows and unmarchable pixels; the wrapper refuses what neither route
takes and sends CPU tensors to the plain chain; and the renderer's CPU route
reaches no kernel.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import inspect

import numpy as np
import pytest
import torch

from godotoceanwaves_tpu_torch.models import geometry
from godotoceanwaves_tpu_torch.models.viewport import RENDER_TIERS
from godotoceanwaves_tpu_torch.ops import fan
from godotoceanwaves_tpu_torch.ops._build import LAUNCHES

F32 = np.float32


def tier_fan_params(tier: str):
    """(tau_near, far, fan_tau) that a render on `tier` hands the fan."""
    params = {k: p.default for k, p in
              inspect.signature(geometry.render_ocean_geometry).parameters.items()}
    params.update(RENDER_TIERS[tier])
    tau_near = inspect.signature(geometry._fan_select).parameters["tau_near"].default
    return tau_near, params["far"], params["fan_tau"]


@pytest.mark.parametrize("tier", sorted(RENDER_TIERS))
def test_every_tiers_tau_is_strictly_increasing(tier):
    """The premise of the kernel's first-index scan: tau_j < tau_(j+1) in
    fp32 at the tier's resolution, and at coarser and finer ones."""
    tau_near, far, taus = tier_fan_params(tier)
    assert (tau_near, far, taus) == (0.25, 1600.0, 320)
    for res in (taus, 2, 64, taus * 4):
        tau = geometry._fan_tau(tau_near, far, res)
        assert tau.dtype == np.float32 and tau.shape == (res,)
        assert bool((np.diff(tau) > 0).all()), res


def kernel_twin(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio):
    """csrc/fan.cu's algorithm a pixel at a time, in fp32 scalars: (tsel,
    found, t_lo, t_hi) as numpy arrays."""
    hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam = (
        x.numpy() for x in (hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam))
    hgt, wid = s.shape
    phi, taus = hfan.shape
    g = hgt // i0.shape[0]
    cy, ratio = cam[1], F32(ratio)
    tsel = np.full((hgt, wid), np.inf, F32)
    found = np.zeros((hgt, wid), bool)
    t_lo, t_hi = t0.copy(), t1.copy()
    for r in range(hgt):
        for c in range(wid):
            if not marchable[r, c]:
                continue
            dv = dxz[r, c]
            tau0, tau1 = F32(t0[r, c] * dv), F32(t1[r, c] * dv)
            lo, hi = 0, taus
            while lo < hi:
                mid = (lo + hi) // 2
                if tau[mid] > tau0:
                    hi = mid
                else:
                    lo = mid + 1
            q = (r // g, c)
            i = min(max(int(i0[q]), 0), phi - 2)
            for j in range(lo, taus):
                if not tau[j] <= tau1:
                    break
                z = F32(F32(s[r, c] * tau[j]) + cy)
                prof = F32(F32(w0[q] * hfan[i, j]) + F32(w1[q] * hfan[i + 1, j]))
                if z < prof:
                    tsel[r, c] = tau[j]
                    break
            if np.isfinite(tsel[r, c]):
                found[r, c] = True
                t_hi[r, c] = F32(tsel[r, c] / dv)
                x = F32(t_hi[r, c] * ratio)
                t_lo[r, c] = t0[r, c] if np.isnan(t0[r, c]) else max(t0[r, c], x)
    return tsel, found, t_lo, t_hi


def fan_case(seed: int, hgt: int = 12, wid: int = 10, g: int = 4, phi: int = 7,
             taus: int = 48):
    """Inputs as the renderer's prologue forms them, with every case the
    kernel must treat as the chain does: NaN heights and slopes, NaN and
    empty windows, windows past the table's end, unmarchable pixels."""
    rng = np.random.default_rng(seed)
    tau = torch.from_numpy(geometry._fan_tau(0.25, 1600.0, taus))
    hfan = torch.from_numpy(rng.uniform(-1.5, 1.5, (phi, taus)).astype(F32))
    hfan[rng.integers(0, phi, 6), rng.integers(0, taus, 6)] = float("nan")
    ag = torch.from_numpy(rng.uniform(0, phi - 1, (hgt // g, wid)).astype(F32))
    ag[0, 0], ag[-1, -1] = 0.0, float(phi - 1)          # both ends of the hat
    i0 = torch.clamp_max(ag.long(), phi - 2)
    w0 = torch.clamp_min(1.0 - torch.abs(ag - i0.float()), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(ag - (i0 + 1).float()), 0.0)
    dxz = torch.from_numpy(rng.uniform(0.2, 1.0, (hgt, wid)).astype(F32))
    s = torch.from_numpy(rng.uniform(-0.4, 0.05, (hgt, wid)).astype(F32))
    t0 = torch.from_numpy(rng.uniform(0.0, 30.0, (hgt, wid)).astype(F32))
    t1 = t0 + torch.from_numpy(rng.uniform(0.0, 400.0, (hgt, wid)).astype(F32))
    t1[0, :3] = t0[0, :3] * 0.5                         # empty windows
    t0[1, 0], t1[1, 1] = float("nan"), float("nan")
    t0[1, 2], t1[1, 2] = 3000.0, 4000.0                 # past the table's far end
    t1[1, 3] = t0[1, 3]                                 # a window of one point
    s[2, :2] = float("nan")
    marchable = torch.from_numpy(rng.uniform(size=(hgt, wid)) > 0.15)
    cam = torch.tensor([0.5, 2.0, -0.5])
    ratio = float(np.exp(-np.log(1600.0 / 0.25) / (taus - 1)))
    return (hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio)


def tie_case(kind: str, wid: int = 16, taus: int = 48):
    """One row of pixels whose answer hangs on an exact tie, each with a
    profile of its own (i0 = its column, w0 = 1, w1 = 0, so the profile is
    the fan row itself) that is far below the ray except where planted:
    "lower": tau0 = tau_k exactly, a crossing planted at k (outside the
    window) and at k + 2; "upper": tau1 = tau_k exactly, the only crossing at
    k; "rounding": the only crossing at a j where fl(fl(s tau_j) + cam_y)
    and the once-rounded s tau_j + cam_y differ, the profile the larger of
    the two, so that rounding once instead of twice moves the answer."""
    rng = np.random.default_rng({"lower": 11, "upper": 12, "rounding": 13}[kind])
    tau = torch.from_numpy(geometry._fan_tau(0.25, 1600.0, taus))
    hfan = torch.full((wid + 1, taus), -100.0)
    ag = torch.arange(wid, dtype=torch.float32)[None]
    i0 = torch.clamp_max(ag.long(), wid - 1)
    w0 = torch.clamp_min(1.0 - torch.abs(ag - i0.float()), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(ag - (i0 + 1).float()), 0.0)
    assert bool((w0 == 1).all() and (w1 == 0).all())
    dxz = torch.ones((1, wid))
    s = torch.zeros((1, wid))
    t0 = torch.zeros((1, wid))
    t1 = torch.full((1, wid), 1600.0)
    cam = torch.tensor([0.0, 0.0, 0.0])
    ks = rng.integers(3, taus - 4, wid)
    for c, k in enumerate(ks):
        if kind == "lower":
            t0[0, c] = tau[k]
            hfan[c, k] = hfan[c, k + 2] = 1.0
        elif kind == "upper":
            t1[0, c] = tau[k]
            hfan[c, k] = 1.0
    if kind == "rounding":
        cam[1] = 1.0
        tn = tau.numpy()
        for c in range(wid):
            while True:
                sv, j = F32(rng.uniform(-0.02, -0.001)), int(rng.integers(0, taus))
                twice = F32(F32(sv * tn[j]) + F32(1.0))
                once = F32(np.float64(sv) * np.float64(tn[j]) + 1.0)
                if twice != once:
                    break
            s[0, c] = float(sv)
            hfan[c, j] = float(max(twice, once))
    marchable = torch.ones((1, wid), dtype=torch.bool)
    ratio = float(np.exp(-np.log(1600.0 / 0.25) / (taus - 1)))
    return (hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_form_twin_equals_the_broadcast_chain(seed, g):
    """The kernel's first-index scan, written as a loop, gives the chain's
    tsel, found, t_lo and t_hi bit for bit (NaNs too)."""
    args = fan_case(seed, g=g)
    found, t_lo, t_hi, tsel = fan.fan_bracket_plain(*args, with_tsel=True)
    twin = [torch.from_numpy(a) for a in kernel_twin(*args)]
    for got, want in zip(twin, (tsel, found, t_lo, t_hi)):
        assert got.dtype == want.dtype and torch.equal(bits(got), bits(want))
    marchable = args[9]
    assert 0 < int(found.sum()) < int(marchable.sum())   # crossings and misses both
    assert not bool(found[~marchable].any())
    assert bool(torch.isinf(tsel[~found]).all())


@pytest.mark.parametrize("kind", ["lower", "upper", "rounding"])
def test_loop_form_twin_equals_the_chain_at_exact_ties(kind):
    """At tau_j == tau0, tau_j == tau1 and a crossing that rounding once
    instead of twice would move, the twin and the chain agree bit for bit,
    and on the answer the tie forces."""
    args = tie_case(kind)
    found, t_lo, t_hi, tsel = fan.fan_bracket_plain(*args, with_tsel=True)
    twin = [torch.from_numpy(a) for a in kernel_twin(*args)]
    for got, want in zip(twin, (tsel, found, t_lo, t_hi)):
        assert torch.equal(bits(got), bits(want))
    tau, t0, t1 = args[1], args[6], args[7]
    if kind == "lower":
        k = torch.searchsorted(tau, t0[0])
        assert torch.equal(tau[k], t0[0]) and torch.equal(tsel[0], tau[k + 2])
    elif kind == "upper":
        assert torch.equal(tsel[0], t1[0])
    else:
        assert 0 < int(found.sum()) < found.numel()


def test_plain_route_returns_the_chain_and_its_epilogue():
    """`fan_bracket_plain` is `fan_tsel_plain` then `fan_epilogue_plain`;
    tsel last with `with_tsel`."""
    args = fan_case(5)
    tsel = fan.fan_tsel_plain(*args[:-1])
    want = fan.fan_epilogue_plain(tsel, args[9], args[8], args[6], args[7], args[-1])
    got = fan.fan_bracket_plain(*args)
    assert len(got) == 3 and all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    assert torch.equal(fan.fan_bracket_plain(*args, with_tsel=True)[3], tsel)


def good_inputs():
    hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, _ = fan_case(0)
    return dict(hfan=hfan, tau=tau, i0=i0, w0=w0, w1=w1, s=s, t0=t0, t1=t1, dxz=dxz,
                marchable=marchable, cam=cam)


@pytest.mark.parametrize("change,exc,match", [
    (dict(hfan=torch.zeros(1, 48)), ValueError, r"\(phi, J\)"),
    (dict(tau=torch.zeros(47)), ValueError, "tau must be"),
    (dict(s=torch.zeros(12)), ValueError, r"\(H, W\)"),
    (dict(t1=torch.zeros(12, 9)), ValueError, "t1 must be"),
    (dict(marchable=torch.ones(11, 10, dtype=torch.bool)), ValueError, "marchable must be"),
    (dict(i0=torch.zeros(5, 10, dtype=torch.int64)), ValueError, "i0 must be"),
    (dict(w1=torch.zeros(3, 9)), ValueError, "w1 must be"),
    (dict(cam=torch.zeros(2)), ValueError, "cam must be"),
    (dict(hfan=torch.zeros(7, 48, dtype=torch.bfloat16)), TypeError, "hfan must be float32"),
    (dict(dxz=torch.zeros(12, 10, dtype=torch.float64)), TypeError, "dxz must be float32"),
    (dict(i0=torch.zeros(3, 10, dtype=torch.int32)), TypeError, "i0 must be int64"),
    (dict(marchable=torch.ones(12, 10)), TypeError, "marchable must be bool"),
])
def test_wrapper_rejects_what_it_does_not_take(change, exc, match):
    with pytest.raises(exc, match=match):
        fan.fan_bracket(**{**good_inputs(), **change}, ratio=0.97)


@pytest.mark.parametrize("with_tsel", [False, True])
def test_cpu_call_is_the_plain_route(with_tsel):
    """On CPU tensors `fan_bracket` returns `fan_bracket_plain`'s results,
    bit for bit, and counts no launch."""
    args = fan_case(5)
    before = LAUNCHES["fan"]
    got = fan.fan_bracket(*args, with_tsel=with_tsel)
    want = fan.fan_bracket_plain(*args, with_tsel=with_tsel)
    assert len(got) == len(want) == 3 + with_tsel
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    assert LAUNCHES["fan"] == before


def test_cpu_render_takes_the_plain_route(monkeypatch):
    """`_fan_select` on CPU tensors goes through `fan_bracket` to the plain
    chain behind it, reaches no kernel and counts no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")
    calls = []
    plain = fan.fan_bracket_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)
    monkeypatch.setattr(fan, "_launch", refuse)
    monkeypatch.setattr(fan, "fan_bracket_plain", spy)
    d = geometry.camera_rays(64, 36, -12.0, 0.0, 70.0, device="cpu")
    cam = torch.tensor([0.0, 6.0, 0.0])
    hgt, wid = d.shape[:2]
    t0 = torch.full((hgt, wid), 0.5)
    t1 = torch.full((hgt, wid), 400.0)
    marchable = d[..., 1] < 0

    def sample_h(qx, qz):
        return torch.sin(0.3 * qx) * torch.cos(0.2 * qz)
    before = LAUNCHES["fan"]
    found, t_lo, t_hi = geometry._fan_select(sample_h, cam, d, t0, t1, marchable, 1600.0, 32,
                                             64, 8, 36, (torch.tensor(0.0), torch.tensor(1.0)),
                                             (-0.7, 0.7))
    assert calls == [(32, 64)] and LAUNCHES["fan"] == before
    assert bool(found.any()) and not bool(found[~marchable].any())
    assert bool((t_lo[found] <= t_hi[found]).all())
