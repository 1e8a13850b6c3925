"""The spray splat kernel's premise and wrapper, on the CPU.

The kernel (`ops/splat.py`, `csrc/splat.cu`) forms a lobe's weights only in a
window of `WINDOW_SIGMAS` sigma about its centre and bins the lobes into
`TILE` x `TILE` pixel tiles, `TILES_AXIS` at most along an axis. Here: every
nonzero fp32 weight of the plain route's formula lies inside that window, for
the whole range of a lobe's sigma and centres at sub-pixel offsets; the window
spans at most `TILES_AXIS` tiles; the wrapper refuses what the kernel does not
take; and CPU tensors still take the plain route. The kernel itself runs only
on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from godotoceanwaves_tpu_torch.models import shading
from godotoceanwaves_tpu_torch.ops import splat
from godotoceanwaves_tpu_torch.ops._build import LAUNCHES

# a lobe's sigma: the particle's clamp [0.6, 2.2] times the puff's sigma
# fractions in [0.4, 1.0], both ends and points between, as fp32 products
SIGMAS = sorted({float(np.float32(0.6) * np.float32(0.4)), 0.3, 0.6, 0.9, 1.32, 1.7,
                 float(np.float32(2.2)), float(np.float32(2.2) * np.float32(0.62))})


def plain_weights(centre: torch.Tensor, sigma: torch.Tensor, n: int) -> torch.Tensor:
    """(lobes, n) fp32 weights as `_splat_spray_plain` forms them."""
    inv2s2 = (1.0 / (2.0 * sigma * sigma))[:, None]
    cells = torch.arange(n, dtype=torch.float32) + 0.5
    return torch.exp(-torch.square(cells[None, :] - centre[:, None]) * inv2s2)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_nonzero_plain_weights_lie_inside_the_kernels_window(sigma):
    """Centres at 64 sub-pixel offsets, inside the frame and across both
    edges: every nonzero weight's pixel is inside [first, last]; the window
    reaches no further than 16 sigma; the nonzero reach is ~14.42 sigma, so
    the window's margin is real and small."""
    n = 160
    centre = torch.cat([torch.arange(64, dtype=torch.float32) / 64 + base
                        for base in (-40.0, -3.0, 0.0, 37.0, 80.0, 159.0, 171.0, 200.0)])
    sig = torch.full_like(centre, sigma)
    w = plain_weights(centre, sig, n)
    first, last = splat.lobe_window(centre, sig, n)
    idx = torch.arange(n)[None, :]
    inside = (idx >= first[:, None]) & (idx <= last[:, None])
    assert not bool((w != 0)[~inside].any())
    assert bool((last - first <= int(2 * splat.WINDOW_SIGMAS * sigma)).all())
    d = ((idx + 0.5) - centre[:, None]).abs()
    reach = float(d[w != 0].max()) / sigma
    assert 14.3 < reach < 14.5, reach


def test_window_spans_at_most_tiles_axis_tiles():
    """At the largest sigma and every alignment to the tile grid, a window
    covers at most TILES_AXIS tiles, and some alignment needs all of them."""
    centre = torch.arange(0, 64 * 32, dtype=torch.float32) / 32 + 40.0
    sig = torch.full_like(centre, float(np.float32(splat.SIGMA_MAX)))
    first, last = splat.lobe_window(centre, sig, 4096)
    tiles = last // splat.TILE - first // splat.TILE + 1
    assert int(tiles.max()) == splat.TILES_AXIS == 6


def splat_args(p=24, seed=3, h=18, w=32):
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((h, w, 3), generator=gen)
    pos = torch.stack([torch.rand(p, generator=gen) * 20 - 10, torch.rand(p, generator=gen) * 3,
                       torch.rand(p, generator=gen) * 30 + 2], -1)
    scale = torch.rand((p, 3), generator=gen) * 1.8 + 0.2
    dissolve, custom_z = torch.rand(p, generator=gen), torch.rand(p, generator=gen)
    visible = torch.rand(p, generator=gen) > 0.2
    return img, pos, scale, dissolve, visible, custom_z


def kernel_inputs(p=24):
    img, pos, scale, dissolve, visible, custom_z = splat_args(p)
    view = shading._spray_view(pos, scale, img.shape[1], (0.0, 6.0, 0.0), -9.0, 4.0, 70.0)
    boost = shading._spray_boost(shading.DEFAULT_FOAM_COLOR, img.device)
    return dict(img=img, view=view, scales=scale, dissolve=dissolve, visible=visible,
                custom_z=custom_z, boost=boost, lobes=shading._puff_lobes(),
                turns=shading._lobe_turns(p, img.device))


def test_wrapper_rejects_what_it_does_not_take():
    good = kernel_inputs()
    cases = [
        (dict(img=good["img"][..., :2]), ValueError, r"\(H, W, 3\)"),
        (dict(img=good["img"].double()), ValueError, "float32"),
        (dict(view=(good["view"][0][:5],) + good["view"][1:]), ValueError, "y must be"),
        (dict(view=good["view"][:4] + (good["view"][4].double(),) + good["view"][5:]), TypeError,
         "world_r must be float32"),
        (dict(scales=good["scales"][:, :2]), ValueError, "scales"),
        (dict(dissolve=good["dissolve"][:3]), ValueError, "dissolve"),
        (dict(custom_z=good["custom_z"].half()), TypeError, "custom_z"),
        (dict(visible=good["visible"].float()), TypeError, "visible"),
        (dict(boost=good["boost"][:2]), ValueError, "boost"),
        (dict(lobes=np.ones((9, 4), np.float32)), ValueError, "lobes"),
        (dict(lobes=np.ones((6, 4), np.float32) * 1.5), ValueError, "sigma fraction"),
        (dict(turns=None), ValueError, "turns"),
        ({}, ValueError, "CUDA device"),
    ]
    for change, exc, match in cases:
        with pytest.raises(exc, match=match):
            splat.spray_composite(**{**good, **change}, max_alpha=0.666)
    # the gaussian sprite takes no lobe table and no turns
    with pytest.raises(ValueError, match="CUDA device"):
        splat.spray_composite(**{**good, "lobes": None, "turns": None}, max_alpha=0.666)


@pytest.mark.parametrize("sprite", ["puff", "gaussian"])
def test_cpu_tensors_take_the_plain_route(monkeypatch, sprite):
    """On CPU tensors `splat_spray` is `_splat_spray_plain`, bit for bit,
    and reaches no kernel."""
    img, pos, scale, dissolve, visible, custom_z = splat_args()
    kw = dict(camera_pos=(0.0, 6.0, 0.0), pitch_deg=-9.0, yaw_deg=4.0, fov_deg=70.0,
              foam_color=shading.DEFAULT_FOAM_COLOR, max_alpha=0.666, custom_z=custom_z,
              sprite=sprite)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")
    monkeypatch.setattr(splat, "spray_composite", refuse)
    before = LAUNCHES["splat"]
    got = shading.splat_spray(img, pos, scale, dissolve, visible, **kw)
    want = shading._splat_spray_plain(img, pos, scale, dissolve, visible, *kw.values())
    assert LAUNCHES["splat"] == before
    assert torch.equal(got, want)
    assert float((got - img).abs().max()) > 0.05


def test_lobe_turns_are_the_plain_routes_rotation():
    """The cached turns are the plain route's cos and sin of the golden-angle
    hash, bit for bit, and one table a count and device."""
    p = 300
    theta = torch.arange(p, dtype=torch.float32) * 2.3999632
    turns = shading._lobe_turns(p, torch.device("cpu"))
    assert torch.equal(turns, torch.stack([torch.cos(theta), torch.sin(theta)], -1))
    assert shading._lobe_turns(p, torch.device("cpu")) is turns
