"""The spray step's kernel route (`ops/spray.py`, `csrc/spray.cu`): its
routing, its wrapper and its premises, on the CPU.

`models/spray.py` `spray_step` launches the kernel for a state on the card
and runs `spray_step_plain` for any other. Here: on CPU tensors `spray_step`
is the plain route, bit for bit, and both equal the step as it was before the
kernel existed (the benchmark's frozen copy of it,
`oceanbench/reference/render/spray.py`), over chained steps with long dts
that respawn every particle, at a square and a ragged particle count, on fp32
and bf16 maps and on maps sliced out of a stack; the wrapper refuses what the
kernel does not take; the kernel's uint32 hash is the plain route's int64
emulation; its declaration, its entry in `_build._SIGNATURES` and its build
flags agree. The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import spray
from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
from godotoceanwaves_tpu_torch.models.viewport import SpraySession
from godotoceanwaves_tpu_torch.ops import _build, rng
from godotoceanwaves_tpu_torch.ops import spray as spray_kernel

from oceanbench.reference.render import spray as frozen

STEPS = (0.4, 1.1, 2.3, 0.05, 3.7, 1.9, 6.5, 0.8)   # long dts: lifetimes end, cycles advance


def seeded_maps(n: int = 32, cascades: int = 3, dtype=torch.float32, seed: int = 7):
    """Maps whose gradients put normal.y on both sides of the activation band
    and whose foam, summed over the cascades, crosses 0.9."""
    g = np.random.default_rng(seed)
    disp = g.normal(0.0, 1.0, (cascades, 3, n, n))
    normal = np.concatenate([g.uniform(-0.4, 0.4, (cascades, 3, n, n)),
                             g.uniform(0.0, 0.45, (cascades, 1, n, n))], axis=1)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    return OceanMaps(displacement=as_t(disp), normal=as_t(normal))


def scales(cascades: int = 3) -> torch.Tensor:
    return T.default_cascades(device="cpu").map_scales()[:cascades].contiguous()


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bit_equal(got_state, got_attrs, want_state, want_attrs, where: str):
    for f in dataclasses.fields(got_state):
        a, b = getattr(got_state, f.name), getattr(want_state, f.name)
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b)), (where, f.name)
    assert set(got_attrs) == set(want_attrs)
    for key in want_attrs:
        assert torch.equal(bits(got_attrs[key]), bits(want_attrs[key])), (where, key)


MAPS = {"fp32": lambda: seeded_maps(),
        "bf16": lambda: seeded_maps(dtype=torch.bfloat16),
        "stacked": lambda: (lambda m: OceanMaps(
            displacement=torch.stack([m.displacement * 0.5, m.displacement], 1)[:, 1],
            normal=torch.stack([m.normal * 0.5, m.normal], 1)[:, 1]))(seeded_maps())}


@pytest.mark.parametrize("maps_case", sorted(MAPS))
@pytest.mark.parametrize("p", [256, 300])
def test_cpu_spray_step_is_the_plain_route_and_the_frozen_step(p, maps_case, monkeypatch):
    """Chained steps on CPU tensors: `spray_step`, `spray_step_plain` and
    the pre-kernel step agree bit for bit on every field and attribute; the
    kernel's wrapper is never reached and nothing is launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the kernel's wrapper")
    monkeypatch.setattr(spray_kernel, "spray_step", refuse)
    maps, sc = MAPS[maps_case](), scales()
    params = spray.SprayParams(num_particles=p, emitter_extent=30.0, seed=5)
    fparams = frozen.SprayParams(**dataclasses.asdict(params))
    state = spray.spray_init(params, device="cpu")
    plain = frozen_state = state
    now, launches = 0.0, dict(_build.LAUNCHES)
    started = activated = 0
    for i, dt in enumerate(STEPS):
        now += dt
        state, attrs = spray.spray_step(params, state, maps, sc, np.float32(now))
        plain, plain_attrs = spray.spray_step_plain(params, plain, maps, sc, np.float32(now))
        frozen_state, frozen_attrs = frozen.spray_step(fparams, frozen_state, maps, sc,
                                                       np.float32(now))
        assert_bit_equal(state, attrs, plain, plain_attrs, f"step {i}, plain route")
        assert_bit_equal(state, attrs, frozen_state, frozen_attrs, f"step {i}, frozen step")
        assert attrs["custom_z"] is state.custom_z
        started += int(state.has_started.sum())
        activated += int(state.active.sum())
    assert int(state.cycle.min()) >= 1, "every particle should have respawned"
    assert started and activated, "the steps should start and activate particles"
    assert dict(_build.LAUNCHES) == launches


def test_cpu_session_advances_on_the_plain_route():
    """A CPU `SpraySession` runs the plain route: no launch, and its attrs'
    custom_z is the state's own tensor."""
    session = SpraySession(num_particles=64, device="cpu")
    maps, sc = seeded_maps(), scales()
    launches = dict(_build.LAUNCHES)
    for _ in range(3):
        attrs = session.advance(maps, sc, 0.9)
    assert attrs["custom_z"] is session._state.custom_z
    assert dict(_build.LAUNCHES) == launches


def kernel_args(p: int = 16, n: int = 8, cascades: int = 2, device="cpu"):
    state = spray.spray_init(spray.SprayParams(num_particles=p), device=device)
    fields = [getattr(state, name) for name in spray_kernel.FIELDS]
    maps = seeded_maps(n, cascades)
    return (fields, maps.displacement.to(device), maps.normal.to(device),
            scales(cascades).to(device), torch.tensor(1.5, device=device))


def broken(case: str):
    """The wrapper's arguments (P = 16) with one thing wrong; the error it raises."""
    fields, disp, normal, sc, now = kernel_args()
    fields = list(fields)
    i = spray_kernel.FIELDS.index
    if case == "field count":
        return (fields[:-1], disp, normal, sc, now), ValueError
    if case == "vector shape":
        fields[i("start_pos")] = fields[i("start_pos")][:, :2]
    elif case == "particle count":
        fields[i("lifetime")] = fields[i("lifetime")][:15]
    elif case == "float dtype":
        fields[i("start_time")] = fields[i("start_time")].double()
    elif case == "bool dtype":
        fields[i("active")] = fields[i("active")].to(torch.uint8)
    elif case == "cycle dtype":
        fields[i("cycle")] = fields[i("cycle")].long()
    elif case == "disp channels":
        disp = disp[:, :2]
    elif case == "not square":
        disp, normal = disp[..., :4], normal[..., :4]
    elif case == "normal shape":
        normal = normal[:1]
    elif case == "map dtype":
        disp, normal = disp.double(), normal.double()
    elif case == "mixed map dtypes":
        normal = normal.to(torch.bfloat16)
    elif case == "scales shape":
        sc = sc[:, :3]
    elif case == "scales dtype":
        sc = sc.double()
    elif case == "now shape":
        now = now.reshape(1)
    elif case == "now dtype":
        now = now.double()
    elif case == "mixed devices":
        now = torch.empty((), device="meta")
    elif case == "mixed field devices":
        fields[i("custom_z")] = torch.empty(16, device="meta")
    elif case == "cpu":
        pass
    error = TypeError if "dtype" in case else ValueError
    return (fields, disp, normal, sc, now), error


BROKEN = ("field count", "vector shape", "particle count", "float dtype", "bool dtype",
          "cycle dtype", "disp channels", "not square", "normal shape", "map dtype",
          "mixed map dtypes", "scales shape", "scales dtype", "now shape", "now dtype",
          "mixed devices", "mixed field devices", "cpu")


@pytest.mark.parametrize("case", BROKEN)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Wrong shapes, dtypes and mixed devices raise before anything is
    launched; so do CPU tensors, which the kernel cannot take."""
    args, error = broken(case)
    launches = dict(_build.LAUNCHES)
    with pytest.raises(error):
        spray_kernel.spray_step(spray.SprayParams(num_particles=16), *args)
    assert dict(_build.LAUNCHES) == launches


def test_wrapper_takes_every_map_dtype_and_any_strides():
    """What the kernel takes passes the checks: fp32, bf16 and fp16 maps,
    maps sliced out of a stack (only the CPU device stops the call)."""
    fields, disp, normal, sc, now = kernel_args()
    for dtype in spray_kernel.DTYPE_CODES:
        stack_d = torch.stack([disp, disp], 1).to(dtype)[:, 1]
        stack_n = torch.stack([normal, normal], 1).to(dtype)[:, 1]
        assert not stack_d.is_contiguous()
        spray_kernel.check_inputs(16, fields, stack_d, stack_n, sc, now)


def hash32_uint32(px: np.ndarray, py: np.ndarray):
    """csrc/spray.cu's hash in native uint32 arithmetic (numpy wraps)."""
    u = np.uint32
    qx = ((px >> u(1)) ^ py) * u(1103515245)
    qy = ((py >> u(1)) ^ px) * u(1103515245)
    h = (qx ^ (qy >> u(3))) * u(1103515245)
    w = h ^ (h >> u(16))
    unit = lambda x: (x >> u(1)).astype(np.float32) * np.float32(2.0 ** -31)
    return unit(w), unit(w * u(16807)), unit(w * u(48271))


@pytest.mark.parametrize("seed", [0, 5, -3, 2 ** 31 + 11])
def test_the_kernels_hash_is_the_plain_routes(seed):
    """The kernel hashes (idx + cycle P, 1 + cycle + seed) in uint32, with
    1 + seed passed mod 2^32; the plain route in int64 words masked to 32
    bits: the same uniforms, cycles near the int32 wrap included."""
    p = 32768
    idx = np.arange(0, p, 37, dtype=np.int64)
    for cycle in (0, 1, 9, 2 ** 31 // p + 5, 2 ** 31 - 1, -2 ** 31):
        c = np.full(idx.shape, cycle, np.int64)
        want = rng.hash32_uvec2(torch.from_numpy(idx + c * p), torch.from_numpy(1 + c + seed))
        cu = c.astype(np.int32).astype(np.uint32)   # the kernel's int32 cycle, as uint32
        with np.errstate(over="ignore"):
            got = hash32_uint32(idx.astype(np.uint32) + cu * np.uint32(p),
                                cu + np.uint32((seed + 1) % 2 ** 32))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


def test_constants_are_the_plain_routes_fp32_operands():
    """Every number the wrapper hands the kernel is exactly fp32, and the
    reciprocals are fl(1 / fl(x)): what PyTorch's CUDA division of an fp32
    tensor by a Python number multiplies by."""
    params = spray.SprayParams(num_particles=32768, emitter_extent=60.0)
    k = spray_kernel.constants(params)
    assert len(k) == 11 and all(float(np.float32(v)) == v for v in k)
    f32 = np.float32
    assert k[0] == float(f32(1) / f32(180.0))              # floor(sqrt(32768)) = 181
    assert k[3] == float(f32(3.0 * 0.25))
    assert k[5] == float(f32(1) / f32(3.0))
    assert k[6] == float(f32(1) / f32(0.99 - 0.92))
    assert k[7] == float(f32(1) / f32(1.0 - 0.9))


def test_signature_matches_the_kernels_declaration():
    """`_SIGNATURES["spray_step"]` has one argument for each parameter of
    the `extern "C"` declaration in csrc/spray.cu."""
    src = (_build._PKG / "csrc" / "spray.cu").read_text()
    decl = re.search(r'extern "C" int spray_step\(([^)]*)\)', src)
    assert decl is not None
    params = [a for a in decl.group(1).split(",") if a.strip()]
    assert len(params) == len(_build._SIGNATURES["spray_step"]) == 35


def test_spray_builds_without_contraction():
    assert "-fmad=false" in _build.SOURCE_FLAGS["spray.cu"]
    assert (_build._PKG / "csrc" / "spray.cu") in _build.SOURCES
