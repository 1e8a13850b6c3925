"""The port's entry points (`graft_entry_torch.py`) against the JAX
package's (`__graft_entry__.py`): one step of the flagship pipeline (3
cascades at 512^2) within 1e-4 relative RMS (maps) and 1e-4 RMS (foam),
as tests/test_torch_slice.py holds a step, and the multi-process dry run
on gloo workers (tests/test_graft_entry.py runs JAX's dry run).
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import __graft_entry__  # noqa: E402
import graft_entry_torch  # noqa: E402


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / max(1e-24, np.mean(ref ** 2))))


def test_entry_matches_jax_entry():
    jfn, jargs = __graft_entry__.entry()
    jstate, jmaps = jax.jit(jfn)(*jargs)
    fn, args = graft_entry_torch.entry(device="cpu")
    assert args[0].h0.device.type == "cpu"
    state, maps = fn(*args)
    assert tuple(maps.displacement.shape) == (3, 3, 512, 512)
    assert bool(maps.displacement.isfinite().all())
    for name in ("displacement", "normal"):
        assert rel_rms(getattr(maps, name).float().numpy(),
                       np.asarray(getattr(jmaps, name), np.float32)) <= 1e-4, name
    foam = state.foam.numpy().astype(np.float64) - np.asarray(jstate.foam, np.float64)
    assert float(np.sqrt(np.mean(foam ** 2))) <= 1e-4
    np.testing.assert_array_equal(state.time.numpy(), np.asarray(jstate.time))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.dryrun_multichip(8)


@pytest.mark.parametrize("n,rows,legs", [(5, 1, 2), (4, 2, 3)])
def test_dryrun_multichip_on_gloo_workers(n, rows, legs, capsys):
    """n processes, one position each: odd n runs rows = 1 (no leg 3, as
    JAX skips it); n = 4 runs rows = 2, each rows group across 2 processes,
    and leg 3's exchange across processes is bit-equal to copies."""
    out = graft_entry_torch.dryrun_multichip(n, device="cpu", timeout_s=120)
    assert out["mesh"] == {"patch": n // rows, "rows": rows}
    assert out["processes"] == n and out["backend"] == "gloo"
    assert out["image"] == (16 * n, 64, 3)
    assert out["foreign"] == []
    printed = capsys.readouterr().out
    assert printed.count(" OK: ") == legs
    if rows > 1:
        assert out["leg3_err"] == 0.0 and out["N"] == 256
    else:
        assert "leg 3/3 SKIPPED" in printed
