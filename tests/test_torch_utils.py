"""The port's utilities (observability, profiling, audio, clipmap, exports)
and its scripts (`demo_torch.py`, `examples/quickstart_torch.py`), on the
CPU; twins of tests/test_utils.py and tests/test_examples.py.

Tolerances: the audio loops, the mix and the WAV bytes equal to the JAX
package's (the same NumPy code); `build_clipmap` equal to the JAX
package's (vertices within rtol 1e-6 as tests/test_utils.py:9-15 holds its
native build to the NumPy twin, indices equal).
"""
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.utils import audio as jaudio, clipmap as jclipmap

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch import models as tmodels, utils as tutils
from godotoceanwaves_tpu_torch.utils import audio as taudio, clipmap as tclipmap
from godotoceanwaves_tpu_torch.utils import observability, profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_frame_stats_and_panel():
    stats = observability.FrameStats()
    for _ in range(5):
        stats.record(0.01)
    s = stats.summary()
    assert abs(s["fps"] - 100.0) < 1.0 and abs(s["ms_p50"] - 10.0) < 1e-6
    assert observability.FrameStats().summary()["fps"] == 0.0
    ocean = T.Ocean(map_size=64, device="cpu")
    text = observability.panel(ocean, stats)
    assert "Cascade 1" in text and "wind_speed" in text and "FPS" in text
    assert "Step: fused" in text and "Cascade 3" in text
    assert "Step: staged" in observability.panel(
        T.Ocean(map_size=64, fused="never", device="cpu"))


def test_stage_timer():
    t = observability.StageTimer()
    for _ in range(2):
        with t("x"):
            time.sleep(0.01)
    assert t.counts["x"] == 2 and t.summary()["x"] >= 5.0   # ms a stage


def test_profile_step_and_trace_on_cpu(tmp_path):
    cfg = T.SimConfig(map_size=16)
    params = T.default_cascades(device="cpu")

    def one(state):
        return T.step(cfg, state, params, 0.02)[0]

    res = profiling.profile_step(one, T.init_state(cfg, params), iters=3)
    assert res["ms_per_call"] > 0 and res["calls_per_second"] > 0
    with pytest.raises(ValueError):
        profiling.profile_step(lambda c: c, {"a": 1.0})
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as prof:
        one(T.init_state(cfg, params))
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.trace(str(tmp_path / "t2")):
                pass


def test_audio_matches_jax(tmp_path):
    assert taudio.ambience_gains_db(0.0) == (-30.0, 5.0) == jaudio.ambience_gains_db(0.0)
    assert taudio.ambience_gains_db(100.0) == (15.0, -30.0)
    # the port's params (tensors) and the JAX package's give the same gains
    assert taudio.ambience_gains(T.default_cascades(device="cpu")) == \
        jaudio.ambience_gains(J.default_cascades())
    dur, sr = 0.5, 8000
    for name in ("synthesize_ocean_loop", "synthesize_wind_loop"):
        got = getattr(taudio, name)(dur, sr)
        np.testing.assert_array_equal(got, getattr(jaudio, name)(dur, sr))
        assert abs(got[0] - got[-1]) < 0.2         # seamless: harmonics of the loop only
    calm = types.SimpleNamespace(wind_speed=np.zeros(3, np.float32))
    np.testing.assert_array_equal(taudio.render_ambience(calm, dur, sr),
                                  jaudio.render_ambience(calm, dur, sr))
    mix = taudio.render_ambience(T.default_cascades(device="cpu"), dur, sr)
    assert taudio.wav_bytes(mix, sr) == jaudio.wav_bytes(mix, sr)
    taudio.write_wav(str(tmp_path / "a.wav"), mix, sr)
    assert (tmp_path / "a.wav").read_bytes() == jaudio.wav_bytes(mix, sr)


@pytest.mark.parametrize("kw", [dict(levels=3, center_res=16, ring_cells=4, extent=512.0),
                                dict(levels=4, center_res=64, ring_cells=16, extent=512.0)])
def test_build_clipmap_matches_jax(kw):
    tv, ti = tclipmap.build_clipmap(**kw)
    jv, ji = jclipmap.build_clipmap(**kw)
    assert tv.dtype == jv.dtype == np.float32 and ti.dtype == ji.dtype == np.uint32
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tclipmap.build_clipmap(**kw, prefer_native=False)[0], tv)


def test_exports_name_the_jax_packages():
    """utils and models export the JAX package's names (time_chained is
    time_cuda here)."""
    import godotoceanwaves_tpu.models as jmodels
    import godotoceanwaves_tpu.utils as jutils
    missing = set(jutils.__all__) - set(tutils.__all__) - {"time_chained"}
    assert not missing, missing
    assert "time_cuda" in tutils.__all__ and not hasattr(tutils, "time_chained")
    assert {"SceneRenderer", "SpraySession"} <= set(tmodels.__all__)
    assert not set(jmodels.__all__) - set(tmodels.__all__)


def _run(args, timeout=300):
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT),
                          env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_demo_torch_frame_loop_cpu_end_to_end(tmp_path):
    """`demo_torch.py --cpu` drives the offline pipeline: sim, spray,
    displaced-geometry render, pipelined fetch, GIF encode."""
    Image = pytest.importorskip("PIL.Image")
    gif = tmp_path / "ocean.gif"
    _run(["demo_torch.py", "--cpu", "--map-size", "64", "--frames", "3", "--warmup", "2",
          "--width", "96", "--height", "64", "--spray", "--spray-particles", "128",
          "--environment", "--camera", "0,5,0", "--pitch", "-8", "--gif", str(gif)])
    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size == (96, 64)


def test_demo_torch_batched_and_ambience_cpu(tmp_path):
    out = _run(["demo_torch.py", "--cpu", "--map-size", "32", "--frames", "3", "--warmup", "1",
                "--width", "48", "--height", "32", "--frame-batch", "2", "--spray",
                "--spray-particles", "64", "--render-tier", "interactive", "--panel"])
    assert "frames: 3 x (32, 48, 3) uint8 on cpu" in out and "Cascade 1" in out
    wav = tmp_path / "amb.wav"
    out = _run(["demo_torch.py", "--ambience", str(wav), "--wind-speed", "3"])
    assert "ambience loop" in out and wav.stat().st_size > 1000


def test_quickstart_torch_cpu():
    out = _run([str(ROOT / "examples" / "quickstart_torch.py"), "--cpu"])
    assert "displacement planes: (3, 3, 256, 256)" in out
    assert "Step: fused" in out and "restored; times:" in out
