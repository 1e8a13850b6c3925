"""The port's shipped multi-card example stays runnable: a fresh
interpreter, 2 gloo workers on the CPU (tests/test_examples.py:25 checks
the JAX example the same way)."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_multichip_torch_example_on_two_cpu_workers():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "multichip_torch.py"), "--cpu",
         "--processes", "2"],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"},
        cwd="/tmp",  # anywhere: the script sys.path-bootstraps the repo root
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "mesh: {'patch': 2, 'rows': 4}" in out
    assert "displacement: (2, 3, 3, 256, 256) layout: blocks (1, 3, 3, 64, 256)" in out
    assert "process 0 of 2 holds positions [(0, 0), (0, 1), (0, 2), (0, 3)]" in out
    assert "per-patch height rms:" in out
    assert "sharded render: (176, 320, 3)" in out and "finite: True" in out
