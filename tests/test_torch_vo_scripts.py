"""The port's VO gauges (``dynslam_tpu_torch/scripts/vo_drift.py`` and
``vo_diag.py``) beside the JAX package's scripts, run in a subprocess on
the CPU, on 8 frames of the gauge's sequence. The port draws its own
RANSAC hypotheses, so the two chains part by the draws: their printed
drift is held within 0.1 %/frame, their RMSE and final error within
5 mm, and vo_diag's three median biases within 0.01 px (measured: equal
to the printed digits)."""

import os
import re
import subprocess
import sys


from dynslam_tpu_torch.scripts import vo_diag, vo_drift
from torch_threads import threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 8
MAX_DRIFT_GAP_PCT, MAX_M_GAP, MAX_PX_GAP = 0.1, 5e-3, 0.01


torch_threads = threads(2)


def _numbers(text, pattern):
    return [float(x) for m in re.finditer(pattern, text) for x in m.groups()]


def _pair(name, argv):
    """(JAX script's stdout, the port script's stdout): the JAX script in
    a subprocess while the port's ``main`` runs in this process."""
    jax_run = subprocess.Popen(
        [sys.executable, f"scripts/{name}.py", *argv], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    port = subprocess.run(
        [sys.executable, "-m", f"dynslam_tpu_torch.scripts.{name}", *argv],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    return out, port.stdout


def test_vo_drift_beside_jax():
    jax_out, port_out = _pair("vo_drift", ["--cpu", "--frames", str(FRAMES)])
    pat = r"scale drift: ([-+0-9.]+) %"
    (jd,), (td,) = _numbers(jax_out, pat), _numbers(port_out, pat)
    assert abs(jd - td) <= MAX_DRIFT_GAP_PCT, (jd, td)
    pat = r"RMSE: ([0-9.]+) m \(final err ([0-9.]+) m"
    for a, b in zip(_numbers(jax_out, pat), _numbers(port_out, pat)):
        assert abs(a - b) <= MAX_M_GAP, (jax_out, port_out)
    assert f"{FRAMES} frames, path" in port_out


def test_vo_diag_beside_jax():
    jax_out, port_out = _pair("vo_diag", ["--cpu", "--frames", str(FRAMES)])
    pat = r":\s+([-+0-9.]+) px"
    jb, tb = _numbers(jax_out, pat), _numbers(port_out, pat)
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        assert abs(a - b) <= MAX_PX_GAP, (jb, tb)


def test_gauge_functions_agree_with_the_scripts():
    """``drift`` and ``diagnose`` (what ``chip_smoke.py`` calls) return
    the numbers the scripts print."""
    seq = vo_drift.render_sequence(4, 320, 96, 260.0, 0.5, 0.002)
    r = vo_drift.drift(seq, 320, 96, 260.0, "cpu")
    assert r["frames"] == 4 and abs(r["path"] - 1.5) < 0.01
    assert abs(r["drift_pct"]) < 3 and r["rmse"] < 0.05
    d = vo_diag.diagnose(seq, "cpu")
    assert all(abs(d[k]) < 0.2 for k in ("cur", "prev", "flow"))
