"""chip_smoke.py refuses to run anywhere but on a GPU, and its trace parity
gate tells rounding from faults."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from stereo_dso_g2o_tpu.ops import trace as trace_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr, proc.stderr[-2000:]
    # no result line: nothing on stdout claims success
    assert '"ok"' not in proc.stdout, proc.stdout[-2000:]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _results(n=400, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.05, 0.1, n)
    return trace_ops.TraceResult(
        status=np.full(n, trace_ops.IPS_GOOD, np.int32),
        idepth_min=lo.astype(np.float32),
        idepth_max=(lo + 0.05).astype(np.float32),
        last_uv=rng.uniform(8, 300, (n, 2)).astype(np.float32),
        pixel_interval=np.full(n, 0.8, np.float32),
        quality=np.full(n, 10.0, np.float32),
        best_energy=np.zeros(n, np.float32),
    )


# (trace name, what the GPU side gets wrong, whether the gate passes)
CASES = [
    ("trace_temporal", "nothing", True),
    # a near-infinite-depth point: the interval's lower end changes sign
    # under a small match shift; the interval-width floor keeps it small
    ("trace_temporal", "sign flip near 0", True),
    ("trace_temporal", "5 % of one half off by half", False),
    ("trace_stereo_lr", "5 % of one half off by 1 %", False),
]


@pytest.mark.parametrize("name,fault,passes", CASES)
def test_compare_traces_gate(name, fault, passes):
    cs = _load_chip_smoke()
    r_cpu = _results()
    lo = r_cpu.idepth_min.copy()
    n = lo.size
    finite_half = np.arange(n // 2, n)
    if fault == "sign flip near 0":
        lo[:4] = -1e-4
        r_cpu = r_cpu._replace(idepth_min=np.where(
            np.arange(n) < 4, 1e-4, r_cpu.idepth_min).astype(np.float32))
    elif fault == "5 % of one half off by half":
        lo[finite_half[:n // 40]] *= 1.5
    elif fault == "5 % of one half off by 1 %":
        lo[finite_half[:n // 40]] *= 1.01
    r_gpu = r_cpu._replace(idepth_min=lo.astype(np.float32))
    if passes:
        out = cs.compare_traces(name, r_gpu, r_cpu)
        assert out["status_match"] == 1.0
    else:
        with pytest.raises(cs.SmokeFailure, match="finite"):
            cs.compare_traces(name, r_gpu, r_cpu)
