"""Long-run stress: many keyframes, repeated marginalization, slot reuse.

Runs in a subprocess: the XLA CPU compiler in this jaxlib build segfaults
when this scenario's program variants are compiled after the rest of the
suite's (order-dependent native crash; the scenario itself is clean — it
passes standalone). Process isolation keeps the suite deterministic.
"""

import pytest
import os
import subprocess
import sys

SCENARIO = r"""
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from stereo_dso_g2o_tpu.config import Settings
from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu.io import synthetic, trajectory
from stereo_dso_g2o_tpu.models.camera import make_calib
from stereo_dso_g2o_tpu.utils import se3

W_, H_, BASE = 192, 96, 0.1
SET = Settings(
    desired_point_density=400.0,
    desired_immature_density=300.0,
    immature_cap=512,
    active_cap=512,
    min_frames=4,
    max_frames=5,
)

scene = synthetic.default_scene(41)
K = synthetic.default_K(W_, H_)
calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=4)
fs = FullSystem(calib, SET)

poses = []
max_kfs = 0
for i in range(24):
    xi = np.array([0.02 * i, -0.004 * i, 0.035 * i, 0.0, 0.012 * i, 0.0015 * i])
    T = np.asarray(se3.se3_exp(jnp.asarray(xi)), dtype=np.float64)
    poses.append(np.linalg.inv(T))
    left, right, _ = synthetic.render_stereo_pair(scene, K, W_, H_, BASE, T)
    fs.add_frame(left, right, i, timestamp=0.1 * i)
    assert not fs.is_lost, f"lost at {i}"
    max_kfs = max(max_kfs, len(fs.kf_slots))
    assert len(fs.kf_slots) <= SET.max_frames + 1
    assert len(set(fs.kf_slots)) == len(fs.kf_slots)

assert fs.next_kf_id > SET.max_frames + 1, fs.next_kf_id  # slot reuse happened
assert max_kfs >= SET.max_frames

ate = trajectory.ate_rmse(fs.trajectory(), poses)
assert ate < 0.05, ate

HM = np.asarray(fs.win.HM)
assert np.isfinite(HM).all() and np.abs(HM).max() > 0
np.testing.assert_allclose(HM, HM.T, atol=1e-3 * max(np.abs(HM).max(), 1))
print(f"LONGRUN_OK ate={ate * 1000:.2f}mm kfs_created={fs.next_kf_id}")
"""


@pytest.mark.slow
def test_long_sequence_with_marginalization_cycles():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCENARIO],
        env=env,
        capture_output=True,
        text=True,
        timeout=500,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LONGRUN_OK" in proc.stdout, proc.stdout[-500:]
