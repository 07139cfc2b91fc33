"""The engine's frozen pytree dataclasses (utils/pytree.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.models.camera import make_calib


def test_calib_roundtrips_through_jit_and_static_fields_retrace():
    calib = make_calib(100.0, 101.0, 63.5, 31.5, 0.2, 128, 64, n_levels=3)
    # only c and baseline are leaves; the per-level sizes are static
    assert len(jax.tree_util.tree_leaves(calib)) == 2
    traces = []

    @jax.jit
    def scale(c):
        traces.append(c.w)
        return c.replace(c=c.c * 2.0, baseline=c.baseline + 1.0)

    out = scale(calib)
    assert out.w == calib.w and out.h == calib.h
    np.testing.assert_allclose(np.asarray(out.c), 2.0 * np.asarray(calib.c))
    assert float(out.baseline) == pytest.approx(1.2)
    scale(calib.replace(c=calib.c + 1.0))  # new leaf values: no retrace
    assert len(traces) == 1
    scale(calib.replace(w=(64, 32, 16), h=(32, 16, 8)))  # static change
    assert len(traces) == 2
    with pytest.raises(Exception):
        calib.c = jnp.zeros(4)  # frozen


def test_window_replace_keeps_other_fields():
    win = W.empty_window(4, 16, [100.0, 100.0, 50.0, 30.0])
    win2 = win.replace(frame_valid=win.frame_valid.at[1].set(True))
    assert bool(win2.frame_valid[1]) and not bool(win.frame_valid[1])
    assert win2.pt_u is win.pt_u
    leaves = jax.tree_util.tree_leaves(jax.jit(lambda w: w)(win2))
    assert len(leaves) == len(jax.tree_util.tree_leaves(win))
