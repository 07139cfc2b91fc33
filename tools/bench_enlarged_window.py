"""Enlarged-window BA on one device (VERDICT r4 stretch item 9).

Times one windowed-BA GN iteration on the device for the production window
(F=8, 2048 points) vs the config-5 enlarged window (F=16, 8192 points,
all-pairs residual cube), giving the config-5 cost model its first real
hardware point. The sharded path itself is correctness-proven on virtual
meshes (tests/test_dist_ba.py); one device cannot measure scaling, only
the single-device cost growth. Anchor: AccumulatedTopHessian.cpp:201-229
(the stitch is a sum over independent pair blocks -> psum).

Run: python tools/bench_enlarged_window.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

N_REPS = 5


def main():
    import jax
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.runtime import compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache.enable()

    from test_dist_ba import SET, _build_enlarged_window
    from stereo_dso_g2o_tpu.backend import ba

    out = {"backend": jax.default_backend()}
    for label, F, n_pts in (("production_F8_2048", 8, 2048),
                            ("enlarged_F16_8192", 16, 8192)):
        win, dI_stack = _build_enlarged_window(F=F, n_pts=n_pts)
        w, e, c, nres = ba.ba_iteration(win, dI_stack, jnp.asarray(0),
                                        settings=SET)
        jax.block_until_ready(e)
        t0 = time.perf_counter()
        for _ in range(N_REPS):
            jax.block_until_ready(ba.ba_iteration(
                win, dI_stack, jnp.asarray(0), settings=SET)[1])
        dt = (time.perf_counter() - t0) / N_REPS * 1e3
        out[f"{label}_iter_ms"] = round(dt, 1)
        out[f"{label}_nres"] = int(np.asarray(jax.device_get(nres)))
        print(json.dumps({"progress": label, "iter_ms": round(dt, 1),
                          "nres": out[f"{label}_nres"]}), flush=True)
    out["cost_ratio"] = round(
        out["enlarged_F16_8192_iter_ms"]
        / max(out["production_F8_2048_iter_ms"], 1e-9), 2,
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
