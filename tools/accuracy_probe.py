"""Single-sequence accuracy probe on the default JAX backend.

Runs bench sequence 0 (cached KITTI-res hostile corridor) through the
graph pipeline and prints one JSON line with ATE / KITTI rel errors /
keyframe count. Used for numerics A/B between backends (GPU vs host CPU)
and for the split-ladder A/B (SDSO_LADDER_FINE=k).

Run: python tools/accuracy_probe.py [n_frames]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from stereo_dso_g2o_tpu.runtime import compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache.enable()

    import bench
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem
    from stereo_dso_g2o_tpu.io import trajectory
    from stereo_dso_g2o_tpu.models.camera import make_calib

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else bench.N_FRAMES
    seq = int(os.environ.get("SDSO_PROBE_SEQ", "0"))
    settings = bench.bench_settings()
    K, seqs = bench.render_sequences()
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE,
                       bench.W_, bench.H_, n_levels=6)
    lefts, rights, poses = seqs[seq]

    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = GraphSystem.from_full_system(fs)
    # device-resident frames (same staging as bench.py)
    import jax.numpy as jnp

    lefts_d = jax.block_until_ready(jnp.asarray(lefts[:n_frames]))
    rights_d = jax.block_until_ready(jnp.asarray(rights[:n_frames]))
    t0 = time.perf_counter()
    for i in range(bench.BOOT, n_frames):
        gs.add_frame(lefts_d[i], rights_d[i], i, timestamp=0.1 * i)
    gs.flush()
    wall = time.perf_counter() - t0

    traj = gs.trajectory()
    ate = trajectory.ate_rmse(traj, poses[:n_frames])
    rel_t, rel_r = trajectory.kitti_rel_errors(
        traj, poses[:n_frames], lengths=(10, 20, 30, 40), step=5
    )
    print(json.dumps({
        "backend": jax.default_backend(),
        "seq": seq,
        "ladder_fine_levels": settings.ladder_fine_levels,
        "n_frames": n_frames,
        "ate_rmse_m": round(float(ate), 4),
        "kitti_rel_trans_pct": round(float(rel_t), 3),
        "kitti_rel_rot_degpm": round(float(rel_r), 5),
        "n_keyframes": len(gs.kf_shells),
        "lost": bool(gs.is_lost),
        "wall_s": round(wall, 1),
        "fps": round((n_frames - bench.BOOT) / wall, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
