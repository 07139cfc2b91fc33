#!/usr/bin/env python
"""CLI playback driver — the main_dso_pangolin.cpp equivalent.

Usage (key=value arguments like the reference, main_dso_pangolin.cpp:146-341):

    python run_odometry.py files=/path/to/kitti/seq/05 calib=/path/camera.txt \
        preset=0 mode=1 output=traj.txt

    python run_odometry.py files=... intrinsics=fx,fy,cx,cy baseline=0.54

    # idepth-map-only workload (MODE_STEREOMATCH, main:473-491):
    python run_odometry.py files=... calib=... stereomatch=1

    # synthetic self-test (no dataset needed):
    python run_odometry.py synthetic=20

Presets 0-3 mirror the reference's settingsDefault (main:90-144): point
densities, window size; realtime throttling is meaningless in playback and is
ignored. `quiet=1` silences per-frame output. A timing report (fps, ms/frame)
is printed at the end like main:534-545.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def parse_args(argv):
    args = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            args[k] = v
    return args


def apply_preset(preset: int):
    from stereo_dso_g2o_tpu.config import Settings

    # main_dso_pangolin.cpp:90-144 settingsDefault
    if preset in (0, 1):
        return Settings(
            desired_point_density=2000.0,
            desired_immature_density=1500.0,
            max_frames=7,
            min_frames=5,
            max_opt_iterations=6,
            min_opt_iterations=1,
            immature_cap=2048,
            active_cap=2048,
        )
    # fast presets 2/3: 800 points, 5-frame window
    return Settings(
        desired_point_density=800.0,
        desired_immature_density=600.0,
        max_frames=5,
        min_frames=4,
        max_opt_iterations=4,
        min_opt_iterations=1,
        immature_cap=1024,
        active_cap=1024,
    )


def run_synthetic(n_frames: int, quiet: bool):
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.io import synthetic, trajectory
    from stereo_dso_g2o_tpu.models.camera import make_calib
    from stereo_dso_g2o_tpu.utils import se3

    w, h, b = 256, 128, 0.12
    K = synthetic.default_K(w, h)
    scene = synthetic.default_scene(0)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], b, w, h, n_levels=5)
    fs = FullSystem(calib, apply_preset(2))
    gt = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        xi = np.array([0.025 * i, -0.008 * i, 0.04 * i, 0.002 * i, 0.004 * i, -0.001 * i])
        T = np.asarray(se3.se3_exp(jnp.asarray(xi)), dtype=np.float64)
        gt.append(np.linalg.inv(T))
        left, right, _ = synthetic.render_stereo_pair(scene, K, w, h, b, T)
        fs.add_frame(left, right, i, timestamp=0.1 * i)
        if not quiet:
            print(f"frame {i}: kfs={len(fs.kf_slots)} lost={fs.is_lost}")
    dt = time.perf_counter() - t0
    traj = fs.trajectory()
    ate = trajectory.ate_rmse(traj, gt)
    print(f"synthetic run: {n_frames} frames, ATE={ate * 1000:.2f}mm, "
          f"{n_frames / dt:.2f} fps ({1000 * dt / n_frames:.1f} ms/frame incl. compile)")
    return 0


def main(argv):
    from stereo_dso_g2o_tpu.runtime import compile_cache

    compile_cache.enable()
    args = parse_args(argv)
    quiet = args.get("quiet", "0") == "1"

    if "synthetic" in args:
        return run_synthetic(int(args["synthetic"]), quiet)

    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.stereo_match import stereo_match
    from stereo_dso_g2o_tpu.io import trajectory
    from stereo_dso_g2o_tpu.io.dataset import StereoDataset
    from stereo_dso_g2o_tpu.io.output_wrapper import SampleOutputWrapper

    files = args.get("files")
    if not files:
        print(__doc__)
        return 1

    intr = None
    if "intrinsics" in args:
        intr = tuple(float(v) for v in args["intrinsics"].split(","))
    ds = StereoDataset(
        files,
        calib_file=args.get("calib"),
        intrinsics=intr,
        baseline=float(args["baseline"]) if "baseline" in args else None,
        gamma_file=args.get("gamma"),
        vignette_file=args.get("vignette"),
        n_levels=int(args.get("levels", 6)),
    )
    n = len(ds)
    if "maxframes" in args:
        n = min(n, int(args["maxframes"]))
    start = int(args.get("start", 0))

    if args.get("stereomatch", "0") == "1":
        # MODE_STEREOMATCH (FullSystem::stereoMatch per pair)
        for i in range(start, n):
            left, right, ts, exp = ds.get(i)
            result, imap = stereo_match(left, right, ds.calib)
            ngood = int(np.asarray(result.good).sum())
            print(f"frameID {i} got good matches {ngood}")
        return 0

    settings = apply_preset(int(args.get("preset", 0)))
    fs = FullSystem(ds.calib, settings)
    wrapper = SampleOutputWrapper() if not quiet else None
    feed_fh = None
    if "feed" in args:
        from stereo_dso_g2o_tpu.io.output_wrapper import JsonlOutputWrapper

        feed_fh = open(args["feed"], "w")
        wrapper = JsonlOutputWrapper(feed_fh)
    viz = args.get("viz")
    accum = None
    if viz or feed_fh:
        from stereo_dso_g2o_tpu.io.viewer import CloudAccumulator

        accum = CloudAccumulator()

    def frames():
        """Frame stream: native C++ prefetch (decode + remap + photometric on
        worker threads) unless disabled via prefetch=0 or start/maxframes
        windowing needs random access."""
        if args.get("prefetch", "1") == "1" and start == 0 and n == len(ds):
            for i, item in enumerate(ds.prefetch()):
                yield (i, *item)
        else:
            for i in range(start, n):
                yield (i, *ds.get(i))

    # graph=1 (default): after host bootstrap, continue on the fused
    # one-dispatch-per-frame graph pipeline (the production path; graph=0
    # keeps the host orchestrator for the whole run)
    use_graph = args.get("graph", "1") == "1"

    t0 = time.perf_counter()
    n_done = 0
    n_kfs_seen = 0
    for i, left, right, ts, exp in frames():
        if (
            use_graph
            and isinstance(fs, FullSystem)
            and fs.initialized
            and not fs.init_failed
            and not fs.is_lost
            and len(fs.kf_shells) >= 4
            and len(fs.history) >= 3
        ):
            from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem

            fs = GraphSystem.from_full_system(fs)
        fs.add_frame(left, right, i, timestamp=ts, exposure=exp)
        n_done += 1
        if wrapper and fs.history:
            sh = fs.history[-1]
            wrapper.publish_cam_pose(sh.id, fs._shell_T_cw(sh), sh.timestamp)
        if accum is not None and len(fs.kf_shells) > n_kfs_seen:
            n_kfs_seen = len(fs.kf_shells)
            accum.update_from(fs)
            if wrapper:
                wrapper.publish_keyframes(
                    [(k, sh.T_cw) for k, sh in enumerate(fs.kf_shells)
                     if sh.T_cw is not None],
                    fs.point_cloud(),
                )
        if fs.init_failed and len(fs.kf_shells) <= 4:
            # full reset, keep playing (main_dso_pangolin.cpp:497-514)
            print(f"RESETTING at frame {i} (initialization failed)")
            fs = FullSystem(ds.calib, settings)
            continue
        if fs.is_lost:
            print("LOST: aborting (reference aborts too, main:516-519)")
            break
    dt = time.perf_counter() - t0

    out = args.get("output", "result.txt")
    trajectory.write_kitti(out, fs.trajectory())
    print(
        f"processed {n_done} frames in {dt:.1f}s "
        f"({n_done / max(dt, 1e-9):.2f} fps, {1000 * dt / max(n_done, 1):.1f} ms/frame)"
    )
    print(f"trajectory written to {out} ({len(fs.kf_shells)} keyframes)")
    if feed_fh:
        feed_fh.close()
        print(f"viewer feed written to {args['feed']}")
    if viz:
        from stereo_dso_g2o_tpu.io.viewer import render_run

        xyz, idp = accum.cloud()
        render_run(viz, fs.trajectory(), xyz, idp)
        print(f"visualization written to {viz} ({len(xyz)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
