#!/usr/bin/env python
"""Smoke test of the stereo-DSO main path on an NVIDIA GPU.

    python chip_smoke.py           # one GPU: device, parity, pipeline, batched
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

Phases, in order; any failure exits non-zero, and nothing falls back to the
CPU:

- device: JAX must report platform "gpu". Prints the card's name and power
  limit as nvidia-smi reports them, and JAX's device_kind.
- parity: the same jitted code on the GPU and on the host CPU, in this
  process, at bench widths (1216x352): the temporal `trace` and the L->R
  `trace_stereo` over 5120 lanes, and one windowed-BA Gauss-Newton
  iteration at F=8, NP=2048. Matmul precision is "highest" (no TF32), so
  the tolerances cover f32 rounding order only (see compare_traces for how
  the trace amplifies it).
- pipeline: FullSystem bootstrap, then GraphSystem (one fused program per
  frame) over a rendered hostile corridor with device-resident frames.
  Every pose finite, not lost, >= 8 keyframes, >= 1 frame marginalized.
- batched: BatchedRunner over 2 sequences, KF buckets pre-compiled,
  10 frames after warm-up; every pose finite.

--multi runs only `__graft_entry__.dryrun_multichip(4)`: the point-sharded
windowed BA and the sequence-sharded stereo match, each against its
single-device reference.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_LANES = 5120  # Settings.trace_cap: the per-frame trace pool
PIPE_FRAMES = 100
BATCH_SEQS = 2
BATCH_TIMED = 10
WARM = 8  # graph frames run before timing: compiles both cond branches

# parity limits
STATUS_MATCH_MIN = 0.99
IDEPTH_REL_MAX = 1e-3
# per trace, for each half of the lanes: (least share within IDEPTH_REL_MAX,
# largest q99 of the idepth rel diff), set from H100 readings (PERF.md,
# "H100 bring-up"). The temporal trace searches a long epipolar line and
# amplifies rounding far more than the stereo trace does.
TRACE_LIMITS = {"trace_temporal": (0.80, 0.1),
                "trace_stereo_lr": (0.98, 2e-3)}
MIN_KFS = 8
BA_ENERGY_REL_MAX = 1e-4
BA_STATE_ATOL = 5e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


class CompileClock:
    """Sums JAX's backend-compile durations (XLA compiling a lowered
    program), so each phase can report its compile seconds. Tracing and
    lowering are left out: their events nest, so their sums double-count."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event == self.EVENT:
            self.total += duration


# --------------------------------------------------------------------------
# device


def check_device(n_devices: int):
    """Fail unless JAX sees at least n_devices GPUs; print their identity."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found platform {devs[0].platform!r} "
          f"({devs[0].device_kind}); chip_smoke runs only on a GPU")
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax: {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform}, jax {jax.__version__})")
    return devs[:n_devices]


# --------------------------------------------------------------------------
# parity


def trace_inputs(left_h, left_t, right_h, K, T_th, baseline, n, settings,
                 seed=0):
    """Trace inputs over n random lanes of the host image: half fresh
    points (interval [0, inf)), half with a finite interval."""
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.ops import trace as trace_ops
    from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid

    h, w = left_h.shape
    rng = np.random.default_rng(seed)
    us = rng.uniform(8, w - 8, n).astype(np.float32)
    vs = rng.uniform(8, h - 8, n).astype(np.float32)
    mid = rng.uniform(0.02, 0.2, n).astype(np.float32)
    fresh = np.arange(n) < n // 2
    id_min = np.where(fresh, 0.0, 0.5 * mid).astype(np.float32)
    id_max = np.where(fresh, np.nan, 1.5 * mid).astype(np.float32)

    def dI(img):
        return build_pyramid(jnp.asarray(img).astype(jnp.float32), 1)[0][0]

    dI_h, dI_t, dI_r = dI(left_h), dI(left_t), dI(right_h)
    color, weights, gradH, eth = trace_ops.extract_point_data(
        dI_h, jnp.asarray(us), jnp.asarray(vs), settings
    )
    common = (
        jnp.asarray(us), jnp.asarray(vs), jnp.asarray(id_min),
        jnp.asarray(id_max), color, weights, gradH, eth,
        jnp.full((n,), 10000.0, jnp.float32),
        jnp.full((n,), trace_ops.IPS_UNINITIALIZED, jnp.int32),
    )
    Kf = np.asarray(K, np.float64)
    KRKi = Kf @ T_th[:3, :3] @ np.linalg.inv(Kf)
    Kt = Kf @ T_th[:3, 3]
    temporal = common + (
        jnp.asarray(KRKi, jnp.float32), jnp.asarray(Kt, jnp.float32),
        jnp.asarray([1.0, 0.0], jnp.float32), dI_t,
    )
    stereo = common + (
        jnp.asarray(K, jnp.float32), jnp.float32(baseline), dI_r,
    )
    return temporal, stereo


def compare_traces(name, r_gpu, r_cpu):
    """Lane-wise agreement of two trace results.

    Two f32 implementations cannot agree lane for lane to rounding: the
    reference's deterministic sub-pixel shift, frac(1000 * u_min)
    (ImmaturePoint.cpp:637-639), turns a one-ulp difference in u_min (the
    GPU contracts multiply-adds into FMAs, the CPU does not) into up to 1/32
    px of shift of the whole search. The discrete argmin can then flip on a
    near-tie, and the GN refinement lands a few hundredths of a pixel away.
    So: statuses must agree on STATUS_MATCH_MIN of the lanes, and status and
    match (best positions within half a pixel) together on the same share.
    On those lanes the idepth rel diff is |a - b| / max(|a|, |b|, width),
    width being the CPU's idepth interval: an interval's lower end near 0
    (a point near infinite depth) moves by the match shift times the
    interval's slope and may change sign, which a plain ratio would read as
    a rel diff above 1. Each half of the lanes (fresh, finite interval; see
    trace_inputs) must have TRACE_LIMITS[name] = (least share within
    IDEPTH_REL_MAX, largest q99) on its own.
    """
    from stereo_dso_g2o_tpu.ops import trace as trace_ops

    share_min, q99_max = TRACE_LIMITS[name]
    st_g, st_c = np.asarray(r_gpu.status), np.asarray(r_cpu.status)
    uv_g, uv_c = np.asarray(r_gpu.last_uv), np.asarray(r_cpu.last_uv)
    same_status = st_g == st_c
    same_match = same_status & (np.abs(uv_g - uv_c).max(axis=1) < 0.5)
    lo_c = np.asarray(r_cpu.idepth_min, np.float64)
    width = np.nan_to_num(np.abs(np.asarray(r_cpu.idepth_max) - lo_c))
    rel = np.zeros(st_c.size)
    for field in ("idepth_min", "idepth_max"):
        a = np.asarray(getattr(r_gpu, field), np.float64)
        b = np.asarray(getattr(r_cpu, field), np.float64)
        check(np.array_equal(np.isnan(a[same_match]), np.isnan(b[same_match])),
              f"{name}: {field} NaN on one side only")
        den = np.maximum.reduce([np.abs(a), np.abs(b), width,
                                 np.full_like(a, 1e-30)])
        rel = np.maximum(rel, np.nan_to_num(np.abs(a - b) / den))
    frac_status = float(same_status.mean())
    frac = float(same_match.mean())
    n_good = int((st_c == trace_ops.IPS_GOOD).sum())
    log(f"parity {name}: {st_g.size} lanes ({n_good} GOOD on the CPU); "
        f"status equal on {frac_status!r}, status and match equal on "
        f"{frac!r} (limit >= {STATUS_MATCH_MIN} each)")
    check(frac_status >= STATUS_MATCH_MIN,
          f"{name}: status agreement {frac_status} too low")
    check(frac >= STATUS_MATCH_MIN, f"{name}: match agreement {frac} too low")
    fresh = np.arange(st_c.size) < st_c.size // 2
    out = {"status_match": frac_status, "match": frac}
    for half, in_half in (("fresh", fresh), ("finite", ~fresh)):
        r = rel[same_match & in_half]
        share = float((r <= IDEPTH_REL_MAX).mean())
        q99 = float(np.quantile(r, 0.99))
        log(f"parity {name} {half} half: idepth rel diff on {r.size} lanes: "
            f"within {IDEPTH_REL_MAX} on {share!r} (limit >= {share_min}), "
            f"q99 {q99!r} (limit <= {q99_max}), max {float(r.max())!r}")
        check(share >= share_min,
              f"{name} {half}: idepth within {IDEPTH_REL_MAX} on {share}")
        check(q99 <= q99_max, f"{name} {half}: idepth rel diff q99 {q99}")
        out[half] = {"share_within": share, "q99": q99}
    return out


def phase_parity(seq, settings, gpu, cpu):
    """GPU vs host-CPU parity of the traces and of one BA iteration. The
    CPU programs write nothing to the compile cache (compile_cache.py)."""
    import functools

    import jax

    import bench
    from stereo_dso_g2o_tpu.backend import ba
    from stereo_dso_g2o_tpu.ops import trace as trace_ops
    from stereo_dso_g2o_tpu.runtime import compile_cache

    K, lefts, rights, poses_wc = seq
    host, target = 0, 2
    T_th = np.linalg.inv(poses_wc[target]) @ poses_wc[host]
    temporal, stereo = trace_inputs(
        lefts[host], lefts[target], rights[host], K, T_th, bench.BASE,
        N_LANES, settings,
    )

    def stereo_lr(*args):
        return trace_ops.trace_stereo(*args, mode_right=True,
                                      settings=settings)[0]

    out = {}
    runs = (
        ("trace_temporal",
         functools.partial(trace_ops.trace, settings=settings), temporal),
        ("trace_stereo_lr", stereo_lr, stereo),
    )
    for name, fn, args in runs:
        r_g = fn(*jax.device_put(args, gpu))
        with compile_cache.no_writes():
            r_c = fn(*jax.device_put(args, cpu))
        out[name] = compare_traces(name, r_g, r_c)

    import __graft_entry__

    win, dI_stack, ba_settings = __graft_entry__.production_window()
    step = functools.partial(ba.ba_iteration, settings=ba_settings)

    def run_ba(dev):
        w_, d_ = jax.device_put((win, dI_stack), dev)
        win_o, energy, _, nres = step(w_, d_, jax.device_put(0, dev))
        return jax.device_get((win_o.state, energy, nres))

    st_g, e_g, n_g = run_ba(gpu)
    with compile_cache.no_writes():
        st_c, e_c, n_c = run_ba(cpu)
    e_rel = abs(float(e_g) - float(e_c)) / max(abs(float(e_c)), 1e-30)
    st_diff = float(np.abs(np.asarray(st_g) - np.asarray(st_c)).max())
    log(f"parity ba_iteration: F={win.F} NP={win.pt_u.shape[0]} nres "
        f"{int(n_g)}/{int(n_c)}, energy {float(e_g)!r} vs {float(e_c)!r} "
        f"rel diff {e_rel!r} (limit <= {BA_ENERGY_REL_MAX}), state step max "
        f"abs diff {st_diff!r} (limit <= {BA_STATE_ATOL})")
    check(int(n_g) == int(n_c), f"ba: nres {int(n_g)} != {int(n_c)}")
    check(np.isfinite(float(e_g)), "ba: non-finite GPU energy")
    check(e_rel <= BA_ENERGY_REL_MAX, f"ba: energy rel diff {e_rel}")
    check(st_diff <= BA_STATE_ATOL, f"ba: state step diff {st_diff}")
    out["ba_iteration"] = {"energy_rel": e_rel, "state_max_abs": st_diff}
    return out


# --------------------------------------------------------------------------
# pipeline


def make_calib_for(K, w, h):
    import bench
    from stereo_dso_g2o_tpu.models.camera import make_calib

    return make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE,
                      w, h, n_levels=6)


def bootstrap(calib, settings, lefts, rights):
    import bench
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem

    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    return GraphSystem.from_full_system(fs)


def phase_pipeline(seq, settings, clock):
    import jax
    import jax.numpy as jnp

    import bench
    from stereo_dso_g2o_tpu.io import trajectory

    K, lefts, rights, poses_wc = seq
    n, h, w = lefts.shape
    calib = make_calib_for(K, w, h)
    c0, t0 = clock.total, time.perf_counter()
    gs = bootstrap(calib, settings, lefts, rights)
    lefts_d = jax.block_until_ready(jnp.asarray(lefts))
    rights_d = jax.block_until_ready(jnp.asarray(rights))
    bundles = []

    def step(i):
        b = gs.add_frame(lefts_d[i], rights_d[i], i, timestamp=0.1 * i)
        if b is not None:
            bundles.append(b)

    for i in range(bench.BOOT, bench.BOOT + WARM):
        step(i)
    bundles.extend(gs.flush())
    cold_s = time.perf_counter() - t0
    cold_compile_s = clock.total - c0

    c1, t1 = clock.total, time.perf_counter()
    for i in range(bench.BOOT + WARM, n):
        step(i)
    bundles.extend(gs.flush())
    dt = time.perf_counter() - t1
    fps = (n - bench.BOOT - WARM) / dt
    steady_compile_s = clock.total - c1

    traj = gs.trajectory()
    finite = all(bool(np.isfinite(T).all()) for T in traj)
    ate = trajectory.ate_rmse(traj, poses_wc)
    rel_t, rel_r = trajectory.kitti_rel_errors(
        traj, poses_wc, lengths=(10, 20), step=5
    )
    n_kfs = len(gs.kf_shells)
    n_marg = int(sum(int(np.sum(b.flagged)) for b in bundles))
    log(f"pipeline: {n} frames {w}x{h}, {n_kfs} keyframes, {n_marg} frames "
        f"marginalized, lost {gs.is_lost}, all poses finite {finite}")
    log(f"pipeline: ATE {ate!r} m, KITTI rel-trans {rel_t!r} %, rel-rot "
        f"{rel_r!r} deg/m (10/20 m segments)")
    log(f"pipeline: {fps!r} frames/s over {n - bench.BOOT - WARM} steady "
        f"frames; cold start {cold_s!r} s (bootstrap + {WARM} frames), of "
        f"which XLA compile {cold_compile_s!r} s; compile inside the timed "
        f"window {steady_compile_s!r} s")
    check(len(traj) == n and finite, "pipeline: non-finite pose")
    check(not gs.is_lost, "pipeline: tracking lost")
    check(n_kfs >= MIN_KFS, f"pipeline: only {n_kfs} keyframes")
    check(n_marg >= 1, "pipeline: no frame was marginalized")
    return {"fps": fps, "cold_s": cold_s, "cold_compile_s": cold_compile_s,
            "ate_m": ate, "rel_trans_pct": rel_t, "rel_rot_degpm": rel_r,
            "n_keyframes": n_kfs, "n_frames_marginalized": n_marg}


def phase_batched(seqs, settings):
    import jax
    import jax.numpy as jnp

    import bench
    from stereo_dso_g2o_tpu.parallel.batched import BatchedRunner

    K = seqs[0][0]
    h, w = seqs[0][1].shape[1:]
    calib = make_calib_for(K, w, h)
    n = bench.BOOT + WARM + BATCH_TIMED
    systems = [bootstrap(calib, settings, s[1], s[2]) for s in seqs]
    runner = BatchedRunner(systems)
    L_all = jax.block_until_ready(
        jnp.asarray(np.stack([s[1][:n] for s in seqs])))
    R_all = jax.block_until_ready(
        jnp.asarray(np.stack([s[2][:n] for s in seqs])))
    runner.warm_kf_buckets((seqs[0][1][bench.BOOT], seqs[0][2][bench.BOOT]))
    for i in range(bench.BOOT, bench.BOOT + WARM):
        runner.add_frames((L_all[:, i], R_all[:, i]), i, timestamp=0.1 * i)
    runner.flush()
    t0 = time.perf_counter()
    for i in range(bench.BOOT + WARM, n):
        runner.add_frames((L_all[:, i], R_all[:, i]), i, timestamp=0.1 * i)
    runner.flush()
    dt = time.perf_counter() - t0
    trajs = runner.trajectories()
    finite = all(np.isfinite(T).all() for tr in trajs for T in tr)
    agg = len(seqs) * BATCH_TIMED / dt
    log(f"batched: {len(seqs)} sequences x {BATCH_TIMED} timed frames, "
        f"{agg!r} aggregate frames/s, all poses finite {finite}")
    check(all(len(tr) == n for tr in trajs), "batched: missing poses")
    check(finite, "batched: non-finite pose")
    return {"agg_fps": agg}


# --------------------------------------------------------------------------


def run_single(devs):
    import jax

    import bench

    clock = CompileClock()
    settings = bench.bench_settings(small=False)
    t0 = time.perf_counter()
    seq0 = bench.render_sequence(0, PIPE_FRAMES, small=False)
    seq1 = bench.render_sequence(1, bench.BOOT + WARM + BATCH_TIMED,
                                 small=False)
    log(f"render: 2 sequences in {time.perf_counter() - t0!r} s")
    for name, run in (
        ("parity", lambda: phase_parity(seq0, settings, devs[0],
                                        jax.devices("cpu")[0])),
        ("pipeline", lambda: phase_pipeline(seq0, settings, clock)),
        ("batched", lambda: phase_batched([seq0, seq1][:BATCH_SEQS],
                                          settings)),
    ):
        t1, c1 = time.perf_counter(), clock.total
        run()
        log(f"phase {name}: {time.perf_counter() - t1!r} s, of which XLA "
            f"compile {clock.total - c1!r} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded BA + sharded stereo match only")
    args = ap.parse_args(argv)
    n_devices = 4 if args.multi else 1
    t_start = time.perf_counter()
    try:
        devs = check_device(n_devices)
        sys.path.insert(0, ROOT)
        import jax

        from stereo_dso_g2o_tpu.runtime import compile_cache

        jax.config.update("jax_default_matmul_precision", "highest")
        compile_cache.enable()
        if args.multi:
            import __graft_entry__

            __graft_entry__.dryrun_multichip(n_devices)
        else:
            run_single(devs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start!r} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
