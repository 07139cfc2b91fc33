"""Steady-state per-frame profile + roofline attribution on the GPU.

- wall-time split: non-KF frames vs KF frames vs bundle-fetch overhead
  (the fused pipeline is ONE program per frame, so stage attribution is the
  KF/non-KF branch delta plus the host fetch)
- roofline split of the fused frame program from XLA cost analysis:
  FLOPs, device-memory bytes accessed, and the implied bounds at the
  device's published peaks (PEAKS, keyed by device_kind) vs the achieved
  rate. The engine runs with matmul precision "highest", so the f32 peak
  outside the tensor cores is the compute bound; TF32 is listed for
  reference.

Run: python tools/profile_frame.py [n_frames]  (uses the bench frame cache).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks (NVIDIA H100 SXM data sheet, 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,  # float32 outside the tensor cores
        "tf32_flops": 495e12,
        "hbm_bps": 3.35e12,
    },
}


def device_peaks(kind: str) -> dict:
    """Peaks of the device JAX reports as `kind`; an unknown kind is an
    error, never a default."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}")
    return PEAKS[kind]


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    import jax
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.runtime import compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache.enable()
    peaks = device_peaks(jax.devices()[0].device_kind)

    import bench
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem, frame_auto
    from stereo_dso_g2o_tpu.models.camera import make_calib

    settings = bench.bench_settings()
    K, seqs = bench.render_sequences()
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE,
                       bench.W_, bench.H_, n_levels=6)
    lefts, rights, poses = seqs[0]

    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = GraphSystem.from_full_system(fs)
    warm_until = bench.BOOT + 8
    for i in range(bench.BOOT, warm_until):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)

    # per-frame wall times, tagged KF/non-KF via the drained bundles
    # (the bundle for frame i arrives fetch_lag frames later — tag by the
    # drained record, time by the dispatching call)
    times, kinds = [], []
    end = min(bench.N_FRAMES, warm_until + n_frames)
    for i in range(warm_until, end):
        t0 = time.perf_counter()
        b = gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        times.append(time.perf_counter() - t0)
        kinds.append(None if b is None else bool(b.need_kf))
    gs.flush()

    # fetch overhead: one drained fetch timed alone
    t_all = np.array(times)
    kf_mask = np.array([k is True for k in kinds])
    nk_mask = np.array([k is False for k in kinds])
    out = {
        "n_timed": len(times),
        "fps": round(1.0 / t_all.mean(), 2),
        "frame_ms_mean": round(1e3 * t_all.mean(), 2),
        "frame_ms_p50": round(1e3 * np.median(t_all), 2),
        "frame_ms_p90": round(1e3 * np.quantile(t_all, 0.9), 2),
        # KF/non-KF attribution: the drained tag is lag-shifted, but in
        # steady state the mix is stationary, so the tagged medians estimate
        # the branch costs
        "kf_frame_ms_p50": (
            round(1e3 * np.median(t_all[kf_mask]), 2) if kf_mask.any()
            else None
        ),
        "nonkf_frame_ms_p50": (
            round(1e3 * np.median(t_all[nk_mask]), 2) if nk_mask.any()
            else None
        ),
        "kf_rate": round(float(kf_mask.mean()), 3),
        "n_keyframes": len(gs.kf_shells),
    }

    # roofline from XLA cost analysis of the fused frame program
    try:
        lowered = frame_auto.lower(
            gs.state, jnp.zeros((bench.H_, bench.W_), jnp.uint8),
            jnp.zeros((bench.H_, bench.W_), jnp.uint8),
            calib.c, calib.baseline, jnp.float32(1.0),
            settings=settings, n_levels=6, n_tries=5, pot=gs.pot,
            caps=gs.caps, w0=bench.W_, h0=bench.H_,
            imm_cap=settings.immature_cap,
        )
        cost = lowered.compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        bytes_acc = float(cost.get("bytes accessed", 0.0))
        t_frame = t_all.mean()
        out["frame_program_gflops"] = round(flops / 1e9, 2)
        out["frame_program_hbm_gb"] = round(bytes_acc / 1e9, 3)
        out["achieved_tflops"] = round(flops / t_frame / 1e12, 3)
        out["achieved_hbm_gbps"] = round(bytes_acc / t_frame / 1e9, 2)
        out["f32_util_pct"] = round(100 * flops / t_frame / peaks["f32_flops"], 2)
        out["hbm_util_pct"] = round(100 * bytes_acc / t_frame / peaks["hbm_bps"], 2)
        # time floors implied by each resource: what fraction of the frame
        # is explained by flops vs bytes at peak rates
        out["flops_floor_ms"] = round(1e3 * flops / peaks["f32_flops"], 3)
        out["hbm_floor_ms"] = round(1e3 * bytes_acc / peaks["hbm_bps"], 3)
    except Exception as e:
        out["cost_analysis_error"] = repr(e)[:200]

    print(json.dumps(out))


if __name__ == "__main__":
    main()
