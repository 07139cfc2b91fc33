"""Per-stage device-time attribution of the NON-keyframe frame step.

Companion to profile_kf_stages.py: times cumulative prefixes of the non-KF
path (mirrors frame_step.frame_step_full + graph_system._track_common — keep
in sync) so the steady-state non-KF frame is attributable:
pyramids | 1-hypothesis cascade | 5-hypothesis vmapped cascade + select |
speculative immature refinement. Reference workload anchor:
CoarseTracker::trackNewestCoarse (CoarseTracker.cpp:556-611) +
ImmaturePoint::traceOn sweep (FullSystem.cpp:570-607).

Run: python tools/profile_track_stages.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_REPS = 5


def main():
    import jax
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.runtime import compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache.enable()

    import bench
    from stereo_dso_g2o_tpu.frontend import frame_step as FS
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import (
        GraphSystem, _rigid_inv, motion_tries,
    )
    from stereo_dso_g2o_tpu.models.camera import Calib, make_calib
    from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid

    settings = bench.bench_settings()
    K, seqs = bench.render_sequences()
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE,
                       bench.W_, bench.H_, n_levels=6)
    lefts, rights, _ = seqs[0]

    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = GraphSystem.from_full_system(fs)
    for i in range(bench.BOOT, 30):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    state = gs.state
    left = jnp.asarray(lefts[30])
    right = jnp.asarray(rights[30])
    n_levels = calib.n_levels
    n_tries = 5
    s = settings
    calib_c, baseline = calib.c, calib.baseline
    new_exposure = jnp.float32(1.0)

    # motion hypotheses exactly as _track_common builds them
    w2c_pre0 = np.asarray(jax.device_get(state.win.w2c()))

    def prefix(upto):
        def run(state, left, right):
            w2c_pre0 = state.win.w2c()
            ref_c2w = _rigid_inv(w2c_pre0[state.ref_slot])

            def fresh_c2w(comp, rel, slot, fid):
                ok = state.win.frame_valid[slot] & (
                    state.win.frame_id[slot] == fid
                )
                fresh = _rigid_inv(w2c_pre0[slot]) @ rel
                return jnp.where(ok, fresh, comp)

            last_c2w = fresh_c2w(state.last_c2w, state.last_rel,
                                 state.last_slot, state.last_fid)
            prev_c2w = fresh_c2w(state.prev_c2w, state.prev_rel,
                                 state.prev_slot, state.prev_fid)
            T_tries = motion_tries(last_c2w, prev_c2w, ref_c2w)[:n_tries]
            aff_init = state.last_aff

            cal = Calib(
                c=calib_c, baseline=baseline,
                w=tuple(left.shape[1] >> l for l in range(n_levels)),
                h=tuple(left.shape[0] >> l for l in range(n_levels)),
            )
            dIpL, _ = build_pyramid(left.astype(jnp.float32), n_levels)
            dIpR, _ = build_pyramid(right.astype(jnp.float32), n_levels)
            if upto == 1:
                return dIpL, dIpR
            abort_inf = jnp.full((n_levels,), jnp.inf, jnp.float32)

            def one_try(T_init):
                return FS.track_cascade(
                    state.ref, dIpL, cal, T_init, aff_init, state.ref_aff,
                    state.ref_exposure, new_exposure, abort_inf, s,
                )

            if upto == 2:
                return one_try(T_tries[0])
            tb = jax.vmap(one_try)(T_tries)
            track = FS._select(tb, state.last_rmse0, s, n_tries)
            if upto == 3:
                return track
            imm_out = FS._nonkey_refine(
                state.win, state.imm, dIpL[0], dIpR[0], cal, track.T,
                track.aff, new_exposure, state.ref_slot, baseline, s,
            )
            return track, imm_out

        return jax.jit(run)

    names = [
        (1, "pyramids"),
        (2, "cascade_1try"),
        (3, "cascade_5try_select"),
        (4, "nonkey_refine"),
    ]
    results = {}
    cums = {}
    for upto, name in names:
        fn = prefix(upto)
        out = fn(state, left, right)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(N_REPS):
            jax.block_until_ready(fn(state, left, right))
        dt = (time.perf_counter() - t0) / N_REPS * 1e3
        cums[name] = dt
        results[f"prefix_{name}_ms"] = round(dt, 2)
        print(json.dumps({"progress": name, "cum_ms": round(dt, 2)}),
              flush=True)
    results["stage_pyramids_ms"] = round(cums["pyramids"], 2)
    results["stage_cascade_1try_ms"] = round(
        cums["cascade_1try"] - cums["pyramids"], 2
    )
    results["stage_cascade_5try_select_ms"] = round(
        cums["cascade_5try_select"] - cums["pyramids"], 2
    )
    results["stage_nonkey_refine_ms"] = round(
        cums["nonkey_refine"] - cums["cascade_5try_select"], 2
    )
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
