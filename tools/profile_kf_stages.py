"""Per-stage device-time attribution of the keyframe pipeline.

The fused frame program is ONE XLA program, so `tools/profile_frame.py` can
only split KF vs non-KF frames. This tool times CUMULATIVE PREFIXES of the
keyframe pipeline (mirroring graph_system._kf_branch step by step — keep in
sync with it) as separately jitted programs; consecutive diffs attribute
device time per stage, with XLA fusion effects included. Reference stage
inventory: FullSystem::makeKeyFrame (FullSystem.cpp:1168-1221).

Run: python tools/profile_kf_stages.py  (one process per device).
"""

from __future__ import annotations

import functools
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
    from stereo_dso_g2o_tpu.backend import ba, builder, window as W
    from stereo_dso_g2o_tpu.frontend import frame_step as FS
    from stereo_dso_g2o_tpu.frontend import immature as IMM
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import (
        GraphSystem, SEL_compact, _free_slot, _update_min_act_dist,
        flag_frames, frame_track, tracker_build_ref,
    )
    from stereo_dso_g2o_tpu.models.camera import make_calib
    from stereo_dso_g2o_tpu.ops import selector as SEL
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

    # step via the gated split until a steady-state keyframe fires; capture
    # (pre-state, aux) at the LAST one seen before `capture_after`
    capture_after = 40
    cap = None
    n_levels = calib.n_levels
    w0, h0 = calib.w[0], calib.h[0]
    common = dict(settings=settings, n_levels=n_levels, w0=w0, h0=h0)
    state = gs.state
    for i in range(bench.BOOT, capture_after):
        st_pre = state
        state, bundle, aux = frame_track(
            state, jnp.asarray(lefts[i]), jnp.asarray(rights[i]),
            calib.c, calib.baseline, jnp.float32(1.0), n_tries=5, **common,
        )
        if bool(jax.device_get(aux.need_kf)):
            cap = (st_pre, aux)
            # continue through the real KF so the window keeps churning
            from stereo_dso_g2o_tpu.frontend.graph_system import frame_kf
            state, _ = frame_kf(
                st_pre, aux, calib.c, calib.baseline, jnp.float32(1.0),
                pot=gs.pot, caps=gs.caps, imm_cap=settings.immature_cap,
                **common,
            )
    assert cap is not None, "no keyframe fired before capture_after"
    state_pre, aux = cap
    print(json.dumps({"progress": "captured_kf_state"}), flush=True)

    s = settings
    pot = jnp.asarray(gs.pot, jnp.int32)
    caps = gs.caps
    imm_cap = settings.immature_cap
    calib_c, baseline = calib.c, calib.baseline
    new_exposure = jnp.float32(1.0)

    # ---- cumulative prefixes of _kf_branch ----
    def prefix(upto):
        def run(state, aux):
            win = state.win
            imm = state.imm
            w2c_pre = win.w2c()
            T_new_w2c = aux.T_best @ w2c_pre[state.ref_slot]
            dIpL, dIpR0 = aux.dIpL, aux.dIpR0
            # 1: trace immature points onto the incoming KF
            imm = FS.kf_trace_step(
                win, imm, dIpL[0], calib_c, baseline, T_new_w2c,
                aux.aff_best, new_exposure, settings=s, n_levels=n_levels,
            )
            if upto == 1:
                return imm
            # 2-4: flagging, insertion, residual wiring
            flagged = flag_frames(win, imm.valid, state.kf_out_count, s)
            slot = _free_slot(win)
            kf_id = state.next_kf_id
            win = builder.insert_frame(
                win, slot, T_new_w2c, (aux.aff_best[0], aux.aff_best[1]),
                new_exposure, kf_id,
            )
            zero = jnp.zeros((), slot.dtype)
            dI0 = jax.lax.dynamic_update_slice(
                state.dI0_slots, dIpL[0][None], (slot, zero, zero, zero)
            )
            F = win.F
            active_pts = win.pt_status == W.PT_ACTIVE
            tgt = jnp.arange(F) == slot
            win = win.replace(
                res_exists=jnp.where(tgt[None, :], active_pts[:, None],
                                     win.res_exists),
                res_state=jnp.where(tgt[None, :], W.RES_IN, win.res_state),
                res_linearized=jnp.where(tgt[None, :], False,
                                         win.res_linearized),
            )
            if upto == 2:
                return win, imm, flagged, dI0
            # 5: activation
            n_active = jnp.sum(active_pts).astype(jnp.int32)
            mad = _update_min_act_dist(
                state.min_act_dist, n_active, s.desired_point_density
            )
            h1, w1 = calib.h[1], calib.w[1]
            cand_flat, delete = IMM.activation_gate(
                win, imm, slot, mad, calib_c, settings=s, h1=h1, w1=w1
            )
            imm = imm.replace(valid=imm.valid & ~delete)
            pre = W.precalc(win)
            act = IMM.optimize_immature(
                imm, cand_flat, pre["RTll"], pre["tTll"], pre["aff"],
                win.frame_valid, dI0, win.c_value, settings=s,
            )
            win, imm, n_activated = IMM.insert_activated(win, imm, act,
                                                         settings=s)
            if upto == 3:
                return win, imm, flagged, dI0
            # 6: windowed BA
            win, energy, nres = ba.optimize_fused(
                win, dI0, settings=s, max_its=s.max_opt_iterations
            )
            if upto == 4:
                return win, imm, flagged, dI0, energy, nres
            # 7-8: finalize + tracking-reference rebuild
            win, ref_inputs, gone, w2c_post, aff_all, _, (n_marg, n_drop) = \
                FS.kf_finalize(
                    win, dI0, dIpL[0], dIpR0, slot, flagged,
                    state.ref_slot, calib_c, baseline,
                    settings=s, n_levels=n_levels,
                )
            us_r, vs_r, id_r, wt_r, sel_r = ref_inputs
            id_maps, valid_maps, color_maps = tracker_build_ref(
                us_r, vs_r, id_r, wt_r, sel_r, dIpL, n_levels
            )
            new_ref = tuple(
                SEL_compact(id_maps[l], valid_maps[l], color_maps[l],
                            caps[l])
                for l in range(n_levels)
            )
            if upto == 5:
                return win, imm, new_ref, gone, w2c_post, n_marg, n_drop
            # 9: pixel selection + immature seeding
            asg = build_pyramid(dIpL[0][..., 0], 3)[1]
            ths = SEL.block_thresholds(asg[0], s)
            selm = SEL.select(
                dIpL[0], asg[0], asg[1], asg[2], ths, pot, 1.0,
                state.salt, s,
            )
            num_have = jnp.sum(selm.counts)
            quotia = s.desired_immature_density / jnp.maximum(num_have, 1.0)
            key = jax.random.fold_in(
                jax.random.PRNGKey(17), state.salt.astype(jnp.uint32)
            )
            keep = jax.random.uniform(key, selm.status_map.shape) < quotia
            status = jnp.where(
                quotia < 0.95, jnp.where(keep, selm.status_map, 0),
                selm.status_map,
            )
            us, vs, types, sel_valid = SEL.map_to_points(status, imm_cap)
            imm = IMM.seed_slot(
                imm, slot, dIpL[0], us, vs, types, sel_valid, settings=s
            )
            if upto == 6:
                return win, imm, new_ref, num_have
            # 10: marginalize flagged frames
            win = ba.marginalize_frames_masked(win, flagged, settings=s)
            imm = imm.replace(valid=imm.valid & ~flagged[:, None])
            return win, imm, new_ref, num_have

        return jax.jit(run)

    names = [
        (1, "trace_on_kf"),
        (2, "flag_insert"),
        (3, "activation"),
        (4, "ba"),
        (5, "finalize_refbuild"),
        (6, "select_seed"),
        (7, "marg_frames"),
    ]
    results = {}
    prev = 0.0
    for upto, name in names:
        fn = prefix(upto)
        out = fn(state_pre, aux)  # compile + warm
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(N_REPS):
            out = fn(state_pre, aux)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / N_REPS * 1e3
        results[f"prefix_{name}_ms"] = round(dt, 2)
        results[f"stage_{name}_ms"] = round(dt - prev, 2)
        prev = dt
        print(json.dumps({"progress": name, "cum_ms": round(dt, 2)}),
              flush=True)

    # track front half for context
    def tf():
        return frame_track(
            state_pre, jnp.asarray(lefts[capture_after]),
            jnp.asarray(rights[capture_after]), calib_c, baseline,
            jnp.float32(1.0), n_tries=5, **common,
        )

    out = tf()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(N_REPS):
        jax.block_until_ready(tf())
    results["frame_track_ms"] = round(
        (time.perf_counter() - t0) / N_REPS * 1e3, 2
    )
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
