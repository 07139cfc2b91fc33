"""The WHOLE per-frame SLAM step as ONE XLA program — including keyframes.

The round-1 pipeline kept the keyframe path host-driven: ~12-20 device
dispatches + 2-4 blocking fetches per keyframe (trace, flag, insert, gate,
activate, BA, finalize, reference rebuild, selection, seeding, per-slot
marginalization). Every dispatch and fetch serializes host and device.

This module moves the remaining host policies in-graph so a steady-state
frame — keyframe or not — is ONE dispatch plus ONE small scalar fetch:

  track (pyramids + cascade + in-graph retry ladder + speculative depth
  refinement)  ->  in-graph keyframe decision (FullSystem.cpp:1127-1152)
  ->  lax.cond:
        non-KF: keep the speculative refinement (makeNonKeyFrame)
        KF:     trace-on-KF, flagFramesForMarginalization policy
                (FullSystemMarginalize.cpp:59-145), window insertion,
                activation gate + 1-dof LM + insertion, windowed BA,
                final linearization/flag/marginalize-points, tracking
                reference rebuild, pixel selection + immature seeding,
                flagged-frame marginalization — all as traced code.

Everything is fixed-shape and the selector potential is a traced scalar, so
the program compiles exactly once. A leading sequence axis turns
the same program into the config-4 multi-sequence throughput path (vmap) —
see parallel/batched.py.

Host-side deviations from the reference, by design:
- Pixel-selector density recursion (PixelSelector2::makeMaps re-running
  select up to 3x within a frame) becomes one in-graph pass at the potential
  adapted from the PREVIOUS keyframe's yield (stale-by-one adaptation) plus
  the same in-graph random thinning. The host still adapts the potential
  between keyframes from the fetched yield.
- The >60%-saturation cutoff-repeat (legacy CoarseTracker.cpp:891-906,
  :1036-1041) runs in-graph inside the per-level LM (ops/tracker_ops.lm_level);
  the returned saturation fraction is at the final (possibly raised) cutoff.
- Initialization (first keyframes, mono/stereo bootstrap) stays on the
  host FullSystem; `GraphSystem.from_full_system` freezes a warmed system
  into graph state.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.backend import ba, builder, window as W
from stereo_dso_g2o_tpu.config import Settings, default_settings
from stereo_dso_g2o_tpu.frontend import frame_step as FS
from stereo_dso_g2o_tpu.frontend import immature as IMM
from stereo_dso_g2o_tpu.models.camera import Calib
from stereo_dso_g2o_tpu.ops import selector as SEL
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu.utils import se3


class GraphState(NamedTuple):
    """All device state of one running sequence (fixed shapes)."""

    win: W.Window
    imm: IMM.ImmatureSet
    ref: Tuple  # tracker reference: per-level (u, v, idepth, color, ok)
    ref_slot: jax.Array  # () int32 window slot of the tracking reference
    ref_aff: jax.Array  # (2,)
    ref_exposure: jax.Array  # ()
    dI0_slots: jax.Array  # (F, H, W, 3) level-0 pyramids of the window KFs
    last_rmse0: jax.Array  # () previous finest-level coarse RMSE
    first_rmse: jax.Array  # () first KF-pair RMSE (KF-decision gate)
    kf_out_count: jax.Array  # (F,) marginalized-point counters per slot
    min_act_dist: jax.Array  # () activation distance controller
    next_kf_id: jax.Array  # () int32
    salt: jax.Array  # () int32 selector randomization counter
    last_c2w: jax.Array  # (4, 4) camToWorld of the previous frame (frozen)
    prev_c2w: jax.Array  # (4, 4) camToWorld of the frame before that (frozen)
    last_aff: jax.Array  # (2,) previous frame's affine estimate
    # camToRef + reference identity of the two previous frames: lets the
    # motion model recompose their camToWorld with the CURRENT (post-BA)
    # window pose of the reference instead of the frozen composite above —
    # matching the host path, which reads BA-refreshed keyframe shells
    # (FullSystem.cpp:305-312 under shellPoseMutex)
    last_rel: jax.Array  # (4, 4) camToRef of the previous frame
    last_slot: jax.Array  # () its reference's window slot
    last_fid: jax.Array  # () its reference's frame id (slot-reuse guard)
    prev_rel: jax.Array  # (4, 4)
    prev_slot: jax.Array  # ()
    prev_fid: jax.Array  # ()


class FrameBundle(NamedTuple):
    """Small per-frame fetch: everything the host bookkeeping needs."""

    T: jax.Array  # (4, 4) refToNew at the PRE-KF tracking reference
    aff: jax.Array  # (2,)
    residuals: jax.Array  # (L,)
    flow: jax.Array  # (3,)
    ok: jax.Array  # ()
    sat_frac0: jax.Array  # ()
    need_kf: jax.Array  # ()
    slot: jax.Array  # () inserted window slot (-1 if non-KF)
    flagged: jax.Array  # (F,) frames marginalized this step
    w2c: jax.Array  # (F, 4, 4) post-step window poses
    aff_all: jax.Array  # (F, 2)
    frame_valid: jax.Array  # (F,)
    frame_id: jax.Array  # (F,) per-slot KF ids
    energy: jax.Array  # () BA energy (nan-able)
    nres: jax.Array  # ()
    sel_num: jax.Array  # () selector yield (for host pot adaptation)
    n_active: jax.Array  # ()
    # per-KF point-lifecycle stats (the reference's printLogLine counters,
    # FullSystem.cpp:1646-1687): activated, immature alive, marginalized,
    # dropped — zero on non-KF frames
    n_activated: jax.Array  # ()
    n_imm: jax.Array  # ()
    n_marg: jax.Array  # ()
    n_dropped: jax.Array  # ()
    # keyframe-decision inputs (FullSystem.cpp:1127-1152), for the per-frame
    # decision audit: the weighted flow/affine score (KF when > 1) and the
    # rmse-vs-firstCoarseRMSE pair (KF when 2*first < rmse)
    kf_delta: jax.Array  # ()
    kf_rmse: jax.Array  # () level-0 coarse RMSE of this frame
    kf_first_rmse: jax.Array  # () firstCoarseRMSE of the current ref


# ---------------------------------------------------------------------------
# in-graph policies
# ---------------------------------------------------------------------------


def kf_decision(track: FS.TrackOut, ref_aff, ref_exposure, new_exposure,
                first_rmse, wh: float, settings: Settings):
    """FullSystem::makeKeyFrame decision (FullSystem.cpp:1127-1152)."""
    s = settings
    a_rel = (
        jnp.exp(track.aff[0] - ref_aff[0])
        * new_exposure
        / jnp.maximum(ref_exposure, 1e-9)
    )
    delta = (
        s.kf_global_weight * s.max_shift_weight_t
        * jnp.sqrt(jnp.maximum(track.flow[0], 0.0)) / wh
        + s.kf_global_weight * s.max_shift_weight_r
        * jnp.sqrt(jnp.maximum(track.flow[1], 0.0)) / wh
        + s.kf_global_weight * s.max_shift_weight_rt
        * jnp.sqrt(jnp.maximum(track.flow[2], 0.0)) / wh
        + s.kf_global_weight * s.max_affine_weight
        * jnp.abs(jnp.log(jnp.maximum(a_rel, 1e-9)))
    )
    need = (delta > 1.0) | (2.0 * first_rmse < track.residuals[0])
    return need, delta


def flag_frames(win: W.Window, imm_valid, kf_out_count,
                settings: Settings):
    """flagFramesForMarginalization (FullSystemMarginalize.cpp:59-145),
    traced. Returns (F,) bool. Matches the host `_flag_frames` policy:
    candidates in frame-id order bounded by (n_kfs - min_frames), then the
    distance-score rule when the window would overflow."""
    s = settings
    F = win.F
    valid = win.frame_valid
    fid = jnp.where(valid, win.frame_id, jnp.iinfo(jnp.int32).max)
    n_kfs = jnp.sum(valid)

    active = win.pt_status == W.PT_ACTIVE
    n_in = (
        jnp.zeros((F,), jnp.int32)
        .at[win.pt_host]
        .add(active.astype(jnp.int32))
        + jnp.sum(imm_valid, axis=1)
    )
    n_out = kf_out_count

    # affine gap vs the newest window KF (frameHessians.back())
    back = jnp.argmax(jnp.where(valid, win.frame_id, -1))
    aff_all = win.aff_g2l()
    exps = win.ab_exposure
    a_rel = (
        jnp.exp(aff_all[:, 0] - aff_all[back, 0])
        * exps
        / jnp.maximum(exps[back], 1e-9)
    )
    drop = (
        n_in < s.min_points_remaining * (n_in + n_out)
    ) | (jnp.abs(jnp.log(jnp.maximum(a_rel, 1e-12))) > s.max_log_aff_fac_in_window)
    candidate = valid & drop

    # greedy in frame-id order, at most max(n_kfs - min_frames, 0) flags
    order = jnp.argsort(fid)
    cand_sorted = candidate[order]
    rank = jnp.cumsum(cand_sorted.astype(jnp.int32)) - 1  # rank among cands
    allow = cand_sorted & (rank < jnp.maximum(n_kfs - s.min_frames, 0))
    flagged = jnp.zeros((F,), bool).at[order].set(allow)
    n_flagged = jnp.sum(flagged)

    # distance-score rule when the window is (over)full; +1 for the incoming
    need_dist = (n_kfs + 1 - n_flagged) >= (s.max_frames + 1)
    w2c = win.w2c()
    latest = back
    latest_id = win.frame_id[latest]
    rel = jnp.einsum("tij,sjk->stik", w2c, jnp.linalg.inv(w2c))  # [s,t]
    d = jnp.linalg.norm(rel[..., :3, 3], axis=-1)  # (F_s, F_t)
    t_ok = valid & ~(win.frame_id > latest_id - s.min_frame_age + 1)
    contrib = jnp.where(
        t_ok[None, :] & ~jnp.eye(F, dtype=bool), 1.0 / (1e-5 + d), 0.0
    )
    score = -jnp.sqrt(jnp.maximum(d[:, latest], 1e-12)) * jnp.sum(contrib, 1)
    s_ok = valid & (win.frame_id <= latest_id - s.min_frame_age) & (
        win.frame_id != 0
    )
    score = jnp.where(s_ok, score, jnp.inf)
    best_slot = jnp.argmin(score)
    flag_dist = need_dist & jnp.isfinite(score[best_slot])
    flagged = flagged | (
        (jnp.arange(F) == best_slot) & flag_dist
    )
    return flagged


def _free_slot(win: W.Window):
    return jnp.argmin(win.frame_valid.astype(jnp.int32)).astype(jnp.int32)


def _rigid_inv(T):
    """SE(3) inverse without a linear solve."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    return Ti.at[:3, 3].set(-R.T @ t)


def motion_tries(last_c2w, prev_c2w, ref_c2w, dtype=jnp.float32):
    """The 5 pose hypotheses lastF->fh, traced (FullSystem.cpp:349-377):
    constant motion, double, half, last-frame pose, zero-from-KF."""
    slast_2_sprelast = _rigid_inv(prev_c2w) @ last_c2w
    lastF_2_slast = _rigid_inv(last_c2w) @ ref_c2w
    fh_2_slast = slast_2_sprelast  # constant velocity
    fh_inv = _rigid_inv(fh_2_slast)
    half = se3.se3_exp(0.5 * se3.se3_log(fh_2_slast))
    tries = jnp.stack(
        [
            fh_inv @ lastF_2_slast,
            fh_inv @ fh_inv @ lastF_2_slast,
            _rigid_inv(half) @ lastF_2_slast,
            lastF_2_slast,
            jnp.eye(4, dtype=dtype),
        ]
    ).astype(dtype)
    # non-finite guards (uninitialized history): fall back to identity
    ok = jnp.isfinite(tries).all(axis=(1, 2), keepdims=True)
    return jnp.where(ok, tries, jnp.eye(4, dtype=dtype))


def _update_min_act_dist(min_act_dist, n_active, density):
    """The activation distance controller (FullSystem.cpp:808-824)."""
    d = density
    n = n_active.astype(jnp.float32)
    delta = jnp.where(n < d * 0.66, -0.8, 0.0)
    delta = delta + jnp.where(n < d * 0.8, -0.5, jnp.where(n < d * 0.9, -0.2,
                              jnp.where(n < d, -0.1, 0.0)))
    delta = delta + jnp.where(n > d * 1.5, 0.8, 0.0)
    delta = delta + jnp.where(n > d * 1.3, 0.5, jnp.where(n > d * 1.15, 0.2,
                              jnp.where(n > d, 0.1, 0.0)))
    return jnp.clip(min_act_dist + delta, 0.0, 4.0)


# ---------------------------------------------------------------------------
# the fused frame program
# ---------------------------------------------------------------------------


def _levels(calib: Calib):
    return calib.n_levels


def _track_common(
    state: GraphState, left, right, calib_c, baseline, new_exposure,
    settings: Settings, n_levels: int, n_tries: int, w0: int, h0: int,
):
    """Shared front half of every frame: pyramids + cascade + in-graph retry
    ladder + speculative non-KF refinement + the keyframe decision."""
    s = settings
    w2c_pre0 = state.win.w2c()
    ref_c2w = _rigid_inv(w2c_pre0[state.ref_slot])

    def fresh_c2w(comp, rel, slot, fid):
        ok = state.win.frame_valid[slot] & (state.win.frame_id[slot] == fid)
        fresh = _rigid_inv(w2c_pre0[slot]) @ rel
        return jnp.where(ok, fresh, comp)

    last_c2w = fresh_c2w(
        state.last_c2w, state.last_rel, state.last_slot, state.last_fid
    )
    prev_c2w = fresh_c2w(
        state.prev_c2w, state.prev_rel, state.prev_slot, state.prev_fid
    )
    T_tries = motion_tries(last_c2w, prev_c2w, ref_c2w)[:n_tries]
    aff_init = state.last_aff

    last_rmse = jnp.where(
        jnp.isfinite(state.last_rmse0), state.last_rmse0, 1e30
    )
    (dIpL, dIpR), imm_spec, track, _ = FS.frame_step_full(
        left, right, state.ref, state.win, state.imm, calib_c, baseline,
        state.ref_slot, T_tries, aff_init, state.ref_aff,
        state.ref_exposure, new_exposure, last_rmse,
        settings=s, n_levels=n_levels, n_tries=n_tries,
    )
    # track failure: take the predicted pose and hope (FullSystem.cpp:503-508)
    ok_eff = track.ok & jnp.isfinite(track.residuals[0]) & (
        track.sat_frac0 <= 0.6
    )
    # projected onto SE(3): the motion model chains T_best through rigid
    # inverses from frame to frame (se3.orthonormalize)
    T_best = se3.orthonormalize(jnp.where(ok_eff, track.T, T_tries[0]))
    aff_best = jnp.where(ok_eff, track.aff, aff_init)
    flow = jnp.where(ok_eff, track.flow, jnp.zeros(3, track.flow.dtype))
    rmse0 = track.residuals[0]
    new_last = jnp.where(
        ok_eff & jnp.isfinite(rmse0), rmse0, state.last_rmse0
    )
    new_first = jnp.where(
        state.first_rmse < 0, jnp.where(ok_eff, rmse0, state.first_rmse),
        state.first_rmse,
    )

    track_eff = track._replace(T=T_best, aff=aff_best, flow=flow)
    need_kf, kf_delta = kf_decision(
        track_eff, state.ref_aff, state.ref_exposure, new_exposure,
        new_first, float(w0 + h0), s,
    )
    kf_inputs = jnp.stack([kf_delta, rmse0, new_first])
    return (
        (dIpL, dIpR), imm_spec, track, T_best, aff_best, flow, ok_eff,
        new_last, new_first, need_kf, kf_inputs,
    )


def _nonkf_branch(state: GraphState, imm_spec, track, T_best, aff_best,
                  flow, ok_eff, new_last, new_first, need_kf, kf_inputs):
    F = state.win.F
    w2c_pre0 = state.win.w2c()
    st = state._replace(
        imm=imm_spec, last_rmse0=new_last, first_rmse=new_first,
        last_c2w=_rigid_inv(T_best @ w2c_pre0[state.ref_slot]),
        prev_c2w=state.last_c2w,
        last_aff=aff_best,
        last_rel=_rigid_inv(T_best),
        last_slot=state.ref_slot,
        last_fid=state.win.frame_id[state.ref_slot],
        prev_rel=state.last_rel,
        prev_slot=state.last_slot,
        prev_fid=state.last_fid,
    )
    bundle = FrameBundle(
        T=T_best, aff=aff_best, residuals=track.residuals, flow=flow,
        ok=ok_eff, sat_frac0=track.sat_frac0, need_kf=need_kf,
        slot=jnp.asarray(-1, jnp.int32),
        flagged=jnp.zeros((F,), bool),
        w2c=state.win.w2c(), aff_all=state.win.aff_g2l(),
        frame_valid=state.win.frame_valid, frame_id=state.win.frame_id,
        energy=jnp.asarray(jnp.nan, jnp.float32),
        nres=jnp.asarray(0, jnp.int32),
        sel_num=jnp.asarray(0, jnp.int32),
        n_active=jnp.sum(state.win.pt_status == W.PT_ACTIVE).astype(
            jnp.int32
        ),
        n_activated=jnp.asarray(0, jnp.int32),
        n_imm=jnp.sum(imm_spec.valid).astype(jnp.int32),
        n_marg=jnp.asarray(0, jnp.int32),
        n_dropped=jnp.asarray(0, jnp.int32),
        kf_delta=kf_inputs[0],
        kf_rmse=kf_inputs[1],
        kf_first_rmse=kf_inputs[2],
    )
    return st, bundle


def _kf_branch(
    state: GraphState, dIpL, dIpR0, track, T_best, aff_best, flow, ok_eff,
    new_last, new_first, need_kf, kf_inputs, calib_c, baseline, new_exposure,
    settings: Settings, n_levels: int, pot: int, caps: Tuple[int, ...],
    w0: int, h0: int, imm_cap: int,
):
    """The whole keyframe pipeline (makeKeyFrame) as traced code, from the
    PRE-frame state + the tracking result."""
    s = settings
    F = state.win.F
    calib = Calib(
        c=calib_c,
        baseline=baseline,
        w=tuple(w0 >> l for l in range(n_levels)),
        h=tuple(h0 >> l for l in range(n_levels)),
    )
    win = state.win
    imm = state.imm
    w2c_pre = win.w2c()
    T_new_w2c = T_best @ w2c_pre[state.ref_slot]
    if True:  # keep the original body's indentation

        # STEP 1: trace all immature points onto the incoming KF
        imm = FS.kf_trace_step(
            win, imm, dIpL[0], calib_c, baseline, T_new_w2c, aff_best,
            new_exposure, settings=s, n_levels=n_levels,
        )

        # STEP 2: flagging policy (pre-insertion window)
        flagged = flag_frames(win, imm.valid, state.kf_out_count, s)

        # STEP 3: insert the KF
        slot = _free_slot(win)
        kf_id = state.next_kf_id
        win = builder.insert_frame(
            win, slot, T_new_w2c,
            (aff_best[0], aff_best[1]), new_exposure, kf_id,
        )
        zero = jnp.zeros((), slot.dtype)
        dI0 = jax.lax.dynamic_update_slice(
            state.dI0_slots, dIpL[0][None], (slot, zero, zero, zero)
        )

        # STEP 4: residuals from active points to the new KF
        active_pts = win.pt_status == W.PT_ACTIVE
        tgt = jnp.arange(F) == slot
        win = win.replace(
            res_exists=jnp.where(tgt[None, :], active_pts[:, None],
                                 win.res_exists),
            res_state=jnp.where(tgt[None, :], W.RES_IN, win.res_state),
            res_linearized=jnp.where(tgt[None, :], False,
                                     win.res_linearized),
        )

        # STEP 5: activation (distance controller + gate + LM + insertion)
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

        # STEP 6: windowed BA (steady-state window: standard iteration cap)
        win, energy, nres = ba.optimize_fused(
            win, dI0, settings=s, max_its=s.max_opt_iterations
        )

        # STEPS 7-8: final linearization, outlier removal, tracking-ref
        # inputs, point flagging + marginalization
        win, ref_inputs, gone, w2c_post, aff_all, _, (n_marg, n_drop) = \
            FS.kf_finalize(
            win, dI0, dIpL[0], dIpR0, slot, flagged,
            state.ref_slot, calib_c, baseline,
            settings=s, n_levels=n_levels,
        )
        kf_out = state.kf_out_count + jnp.zeros((F,), jnp.int32).at[
            win.pt_host
        ].add(gone.astype(jnp.int32))

        # tracking reference rebuild (makeCoarseDepthL0 STEP2-5)
        us_r, vs_r, id_r, wt_r, sel_r = ref_inputs
        id_maps, valid_maps, color_maps = tracker_build_ref(
            us_r, vs_r, id_r, wt_r, sel_r, dIpL, n_levels
        )
        new_ref = tuple(
            SEL_compact(id_maps[l], valid_maps[l], color_maps[l], caps[l])
            for l in range(n_levels)
        )

        # STEP 9: seed new immature points (pixel selection in-graph at the
        # host-adapted potential, with the reference's random thinning)
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

        # STEP 10: marginalize flagged frames
        win = ba.marginalize_frames_masked(win, flagged, settings=s)
        imm = imm.replace(valid=imm.valid & ~flagged[:, None])

        st = GraphState(
            win=win,
            imm=imm,
            ref=new_ref,
            ref_slot=slot,
            ref_aff=aff_all[slot],
            ref_exposure=new_exposure,
            dI0_slots=dI0,
            last_rmse0=new_last,
            # firstCoarseRMSE is per tracking reference: reset on every new
            # KF (CoarseTracker.cpp:803,823 via setCoarseTrackingRef); the
            # next frame's RMSE against the new reference becomes "first".
            # A stale value makes `2*first < rmse` fire on every frame,
            # collapsing the KF cadence (and immature-point lifetimes).
            first_rmse=jnp.asarray(-1.0, jnp.float32),
            kf_out_count=kf_out,
            min_act_dist=mad,
            next_kf_id=(kf_id + 1).astype(state.next_kf_id.dtype),
            salt=(state.salt + 1).astype(state.salt.dtype),
            last_c2w=_rigid_inv(w2c_post[slot]),
            prev_c2w=state.last_c2w,
            last_aff=aff_all[slot].astype(state.last_aff.dtype),
            last_rel=jnp.eye(4, dtype=state.last_rel.dtype),
            last_slot=slot.astype(state.last_slot.dtype),
            last_fid=kf_id.astype(state.last_fid.dtype),
            prev_rel=state.last_rel,
            prev_slot=state.last_slot,
            prev_fid=state.last_fid,
        )
        bundle = FrameBundle(
            T=T_best, aff=aff_best, residuals=track.residuals, flow=flow,
            ok=ok_eff, sat_frac0=track.sat_frac0, need_kf=need_kf,
            slot=slot.astype(jnp.int32),
            flagged=flagged,
            w2c=win.w2c(), aff_all=win.aff_g2l(),
            frame_valid=win.frame_valid, frame_id=win.frame_id,
            energy=energy.astype(jnp.float32), nres=nres.astype(jnp.int32),
            sel_num=num_have.astype(jnp.int32),
            n_active=n_active,
            n_activated=n_activated.astype(jnp.int32),
            n_imm=jnp.sum(imm.valid).astype(jnp.int32),
            n_marg=n_marg,
            n_dropped=n_drop,
            kf_delta=kf_inputs[0],
            kf_rmse=kf_inputs[1],
            kf_first_rmse=kf_inputs[2],
        )
        return st, bundle


@functools.partial(
    jax.jit,
    static_argnames=("settings", "n_levels", "n_tries", "caps",
                     "w0", "h0", "imm_cap"),
)
def frame_auto(
    state: GraphState,
    left,  # (H, W) raw
    right,
    calib_c,
    baseline,
    new_exposure,  # ()
    settings: Settings = default_settings(),
    n_levels: int = 6,
    n_tries: int = 5,
    pot: int = 3,
    caps: Tuple[int, ...] = (),
    w0: int = 0,
    h0: int = 0,
    imm_cap: int = 2048,
):
    """One full frame — track + (cond) the whole keyframe pipeline, ONE
    program. With a scalar predicate lax.cond executes only the taken branch,
    so a non-keyframe never pays the keyframe pipeline's compute.

    Pose hypotheses (constant-velocity motion model, FullSystem.cpp:349-377)
    and the affine init come from GraphState, so the host never has to fetch
    the previous frame's result before dispatching the next: results drain
    asynchronously a few frames behind while the device pipeline runs ahead."""
    (dIpL, dIpR), imm_spec, track, T_best, aff_best, flow, ok_eff, \
        new_last, new_first, need_kf, kf_inputs = _track_common(
            state, left, right, calib_c, baseline, new_exposure,
            settings, n_levels, n_tries, w0, h0,
        )

    def non_kf(_):
        return _nonkf_branch(
            state, imm_spec, track, T_best, aff_best, flow, ok_eff,
            new_last, new_first, need_kf, kf_inputs,
        )

    def kf(_):
        return _kf_branch(
            state, dIpL, dIpR[0], track, T_best, aff_best, flow, ok_eff,
            new_last, new_first, need_kf, kf_inputs, calib_c, baseline,
            new_exposure, settings, n_levels, pot, caps, w0, h0, imm_cap,
        )

    return jax.lax.cond(need_kf, kf, non_kf, None)


class TrackAux(NamedTuple):
    """Everything the gated keyframe program needs beyond the pre-state."""

    dIpL: Tuple  # full left pyramid (n_levels arrays)
    dIpR0: jax.Array  # right level-0 pyramid
    track: FS.TrackOut
    T_best: jax.Array
    aff_best: jax.Array
    flow: jax.Array
    ok_eff: jax.Array
    new_last: jax.Array
    new_first: jax.Array
    need_kf: jax.Array
    kf_inputs: jax.Array  # (3,) decision-audit inputs (delta, rmse, first)


@functools.partial(
    jax.jit,
    static_argnames=("settings", "n_levels", "n_tries", "w0", "h0"),
)
def frame_track(
    state: GraphState,
    left,
    right,
    calib_c,
    baseline,
    new_exposure,
    settings: Settings = default_settings(),
    n_levels: int = 6,
    n_tries: int = 5,
    w0: int = 0,
    h0: int = 0,
):
    """Track-only half for the GATED batched path: always applies the
    speculative non-KF update and returns the aux needed to (re)run the
    keyframe pipeline from the pre-state when need_kf comes back true.

    Rationale: under vmap a batched-predicate lax.cond lowers to select —
    both branches execute for every sequence, so the fused `frame_auto`
    pays the whole keyframe pipeline on every batched frame. Splitting lets
    the host dispatch `frame_kf` only for the sequences that need it
    (reference analog: makeKeyFrame vs makeNonKeyFrame dispatch,
    FullSystem.cpp:1168-1221)."""
    (dIpL, dIpR), imm_spec, track, T_best, aff_best, flow, ok_eff, \
        new_last, new_first, need_kf, kf_inputs = _track_common(
            state, left, right, calib_c, baseline, new_exposure,
            settings, n_levels, n_tries, w0, h0,
        )
    st, bundle = _nonkf_branch(
        state, imm_spec, track, T_best, aff_best, flow, ok_eff,
        new_last, new_first, need_kf, kf_inputs,
    )
    aux = TrackAux(
        dIpL=dIpL, dIpR0=dIpR[0], track=track, T_best=T_best,
        aff_best=aff_best, flow=flow, ok_eff=ok_eff, new_last=new_last,
        new_first=new_first, need_kf=need_kf, kf_inputs=kf_inputs,
    )
    return st, bundle, aux


@functools.partial(
    jax.jit,
    static_argnames=("settings", "n_levels", "caps", "w0", "h0",
                     "imm_cap"),
)
def frame_kf(
    state_pre: GraphState,
    aux: TrackAux,
    calib_c,
    baseline,
    new_exposure,
    settings: Settings = default_settings(),
    n_levels: int = 6,
    pot: int = 3,
    caps: Tuple[int, ...] = (),
    w0: int = 0,
    h0: int = 0,
    imm_cap: int = 2048,
):
    """The keyframe pipeline from the PRE-frame state + frame_track's aux —
    numerically identical to frame_auto's kf branch."""
    return _kf_branch(
        state_pre, aux.dIpL, aux.dIpR0, aux.track, aux.T_best, aux.aff_best,
        aux.flow, aux.ok_eff, aux.new_last, aux.new_first, aux.need_kf,
        aux.kf_inputs, calib_c, baseline, new_exposure, settings, n_levels,
        pot, caps, w0, h0, imm_cap,
    )


def tracker_build_ref(us, vs, idepths, weights, valid, dI_ref, n_levels):
    from stereo_dso_g2o_tpu.ops import tracker_ops

    return tracker_ops.build_ref_maps(
        us, vs, idepths, weights, valid, n_levels=n_levels, dI_ref=dI_ref
    )


def SEL_compact(id_map, valid_map, color_map, cap):
    from stereo_dso_g2o_tpu.ops import tracker_ops

    return tracker_ops.compact_ref_level(id_map, valid_map, color_map, cap)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


class GraphShell:
    __slots__ = ("id", "timestamp", "T_cam_to_ref", "ref_kf_id", "aff",
                 "is_kf", "T_cw")

    def __init__(self, fid, ts, T_cam_to_ref, ref_kf_id, aff):
        self.id = fid
        self.timestamp = ts
        self.T_cam_to_ref = T_cam_to_ref
        self.ref_kf_id = ref_kf_id
        self.aff = aff
        self.is_kf = False
        self.T_cw = None


class GraphSystem:
    """Steady-state odometry on the fused frame program.

    Bootstrap through the host FullSystem (initialization + first keyframes),
    then `GraphSystem.from_full_system(fs)` continues with one dispatch + one
    small fetch per frame. Host state is bookkeeping only: trajectory shells,
    keyframe shells, selector-potential adaptation."""

    def __init__(self, calib: Calib, settings: Settings, state: GraphState,
                 history, kf_shells, slot_frame_id, pot: int = 3):
        from stereo_dso_g2o_tpu.frontend.coarse_tracker import level_caps

        self.calib = calib
        self.settings = settings
        self.state = state
        self.history: List[GraphShell] = history
        self.kf_shells = kf_shells
        self.slot_frame_id = dict(slot_frame_id)
        self.pot = pot
        self.caps = tuple(level_caps(calib))
        self.is_lost = False
        self.init_failed = False  # initialization is always host-side; kept
        # for interface parity with FullSystem (CLI reset logic)
        self._pending_q = []  # [(FrameBundle (device), frame_id, ts), ...]

    # -- construction ------------------------------------------------------
    @classmethod
    def from_full_system(cls, fs) -> "GraphSystem":
        F = fs.win.F
        H, Wd = fs.calib.h[0], fs.calib.w[0]
        zeros_im = jnp.zeros((H, Wd, 3), jnp.float32)
        dI0 = jnp.stack(
            [
                fs.dI_slots[s_][0] if fs.dI_slots[s_] is not None else zeros_im
                for s_ in range(F)
            ]
        )

        def shell_rel(sh):
            """(camToRef, ref window slot, ref frame id) for the motion
            model's at-use recomposition; (-1 fid) disables it when the
            reference already left the window."""
            kf_id_of_slot = fs.slot_frame_id  # {slot: kf_id}
            if sh.is_kf:
                # the shell IS a keyframe: find its own slot
                for s_, kid in kf_id_of_slot.items():
                    if kid == fs.kf_shells.index(sh):
                        return np.eye(4), s_, kid
                # fall through if already marginalized
            if sh.ref_kf_id >= 0:
                for s_, kid in kf_id_of_slot.items():
                    if kid == sh.ref_kf_id:
                        return np.asarray(sh.T_cam_to_ref), s_, kid
            return np.eye(4), 0, -1  # fallback: frozen composite only

        rel_l, slot_l, fid_l = shell_rel(fs.history[-1])
        rel_p, slot_p, fid_p = shell_rel(fs.history[-2])
        state = GraphState(
            win=fs.win,
            imm=fs.imm,
            ref=tuple(fs.tracker.ref),
            ref_slot=jnp.asarray(fs.kf_slots[-1], jnp.int32),
            ref_aff=jnp.asarray(fs.tracker.ref_aff, jnp.float32),
            ref_exposure=jnp.asarray(fs.tracker.ref_exposure, jnp.float32),
            dI0_slots=dI0,
            last_rmse0=jnp.asarray(
                fs.last_coarse_rmse[0]
                if np.isfinite(fs.last_coarse_rmse[0]) else 1e30,
                jnp.float32,
            ),
            first_rmse=jnp.asarray(
                fs.tracker.first_coarse_rmse, jnp.float32
            ),
            kf_out_count=jnp.asarray(fs.kf_out_count, jnp.int32),
            min_act_dist=jnp.asarray(fs.current_min_act_dist, jnp.float32),
            next_kf_id=jnp.asarray(fs.next_kf_id, jnp.int32),
            salt=jnp.asarray(1000 * (1 + len(fs.kf_shells)), jnp.int32),
            last_c2w=jnp.asarray(
                fs._shell_T_cw(fs.history[-1]), jnp.float32
            ),
            prev_c2w=jnp.asarray(
                fs._shell_T_cw(fs.history[-2]), jnp.float32
            ),
            last_aff=jnp.asarray(fs.history[-1].aff, jnp.float32),
            last_rel=jnp.asarray(rel_l, jnp.float32),
            last_slot=jnp.asarray(slot_l, jnp.int32),
            last_fid=jnp.asarray(fid_l, jnp.int32),
            prev_rel=jnp.asarray(rel_p, jnp.float32),
            prev_slot=jnp.asarray(slot_p, jnp.int32),
            prev_fid=jnp.asarray(fid_p, jnp.int32),
        )
        history = [
            GraphShell(sh.id, sh.timestamp, sh.T_cam_to_ref, sh.ref_kf_id,
                       sh.aff)
            for sh in fs.history
        ]
        for g, sh in zip(history, fs.history):
            g.is_kf = sh.is_kf
            g.T_cw = sh.T_cw
        gs = cls(
            fs.calib, fs.settings, state, history, list(fs.kf_shells),
            fs.slot_frame_id, pot=fs.selector.current_potential,
        )
        return gs

    # -- stepping ----------------------------------------------------------
    #
    # Pose hypotheses and the affine init live in GraphState (motion model in-
    # graph), so dispatching frame i+1 never waits on frame i's result: the
    # small FrameBundle fetch drains `fetch_lag` frames behind the dispatch
    # front and the device pipeline runs ahead, hiding dispatch latency
    # entirely in steady state.
    fetch_lag = 2

    def add_frame(self, left, right, frame_id: int, timestamp: float = 0.0,
                  exposure: float = 1.0):
        s = self.settings
        state, bundle = frame_auto(
            self.state,
            jnp.asarray(left), jnp.asarray(right),
            self.calib.c, self.calib.baseline,
            jnp.float32(exposure),
            settings=s, n_levels=self.calib.n_levels, n_tries=5,
            pot=self.pot, caps=self.caps,
            w0=self.calib.w[0], h0=self.calib.h[0],
            imm_cap=s.immature_cap,
        )
        self.state = state
        self._pending_q.append((bundle, frame_id, timestamp))
        drained = None
        while len(self._pending_q) > self.fetch_lag:
            drained = self._drain_one()
        return drained

    def _drain_one(self):
        bundle, frame_id, timestamp = self._pending_q.pop(0)
        b = jax.device_get(bundle)
        ref_kf_id = len(self.kf_shells) - 1
        self.apply_bundle(b, frame_id, timestamp, ref_kf_id)
        return b

    def flush(self):
        """Drain all pending frame results into the host bookkeeping;
        returns the drained bundles, oldest first."""
        return [self._drain_one() for _ in range(len(self._pending_q))]

    def apply_bundle(self, b, frame_id: int, timestamp: float,
                     ref_kf_id: int):
        """Host bookkeeping from a fetched FrameBundle (shared with the
        batched multi-sequence runner)."""
        s = self.settings
        shell = GraphShell(
            frame_id, timestamp, np.linalg.inv(np.asarray(b.T, np.float64)),
            ref_kf_id, np.asarray(b.aff, np.float64),
        )
        self.history.append(shell)

        if bool(b.need_kf):
            slot = int(b.slot)
            kf_id = len(self.kf_shells)
            shell.is_kf = True
            self.slot_frame_id = {
                int(s_): int(f_)
                for s_, f_ in enumerate(np.asarray(b.frame_id))
                if bool(np.asarray(b.frame_valid)[s_])
            }
            self.kf_shells.append(shell)
            # refresh all in-window KF poses from the BA result
            w2c = np.asarray(b.w2c, np.float64)
            aff_all = np.asarray(b.aff_all, np.float64)
            for s_, f_ in self.slot_frame_id.items():
                self.kf_shells[f_].T_cw = np.linalg.inv(w2c[s_])
                self.kf_shells[f_].aff = aff_all[s_]
            # selector potential adaptation (stale-by-one, PixelSelector2)
            num_have = float(b.sel_num)
            quotia = s.desired_immature_density / max(num_have, 1.0)
            K = num_have * (self.pot + 1) ** 2
            ideal = max(
                int(np.sqrt(K / s.desired_immature_density) - 1), 1
            )
            if quotia > 1.25 and self.pot > 1:
                self.pot = SEL.snap_pot(max(min(ideal, self.pot - 1), 1))
            elif quotia < 0.25:
                self.pot = SEL.snap_pot(max(ideal, self.pot + 1))
            else:
                self.pot = SEL.snap_pot(max(ideal, 1))
        if bool(b.need_kf) and (
            not np.isfinite(float(b.energy)) or int(b.nres) == 0
        ):
            # non-finite BA energy, or a window with zero surviving
            # residuals: the map is dead — surface it like tracking loss
            # (FullSystem::isLost; the CLI performs the full reset)
            self.is_lost = True
        return b

    # -- host helpers --------------------------------------------------
    def slot_frame_id_of_ref(self):
        # the tracking reference is always the newest keyframe
        return len(self.kf_shells) - 1

    def _shell_T_cw(self, shell: GraphShell):
        if shell.is_kf and shell.T_cw is not None:
            return shell.T_cw
        if shell.ref_kf_id < 0:
            return shell.T_cam_to_ref
        return self.kf_shells[shell.ref_kf_id].T_cw @ shell.T_cam_to_ref

    def trajectory(self):
        self.flush()
        return [self._shell_T_cw(sh) for sh in self.history]

    def point_cloud(self):
        """Window point cloud for the viewer feed (same data FullSystem
        publishes; KeyFrameDisplay.cpp:102-173)."""
        from stereo_dso_g2o_tpu.frontend.full_system import window_point_cloud

        self.flush()
        return window_point_cloud(self.state.win, self.calib,
                                  self.slot_frame_id)
