"""Immature point management: creation, tracing across frames, activation.

JAX rebuild of the ImmaturePoint lifecycle (FullSystem::makeNewTraces
:1600-1629, traceNewCoarseKey :745-781, traceNewCoarseNonKey :632-744,
activatePointsMT :796-961 + optimizeImmaturePoint FullSystemOptPoint.cpp:52-240).

Immature points live in a fixed-capacity [F, CAP] structure-of-arrays per
keyframe slot. Tracing every keyframe's candidates onto a new frame is one
vmapped trace-kernel call over the host axis; activation is a batched 1-dof
inverse-depth LM over (candidates x target keyframes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.config import PATTERN, Settings, default_settings
from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.ops import trace as trace_ops
from stereo_dso_g2o_tpu.ops.interp import bilinear
from stereo_dso_g2o_tpu.utils.pytree import dataclass


@dataclass
class ImmatureSet:
    """[F, CAP] per-keyframe immature point arrays."""

    valid: jax.Array  # (F, C) bool
    u: jax.Array  # (F, C)
    v: jax.Array  # (F, C)
    idepth_min: jax.Array  # (F, C)
    idepth_max: jax.Array  # (F, C)
    color: jax.Array  # (F, C, 8)
    weights: jax.Array  # (F, C, 8)
    gradH: jax.Array  # (F, C, 2, 2)
    energy_th: jax.Array  # (F, C)
    quality: jax.Array  # (F, C)
    status: jax.Array  # (F, C) int32 (IPS_*)
    my_type: jax.Array  # (F, C) int32 (selector level 1/2/4)
    pixel_interval: jax.Array  # (F, C)
    last_uv: jax.Array  # (F, C, 2)


def empty(F: int, cap: int) -> ImmatureSet:
    # explicit float32 everywhere: under jax_enable_x64 (the test config)
    # dtype-free constructors would create weak/strong float64 leaves, which
    # changes which jit executable runs after a checkpoint round-trip
    def z(*shape):
        return jnp.zeros(shape, jnp.float32)

    return ImmatureSet(
        valid=jnp.zeros((F, cap), bool),
        u=z(F, cap),
        v=z(F, cap),
        idepth_min=z(F, cap),
        idepth_max=jnp.full((F, cap), jnp.nan, jnp.float32),
        color=z(F, cap, 8),
        weights=z(F, cap, 8),
        gradH=z(F, cap, 2, 2),
        energy_th=z(F, cap),
        quality=jnp.full((F, cap), 10000.0, jnp.float32),
        status=jnp.full((F, cap), trace_ops.IPS_UNINITIALIZED, jnp.int32),
        my_type=jnp.ones((F, cap), jnp.int32),
        pixel_interval=z(F, cap),
        last_uv=z(F, cap, 2),
    )


@functools.partial(jax.jit, static_argnames=("settings",))
def seed_slot(
    imm: ImmatureSet,
    slot,
    dI_host,
    us,
    vs,
    types,
    valid,
    settings: Settings = default_settings(),
) -> ImmatureSet:
    """makeNewTraces for one keyframe slot: fill its row with freshly selected
    pixels (idepth interval [0, inf), status UNINITIALIZED)."""
    cap = imm.u.shape[1]
    n = us.shape[0]
    assert n == cap, (n, cap)
    color, weights, gradH, eth = trace_ops.extract_point_data(
        dI_host, us, vs, settings
    )
    finite = jnp.all(jnp.isfinite(color), axis=-1)
    ok = valid & finite
    return imm.replace(
        valid=imm.valid.at[slot].set(ok),
        u=imm.u.at[slot].set(us),
        v=imm.v.at[slot].set(vs),
        idepth_min=imm.idepth_min.at[slot].set(0.0),
        idepth_max=imm.idepth_max.at[slot].set(jnp.nan),
        color=imm.color.at[slot].set(color),
        weights=imm.weights.at[slot].set(weights),
        gradH=imm.gradH.at[slot].set(gradH),
        energy_th=imm.energy_th.at[slot].set(eth),
        quality=imm.quality.at[slot].set(10000.0),
        status=imm.status.at[slot].set(trace_ops.IPS_UNINITIALIZED),
        my_type=imm.my_type.at[slot].set(types),
        pixel_interval=imm.pixel_interval.at[slot].set(0.0),
        last_uv=imm.last_uv.at[slot].set(0.0),
    )


def clear_slot(imm: ImmatureSet, slot) -> ImmatureSet:
    return imm.replace(valid=imm.valid.at[slot].set(False))


@functools.partial(jax.jit, static_argnames=("settings",))
def trace_on_frame(
    imm: ImmatureSet,
    KRKi,  # (F, 3, 3) host -> new-frame for every host slot
    Kt,  # (F, 3)
    aff,  # (F, 2) host -> new-frame photometric transfer
    dI_new,  # (H, W, 3)
    host_valid,  # (F,) bool
    settings: Settings = default_settings(),
) -> ImmatureSet:
    """traceNewCoarseKey: epipolar-trace every keyframe's immature points onto
    a new frame (FullSystem.cpp:745-781), all hosts' points in ONE flattened
    trace_batch call (per-point host transforms)."""
    flat, sel = _compact_live(imm, host_valid, settings)
    traced = trace_ops.trace_batch(
        flat["u"],
        flat["v"],
        flat["idepth_min"],
        flat["idepth_max"],
        flat["color"],
        flat["weights"],
        flat["gradH"],
        flat["energy_th"],
        flat["quality"],
        flat["status"],
        KRKi[flat["host"]],
        Kt[flat["host"]],
        aff[flat["host"]],
        dI_new,
        settings=settings,
    )
    return _scatter_trace(imm, sel, traced)


def _compact_live(imm: ImmatureSet, host_valid, settings: Settings):
    """Gather live immature rows into a fixed (trace_cap,) pool.

    The (F, C) capacity is sized for worst-case seeding; typically <25% of
    rows are alive, so the per-frame traces run ~4x less work on the compact
    pool. Returns (fields dict incl. `host`, scatter index array (NC,) with
    -1 for unused lanes). Exact whenever live rows <= trace_cap (overflow
    rows keep their interval until a later frame)."""
    F, C = imm.u.shape
    NFULL = F * C
    NC = min(NFULL, settings.trace_cap)
    live = (imm.valid & host_valid[:, None]).reshape(-1)
    idx = jnp.nonzero(live, size=NC, fill_value=-1)[0]
    sel_ok = idx >= 0
    safe = jnp.maximum(idx, 0)

    def g(x):
        return x.reshape((NFULL,) + x.shape[2:])[safe]

    fields = dict(
        u=g(imm.u),
        v=g(imm.v),
        idepth_min=g(imm.idepth_min),
        idepth_max=g(imm.idepth_max),
        color=g(imm.color),
        weights=g(imm.weights),
        gradH=g(imm.gradH),
        energy_th=g(imm.energy_th),
        quality=g(imm.quality),
        # unused lanes run frozen (OOB never re-traces: trace_batch no-ops)
        status=jnp.where(sel_ok, g(imm.status), trace_ops.IPS_OOB),
        host=(safe // C).astype(jnp.int32),
        sel_ok=sel_ok,
    )
    return fields, idx


def _scatter_trace(
    imm: ImmatureSet, idx, traced: trace_ops.TraceResult
) -> ImmatureSet:
    """Scatter compact-pool trace results back into the (F, C) arrays
    (out-of-bounds lanes drop)."""
    F, C = imm.u.shape
    NFULL = F * C
    dst = jnp.where(idx >= 0, idx, NFULL)

    def put(full, vals):
        return (
            full.reshape((NFULL,) + full.shape[2:])
            .at[dst]
            .set(vals, mode="drop")
            .reshape(full.shape)
        )

    return imm.replace(
        idepth_min=put(imm.idepth_min, traced.idepth_min),
        idepth_max=put(imm.idepth_max, traced.idepth_max),
        quality=put(imm.quality, traced.quality),
        status=put(imm.status, traced.status),
        pixel_interval=put(imm.pixel_interval, traced.pixel_interval),
        last_uv=put(imm.last_uv, traced.last_uv),
    )


class ActivationResult(NamedTuple):
    idepth: jax.Array  # (F, C) optimized inverse depth
    accepted: jax.Array  # (F, C) create a PointHessian
    dropped: jax.Array  # (F, C) delete the immature point
    res_good: jax.Array  # (F, C, Ftgt) residual IN per target frame


@functools.partial(jax.jit, static_argnames=("settings",))
def optimize_immature(
    imm: ImmatureSet,
    candidate,  # (F, C) bool — distance-map accepted candidates
    RTll,  # (F, F, 3, 3) current host->target rotations
    tTll,  # (F, F, 3)
    aff_ht,  # (F, F, 2)
    frame_valid,  # (F,)
    dI_stack,  # (F, H, W, 3)
    c_value,  # (4,)
    settings: Settings = default_settings(),
):
    """optimizeImmaturePoint (legacy 1-dof idepth LM, FullSystemOptPoint.cpp
    + ImmaturePoint::linearizeResidual legacy body :886-975), batched over
    every candidate at once.

    Returns ActivationResult; caller inserts accepted points into the Window.
    """
    F, C = imm.u.shape
    fx, fy, cx, cy = c_value[0], c_value[1], c_value[2], c_value[3]
    Hd, Wd = dI_stack.shape[1:3]
    wM3, hM3 = float(Wd - 3), float(Hd - 3)
    pat = jnp.asarray(PATTERN, dtype=imm.u.dtype)

    NFULL = F * C
    cand_full = (candidate & imm.valid).reshape(-1)

    # compact candidates to a fixed batch: the gate passes far fewer points
    # than the immature pool holds, so running the LM (and its patch gathers)
    # over all F*C rows wastes ~8x the work. Overflow candidates stay
    # immature until the next keyframe (the reference also bounds activations
    # per KF via the density controller, FullSystem.cpp:805-840).
    NC = min(NFULL, settings.activation_batch)
    flat_idx = jnp.nonzero(cand_full, size=NC, fill_value=-1)[0]
    sel_ok = flat_idx >= 0
    safe = jnp.maximum(flat_idx, 0)

    host_full = jnp.repeat(jnp.arange(F), C)  # (F*C,)
    host = host_full[safe]
    u = imm.u.reshape(-1)[safe]
    v = imm.v.reshape(-1)[safe]
    color = imm.color.reshape(-1, 8)[safe]
    weights = imm.weights.reshape(-1, 8)[safe]
    eth = imm.energy_th.reshape(-1)[safe]
    cand = sel_ok

    R = RTll[host]  # (NC, F, 3, 3)
    t = tTll[host]  # (NC, F, 3)
    aff = aff_ht[host]  # (NC, F, 2)
    tgt_ok = (
        cand[:, None]
        & frame_valid[None, :]
        & (host[:, None] != jnp.arange(F)[None, :])
    )  # (NC, F)

    id0 = (0.5 * (imm.idepth_min + imm.idepth_max)).reshape(-1)[safe]

    KliP = jnp.stack(
        [
            (u[:, None] + pat[None, :, 0] - cx) / fx,
            (v[:, None] + pat[None, :, 1] - cy) / fy,
            jnp.ones((u.shape[0], 8), u.dtype),
        ],
        axis=-1,
    )  # (N, 8, 3)

    def energy_H_b(idepth, res_oob, outlier_slack=1.0):
        """Per-target pattern energy + idepth H/b at given idepth.

        outlier_slack mirrors linearizeResidual's outlierTHSlack: the
        reference evaluates the INITIAL energy with slack 1000 (clamp
        effectively off, FullSystemOptPoint.cpp:74) and slack 1 only inside
        the GN loop."""
        ptp = (
            jnp.einsum("nfij,npj->nfpi", R, KliP)
            + t[:, :, None, :] * idepth[:, None, None, None]
        )  # (N, F, 8, 3)
        drescale = 1.0 / ptp[..., 2]
        uu = ptp[..., 0] * drescale
        vv = ptp[..., 1] * drescale
        Ku = uu * fx + cx
        Kv = vv * fy + cy
        ok = (
            (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < wM3) & (Kv < hM3)
        )
        all_ok = jnp.all(ok, axis=-1)  # (N, F)
        oob = ~all_ok | res_oob

        f_idx = jnp.broadcast_to(
            jnp.arange(F)[None, :, None], Ku.shape
        )
        # fused per-sample gather via residuals helper
        from stereo_dso_g2o_tpu.ops.residuals import _bilinear3_frames

        hit = _bilinear3_frames(dI_stack, f_idx, Ku, Kv)
        r = hit[..., 0] - (
            aff[..., 0:1] * color[:, None, :] + aff[..., 1:2]
        )
        ar = jnp.abs(r)
        hw = jnp.where(
            ar < settings.huber_th,
            1.0,
            settings.huber_th / jnp.maximum(ar, 1e-12),
        )
        w2 = weights[:, None, :] ** 2
        energy = jnp.sum(w2 * hw * r * r * (2.0 - hw), axis=-1)  # (N, F)

        dxI = hit[..., 1] * fx
        dyI = hit[..., 2] * fy
        # derive_idepth (ResidualProjections.h:36-42)
        d_id = (
            dxI * drescale * (t[..., 0:1] - t[..., 2:3] * uu)
            + dyI * drescale * (t[..., 1:2] - t[..., 2:3] * vv)
        )
        hw2 = hw * w2
        Hdd_t = jnp.sum(hw2 * d_id * d_id, axis=-1)
        bd_t = jnp.sum(hw2 * r * d_id, axis=-1)

        # outlier clamp (legacy linearizeResidual tail)
        outlier = energy > eth[:, None] * outlier_slack
        energy = jnp.where(outlier, eth[:, None] * outlier_slack, energy)
        state_in = tgt_ok & ~oob & ~outlier

        use = tgt_ok & ~oob
        Hdd = jnp.sum(jnp.where(use, Hdd_t, 0.0), axis=1)
        bd = jnp.sum(jnp.where(use, bd_t, 0.0), axis=1)
        E = jnp.sum(jnp.where(use, energy, 0.0), axis=1)
        return E, Hdd, bd, oob, state_in

    res_oob0 = jnp.zeros_like(tgt_ok) & False
    E, Hdd, bd, oob, state_in = energy_H_b(id0, res_oob0, outlier_slack=1000.0)

    def lm_body(k, carry):
        idepth, E_best, Hc, bc, lam, oob_c, in_c = carry
        step = -(bc / (Hc * (1.0 + lam) + 1e-10))
        new_id = idepth + step
        E2, H2, b2, oob2, in2 = energy_H_b(new_id, oob_c)
        accept = E2 < E_best
        idepth = jnp.where(accept, new_id, idepth)
        E_best = jnp.where(accept, E2, E_best)
        Hc = jnp.where(accept, H2, Hc)
        bc = jnp.where(accept, b2, bc)
        lam = jnp.where(accept, lam * 0.5, lam * 5.0)
        oob_c = oob_c | oob2
        in_c = jnp.where(accept[:, None], in2, in_c)
        return (idepth, E_best, Hc, bc, lam, oob_c, in_c)

    carry = (
        id0,
        E,
        Hdd,
        bd,
        jnp.full_like(id0, 0.1),
        oob,
        state_in,
    )
    idepth, E_fin, Hdd_fin, _, _, oob_fin, in_fin = jax.lax.fori_loop(
        0, settings.gn_its_on_point_activation, lm_body, carry
    )

    n_good = jnp.sum(in_fin, axis=1)
    well_constrained = Hdd_fin >= settings.min_idepth_h_act
    finite = jnp.isfinite(idepth)
    accepted = cand & finite & well_constrained & (n_good >= 1)
    # not well-constrained -> keep immature (return 0); nan/low obs -> drop
    dropped = cand & (~finite | (well_constrained & (n_good < 1)))

    # scatter compacted results back to the (F, C) pool layout; padding rows
    # get an out-of-range index and are dropped (never alias slot 0)
    f32 = idepth.dtype
    out_idx = jnp.where(sel_ok, safe, NFULL)
    id_full = jnp.zeros((NFULL,), f32).at[out_idx].set(idepth, mode="drop")
    acc_full = jnp.zeros((NFULL,), bool).at[out_idx].set(accepted, mode="drop")
    drop_full = jnp.zeros((NFULL,), bool).at[out_idx].set(dropped, mode="drop")
    resg_full = jnp.zeros((NFULL, F), bool).at[out_idx].set(in_fin, mode="drop")

    return ActivationResult(
        idepth=id_full.reshape(F, C),
        accepted=acc_full.reshape(F, C),
        dropped=drop_full.reshape(F, C),
        res_good=resg_full.reshape(F, C, F),
    )


@functools.partial(jax.jit, static_argnames=("settings", "h1", "w1"))
def activation_candidates(
    imm: ImmatureSet,
    dist_map,  # (h1, w1) level-1 distance map
    KRKi1,  # (F, 3, 3) host level-0 -> newest level-1
    Kt1,  # (F, 3)
    host_valid,
    newest_slot,
    min_act_dist,
    settings: Settings = default_settings(),
    *,
    h1: int,
    w1: int,
):
    """The distance-map candidate gate of activatePointsMT
    (FullSystem.cpp:841-903). Returns (candidate, delete) masks (F, C)."""
    F, C = imm.u.shape
    st = imm.status

    bad = ~jnp.isfinite(imm.idepth_max) | (st == trace_ops.IPS_OUTLIER)
    can_activate = (
        (
            (st == trace_ops.IPS_GOOD)
            | (st == trace_ops.IPS_SKIPPED)
            | (st == trace_ops.IPS_BADCONDITION)
            | (st == trace_ops.IPS_OOB)
        )
        & (imm.pixel_interval < 8)
        & (imm.quality > settings.min_trace_quality)
        & ((imm.idepth_max + imm.idepth_min) > 0)
    )

    mid = 0.5 * (imm.idepth_max + imm.idepth_min)
    ones = jnp.ones_like(imm.u)
    P = jnp.stack([imm.u, imm.v, ones], -1)  # (F, C, 3)
    ptp = jnp.einsum("fij,fcj->fci", KRKi1, P) + Kt1[:, None, :] * mid[..., None]
    u1 = ptp[..., 0] / ptp[..., 2]
    v1 = ptp[..., 1] / ptp[..., 2]
    iu = (u1 + 0.5).astype(jnp.int32)
    iv = (v1 + 0.5).astype(jnp.int32)
    inb = (iu > 0) & (iv > 0) & (iu < w1) & (iv < h1)

    safe_u = jnp.clip(iu, 0, w1 - 1)
    safe_v = jnp.clip(iv, 0, h1 - 1)
    dist = dist_map[safe_v, safe_u] + (ptp[..., 0] - jnp.floor(ptp[..., 0]))
    far_enough = dist >= min_act_dist * imm.my_type.astype(imm.u.dtype)

    not_newest = jnp.arange(F)[:, None] != newest_slot
    base = imm.valid & host_valid[:, None] & not_newest

    candidate = base & ~bad & can_activate & inb & far_enough
    # non-activatable points whose last trace went OOB are deleted too
    # (activatePointsMT's cleanup, FullSystem.cpp:858-866) — otherwise dead
    # slots pile up in the fixed-capacity arrays and displace new seeds
    delete = base & (
        bad
        | (can_activate & ~inb)
        | (~can_activate & (st == trace_ops.IPS_OOB))
    )
    return candidate, delete, iu, iv


@functools.partial(jax.jit, static_argnames=("settings",))
def trace_on_nonkey(
    imm: ImmatureSet,
    KRKi,  # (F, 3, 3) host -> new frame
    Kt,  # (F, 3)
    R_new,  # (F, 3, 3) host -> new rotation (unprojected)
    t_new,  # (F, 3)
    aff,  # (F, 2)
    dI_new,
    dI_right,
    K,  # (3, 3) level-0 intrinsics
    baseline,
    host_valid,
    settings: Settings = default_settings(),
) -> ImmatureSet:
    """traceNewCoarseNonKey (FullSystem.cpp:632-744): temporal epipolar trace
    onto the new frame, then L->R / R->L static-stereo refinement at the found
    position, and reprojection of the refined inverse-depth interval back into
    the host keyframe. Keeps the reference's acceptance quirk (:707: reject
    only when u_delta > 1 AND disparity < 10).

    The whole refinement (temporal trace + 2 stereo traces + both
    extract_point_data passes + reprojection) runs on the compact live-row
    pool (settings.trace_cap) — the fixed (F, C) capacity holds ~4x more
    dead slots than live points in steady state."""
    F, C = imm.u.shape
    flat, sel = _compact_live(imm, host_valid, settings)
    host = flat["host"]

    traced = trace_ops.trace_batch(
        flat["u"], flat["v"], flat["idepth_min"], flat["idepth_max"],
        flat["color"], flat["weights"], flat["gradH"], flat["energy_th"],
        flat["quality"], flat["status"],
        KRKi[host], Kt[host], aff[host], dI_new,
        settings=settings,
    )

    good = flat["sel_ok"] & (traced.status == trace_ops.IPS_GOOD)
    Hd, Wd = dI_new.shape[:2]
    n = flat["u"].shape[0]

    # The L->R / R->L stereo refinement only applies to points whose
    # temporal trace came back GOOD this frame (the reference's :689-710
    # block runs under exactly that condition) — at steady state that is
    # ~half the pool, and the trace's cost is per lane, so the GOOD subset
    # is compacted to half-size lanes before the two stereo traces. Overflow
    # rows (good count > NS, rare) keep their temporal result this frame.
    NS = max(min(n, settings.trace_cap // 2), 1)
    gidx = jnp.nonzero(good, size=NS, fill_value=-1)[0]
    g_ok = gidx >= 0
    gs_ = jnp.maximum(gidx, 0)

    u2 = jnp.clip(traced.last_uv[gs_, 0], 8.0, Wd - 9.0)
    v2 = jnp.clip(traced.last_uv[gs_, 1], 8.0, Hd - 9.0)

    # project the (traced) host interval into the new frame (:676-686)
    ones = jnp.ones_like(u2)
    P = jnp.stack([flat["u"][gs_], flat["v"][gs_], ones], -1)  # (NS, 3)
    KRKi_pt = KRKi[host[gs_]]
    Kt_pt = Kt[host[gs_]]
    ptp_min = (
        jnp.einsum("nij,nj->ni", KRKi_pt,
                   P / traced.idepth_min[gs_, None]) + Kt_pt
    )
    id_min_proj = 1.0 / ptp_min[:, 2]
    ptp_max = (
        jnp.einsum("nij,nj->ni", KRKi_pt,
                   P / traced.idepth_max[gs_, None]) + Kt_pt
    )
    id_max_proj = 1.0 / ptp_max[:, 2]

    color2, weights2, gradH2, eth2 = trace_ops.extract_point_data(
        dI_new, u2, v2, settings
    )
    fresh_q = jnp.full((NS,), 10000.0)
    # masked lanes run frozen (OOB no-ops inside trace_stereo)
    fresh_st = jnp.where(g_ok, trace_ops.IPS_UNINITIALIZED,
                         trace_ops.IPS_OOB).astype(jnp.int32)

    res_lr, idepth_stereo = trace_ops.trace_stereo(
        u2, v2, id_min_proj, id_max_proj, color2, weights2, gradH2, eth2,
        fresh_q, fresh_st, K, baseline, dI_right,
        mode_right=True, settings=settings,
    )
    stereo_good = res_lr.status == trace_ops.IPS_GOOD

    u3 = jnp.clip(res_lr.last_uv[:, 0], 8.0, Wd - 9.0)
    v3 = jnp.clip(res_lr.last_uv[:, 1], 8.0, Hd - 9.0)
    color3, weights3, gradH3, eth3 = trace_ops.extract_point_data(
        dI_right, u3, v3, settings
    )
    res_rl, _ = trace_ops.trace_stereo(
        u3, v3, id_min_proj, id_max_proj, color3, weights3, gradH3, eth3,
        jnp.full((NS,), 10000.0), fresh_st,
        K, baseline, dI_new, mode_right=False, settings=settings,
    )

    u_delta = jnp.abs(u2 - res_rl.last_uv[:, 0])
    disparity = u2 - res_lr.last_uv[:, 0]
    reject = stereo_good & (u_delta > 1.0) & (disparity < 10.0)
    accept = stereo_good & ~reject

    # reproject refined interval back into the host (:713-720)
    Ki = jnp.linalg.inv(K)
    P2 = jnp.stack([u2, v2, jnp.ones_like(u2)], -1)  # (NS, 3)
    KiP2 = jnp.einsum("ij,nj->ni", Ki, P2)
    KRi = jnp.einsum("ij,fkj->fik", K, R_new)  # K @ R^T per host (F,3,3)
    KRi_pt = KRi[host[gs_]]
    t_pt = t_new[host[gs_]]

    def backproj(id_stereo):
        pinv = jnp.einsum(
            "nij,nj->ni", KRi_pt, KiP2 / id_stereo[:, None] - t_pt
        )
        return 1.0 / pinv[:, 2]

    id_min_new = backproj(res_lr.idepth_min)
    id_max_new = backproj(res_lr.idepth_max)

    # scatter the stereo-refinement outcome back to the full pool
    dst = jnp.where(g_ok, gidx, n)
    upd_n = jnp.zeros((n,), bool).at[dst].set(
        accept & g_ok, mode="drop"
    )
    rej_n = jnp.zeros((n,), bool).at[dst].set(
        reject & g_ok, mode="drop"
    )
    idmin_n = jnp.zeros((n,), id_min_new.dtype).at[dst].set(
        id_min_new, mode="drop"
    )
    idmax_n = jnp.zeros((n,), id_max_new.dtype).at[dst].set(
        id_max_new, mode="drop"
    )

    refined = traced._replace(
        idepth_min=jnp.where(upd_n, idmin_n, traced.idepth_min),
        idepth_max=jnp.where(upd_n, idmax_n, traced.idepth_max),
        status=jnp.where(rej_n, trace_ops.IPS_OUTLIER, traced.status),
    )
    return _scatter_trace(imm, sel, refined)


@functools.partial(jax.jit, static_argnames=("settings", "max_insert"))
def insert_activated(
    win,
    imm: ImmatureSet,
    act: ActivationResult,
    settings: Settings = default_settings(),
    max_insert: int = 1024,
):
    """Device-side compaction of activation results into the Window
    (activatePointsMT STEP4, FullSystem.cpp:921-947): accepted immature points
    become PointHessians in free point slots with residuals to their IN
    targets; consumed and dropped immature slots are invalidated.

    Fixed shapes throughout (max_insert cap) so this compiles once — the
    variable-count host-side version recompiled every keyframe.
    """
    from stereo_dso_g2o_tpu.backend import window as W

    F, C = imm.u.shape
    acc_flat = (act.accepted & imm.valid).reshape(-1)
    src = jnp.nonzero(acc_flat, size=max_insert, fill_value=-1)[0]
    free = jnp.nonzero(win.pt_status == W.PT_INACTIVE, size=max_insert,
                       fill_value=-1)[0]
    ok = (src >= 0) & (free >= 0)
    src_safe = jnp.maximum(src, 0)
    # scatter destination: valid inserts go to their free slot, the rest to
    # an out-of-range index that the scatter drops. Every written index is
    # unique: a scatter with duplicate indices keeps an unspecified writer
    # on the GPU, per array.
    dst = jnp.where(ok, free, win.pt_status.shape[0])

    host = (src_safe // C).astype(jnp.int32)
    u = imm.u.reshape(-1)[src_safe]
    v = imm.v.reshape(-1)[src_safe]
    idepth = act.idepth.reshape(-1)[src_safe]
    color = imm.color.reshape(-1, 8)[src_safe]
    weights = imm.weights.reshape(-1, 8)[src_safe]
    eth = imm.energy_th.reshape(-1)[src_safe]
    res_good = act.res_good.reshape(-1, F)[src_safe]

    def put(arr, vals):
        return arr.at[dst].set(vals.astype(arr.dtype), mode="drop")

    win = win.replace(
        pt_status=put(win.pt_status, jnp.full((max_insert,), W.PT_ACTIVE, jnp.int32)),
        pt_host=put(win.pt_host, host),
        pt_u=put(win.pt_u, u),
        pt_v=put(win.pt_v, v),
        pt_idepth=put(win.pt_idepth, idepth),
        pt_idepth_zero=put(win.pt_idepth_zero, idepth),
        pt_color=put(win.pt_color, color),
        pt_weights=put(win.pt_weights, weights),
        pt_has_prior=put(win.pt_has_prior, jnp.zeros((max_insert,), bool)),
        pt_energy_th=put(win.pt_energy_th, eth),
        pt_num_good_res=put(win.pt_num_good_res, jnp.zeros((max_insert,), jnp.int32)),
        pt_max_rel_baseline=put(win.pt_max_rel_baseline, jnp.zeros((max_insert,))),
        pt_idepth_hessian=put(win.pt_idepth_hessian, jnp.zeros((max_insert,))),
        res_exists=put(win.res_exists, res_good),
        res_state=put(win.res_state, jnp.full((max_insert, F), W.RES_IN, jnp.int32)),
        res_linearized=put(win.res_linearized, jnp.zeros((max_insert, F), bool)),
        res_energy=put(win.res_energy, jnp.zeros((max_insert, F))),
    )

    # invalidate consumed (actually inserted) + dropped immature slots
    inserted_flat = jnp.zeros((F * C,), bool).at[
        jnp.where(ok, src_safe, F * C)
    ].set(True, mode="drop")
    gone = inserted_flat.reshape(F, C) | act.dropped
    imm = imm.replace(valid=imm.valid & ~gone)
    n_inserted = jnp.sum(ok)
    return win, imm, n_inserted


@functools.partial(jax.jit, static_argnames=("settings", "h1", "w1"))
def activation_gate(
    win,
    imm: ImmatureSet,
    newest_slot,
    min_act_dist,
    calib_c,
    settings: Settings = default_settings(),
    *,
    h1: int,
    w1: int,
):
    """The whole activation candidate gate as one program: project active
    points into the newest KF at level 1, grow the distance map, apply the
    candidate rules, and suppress same-cell duplicates
    (activatePointsMT STEP1-2, FullSystem.cpp:826-903)."""
    from stereo_dso_g2o_tpu.backend import window as W
    from stereo_dso_g2o_tpu.ops import distance_map as DM

    F = imm.u.shape[0]
    fx, fy, cx, cy = calib_c[0], calib_c[1], calib_c[2], calib_c[3]
    fx1 = fx * 0.5
    fy1 = fy * 0.5
    cx1 = (cx + 0.5) * 0.5 - 0.5
    cy1 = (cy + 0.5) * 0.5 - 0.5
    zero = jnp.zeros((), calib_c.dtype)
    one = jnp.ones((), calib_c.dtype)
    K1 = jnp.stack(
        [
            jnp.stack([fx1, zero, cx1]),
            jnp.stack([zero, fy1, cy1]),
            jnp.stack([zero, zero, one]),
        ]
    )
    Ki0 = jnp.stack(
        [
            jnp.stack([1.0 / fx, zero, -cx / fx]),
            jnp.stack([zero, 1.0 / fy, -cy / fy]),
            jnp.stack([zero, zero, one]),
        ]
    )
    w2c = win.w2c()
    T_new = w2c[newest_slot]
    T_hn = jnp.einsum("ij,fjk->fik", T_new, jnp.linalg.inv(w2c))
    KRKi1 = jnp.einsum("ij,fjk,kl->fil", K1, T_hn[:, :3, :3], Ki0)
    Kt1 = jnp.einsum("ij,fj->fi", K1, T_hn[:, :3, 3])

    active = win.pt_status == W.PT_ACTIVE
    P = jnp.stack([win.pt_u, win.pt_v, jnp.ones_like(win.pt_u)], -1)
    ptp = (
        jnp.einsum("nij,nj->ni", KRKi1[win.pt_host], P)
        + Kt1[win.pt_host] * win.pt_idepth[:, None]
    )
    pu = (ptp[:, 0] / ptp[:, 2] + 0.5).astype(jnp.int32)
    pv = (ptp[:, 1] / ptp[:, 2] + 0.5).astype(jnp.int32)
    inb = (pu > 0) & (pv > 0) & (pu < w1) & (pv < h1)
    dmap = DM.distance_map(pu, pv, active & inb, h1, w1, iters=18)

    cand, delete, iu, iv = activation_candidates(
        imm, dmap, KRKi1, Kt1, win.frame_valid, newest_slot, min_act_dist,
        settings=settings, h1=h1, w1=w1,
    )
    cand_flat = DM.suppress_same_cell(
        iu.reshape(-1), iv.reshape(-1), cand.reshape(-1), cell=2
    ).reshape(cand.shape)
    return cand_flat, delete
