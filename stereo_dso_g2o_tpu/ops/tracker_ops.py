"""Coarse-tracker kernels: reference idepth maps + direct image alignment.

JAX rebuild of CoarseTracker (FullSystem/CoarseTracker.{h,cpp}):

- `build_ref_maps`: weighted point splat at level 0, sum-pooling up the
  pyramid, 2-phase dilation (diagonal on levels 0-1, 4-neighbour above),
  normalization (makeCoarseDepthL0 STEP2-5, CoarseTracker.cpp:360-533).
  The stereo re-verification of STEP1 (:305-347) lives in the frontend and
  feeds the (u, v, idepth, weight) splat inputs.
- `calc_res`: batched warp of all reference points to the new frame, Huber
  photometric residuals with cutoff saturation, flow indicators
  (calcRes, :600-792, legacy non-g2o semantics).
- `calc_gs`: 8x8 Gauss-Newton system from the warped buffers via one einsum —
  the math of the SSE accumulator path (calcGSSSE, :537-596), including the
  reference's (buggy, harmless) swap of rot/trans preconditioning scales.
- `lm_level`: the per-level Levenberg-Marquardt loop with the legacy
  accept/reject lambda schedule and increment conventions
  (trackNewestCoarse legacy body, :930-1038).

All shapes are static per pyramid level; the host only drives the level
cascade and the retry ladder.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.config import (
    SCALE_A,
    SCALE_B,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    Settings,
    default_settings,
)
from stereo_dso_g2o_tpu.utils import se3


# ---------------------------------------------------------------------------
# reference map construction
# ---------------------------------------------------------------------------


def _dilate_diag(idepth, wsum):
    """Fill holes from the four diagonal neighbours (levels 0-1; :389-442)."""
    def sh(x, dy, dx):
        return jnp.roll(x, (dy, dx), axis=(0, 1))

    num = jnp.zeros_like(wsum)
    s_id = jnp.zeros_like(idepth)
    s_w = jnp.zeros_like(wsum)
    for dy, dx in ((-1, -1), (1, 1), (-1, 1), (1, -1)):
        wn = sh(wsum, dy, dx)
        idn = sh(idepth, dy, dx)
        m = wn > 0
        num = num + m
        s_id = s_id + jnp.where(m, idn, 0.0)
        s_w = s_w + jnp.where(m, wn, 0.0)
    hole = (wsum <= 0) & (num > 0)
    return (
        jnp.where(hole, s_id / jnp.maximum(num, 1), idepth),
        jnp.where(hole, s_w / jnp.maximum(num, 1), wsum),
    )


def _dilate_cross(idepth, wsum):
    """Fill holes from the four axis neighbours (levels >=2; :446-496)."""
    def sh(x, dy, dx):
        return jnp.roll(x, (dy, dx), axis=(0, 1))

    num = jnp.zeros_like(wsum)
    s_id = jnp.zeros_like(idepth)
    s_w = jnp.zeros_like(wsum)
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
        wn = sh(wsum, dy, dx)
        idn = sh(idepth, dy, dx)
        m = wn > 0
        num = num + m
        s_id = s_id + jnp.where(m, idn, 0.0)
        s_w = s_w + jnp.where(m, wn, 0.0)
    hole = (wsum <= 0) & (num > 0)
    return (
        jnp.where(hole, s_id / jnp.maximum(num, 1), idepth),
        jnp.where(hole, s_w / jnp.maximum(num, 1), wsum),
    )


@functools.partial(jax.jit, static_argnames=("n_levels",))
def build_ref_maps(us, vs, idepths, weights, valid, *, n_levels: int = 6, dI_ref=None):
    """Build per-level (idepth_map, valid_map, color_map) for tracking.

    us, vs: (N,) level-0 integer pixel coords; idepths, weights: (N,);
    valid: (N,) mask; dI_ref: tuple of per-level (H,W,3) reference pyramids
    (color source). Returns tuples of per-level maps.
    """
    assert dI_ref is not None
    H, W = dI_ref[0].shape[:2]
    iu = jnp.clip(us.astype(jnp.int32), 0, W - 1)
    iv = jnp.clip(vs.astype(jnp.int32), 0, H - 1)
    w_ok = jnp.where(valid, weights, 0.0)
    id_acc = jnp.zeros((H, W), jnp.float32).at[iv, iu].add(idepths * w_ok)
    w_acc = jnp.zeros((H, W), jnp.float32).at[iv, iu].add(w_ok)

    id_maps, w_maps = [id_acc], [w_acc]
    for lvl in range(1, n_levels):
        idp = id_maps[-1]
        wp = w_maps[-1]
        h2, w2 = idp.shape[0] // 2, idp.shape[1] // 2
        # sum-pool 2x2 (weights carry the normalization; :360-385)
        def pool(x):
            return (
                x[0 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + x[0 : 2 * h2 : 2, 1 : 2 * w2 : 2]
                + x[1 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + x[1 : 2 * h2 : 2, 1 : 2 * w2 : 2]
            )
        id_maps.append(pool(idp))
        w_maps.append(pool(wp))

    out_id, out_valid, out_color = [], [], []
    for lvl in range(n_levels):
        idm, wm = id_maps[lvl], w_maps[lvl]
        if lvl < 2:
            idm, wm = _dilate_diag(idm, wm)
        else:
            idm, wm = _dilate_cross(idm, wm)
        ok = wm > 0
        idn = jnp.where(ok, idm / jnp.maximum(wm, 1e-12), -1.0)
        # interior-only usable points (:506: y,x in [2, size-2))
        hl, wl = idn.shape
        xs = jnp.arange(wl)
        ys = jnp.arange(hl)
        interior = (
            (xs[None, :] >= 2) & (xs[None, :] < wl - 2)
            & (ys[:, None] >= 2) & (ys[:, None] < hl - 2)
        )
        colr = dI_ref[lvl][..., 0]
        ok = ok & interior & (idn > 0) & jnp.isfinite(colr)
        out_id.append(jnp.where(ok, idn, -1.0))
        out_valid.append(ok)
        out_color.append(colr)
    return tuple(out_id), tuple(out_valid), tuple(out_color)


@functools.partial(jax.jit, static_argnames=("cap",))
def compact_ref_level(id_map, valid_map, color_map, cap: int):
    """Compact one level's maps into fixed-capacity point lists (pc_* arrays)."""
    H, W = id_map.shape
    flat = valid_map.ravel()
    idx = jnp.nonzero(flat, size=cap, fill_value=-1)[0]
    ok = idx >= 0
    safe = jnp.maximum(idx, 0)
    u = (safe % W).astype(jnp.float32)
    v = (safe // W).astype(jnp.float32)
    return (
        u,
        v,
        jnp.where(ok, id_map.ravel()[safe], 0.0),
        jnp.where(ok, color_map.ravel()[safe], 0.0),
        ok,
    )


# ---------------------------------------------------------------------------
# residuals + normal equations
# ---------------------------------------------------------------------------


class ResStats(NamedTuple):
    energy: jax.Array  # () saturated-clamped total energy
    num_terms: jax.Array  # () number of in-bounds terms
    num_saturated: jax.Array  # ()
    flow_t: jax.Array  # () translation-only flow indicator
    flow_rt: jax.Array  # () translation+rotation flow indicator
    # warped buffers for calc_gs (masked by buf_ok)
    buf_ok: jax.Array  # (N,) in-bounds AND below the cutoff ("good")
    buf_inb: jax.Array  # (N,) in-bounds regardless of saturation
    buf_idepth: jax.Array
    buf_u: jax.Array
    buf_v: jax.Array
    buf_dx: jax.Array
    buf_dy: jax.Array
    buf_residual: jax.Array
    buf_weight: jax.Array
    buf_ref_color: jax.Array


def _bilinear3(dI, x, y):
    """Bilinear sample of an (H, W, 3) pyramid level at (x, y) — the whole
    2x2x3 neighbourhood of every point in ONE XLA gather (broadcast advanced
    indexing, not a vmapped dynamic_slice)."""
    H, W = dI.shape[:2]
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = (x - ix)[..., None]
    fy = (y - iy)[..., None]
    d2 = jnp.arange(2, dtype=jnp.int32)
    p = dI[
        iy[..., None, None] + d2[:, None], ix[..., None, None] + d2[None, :]
    ]  # (..., 2, 2, 3)
    top = (1 - fx) * p[..., 0, 0, :] + fx * p[..., 0, 1, :]
    bot = (1 - fx) * p[..., 1, 0, :] + fx * p[..., 1, 1, :]
    return (1 - fy) * top + fy * bot


@functools.partial(jax.jit, static_argnames=("settings", "compute_flow"))
def calc_res(
    pc_u,
    pc_v,
    pc_idepth,
    pc_color,
    pc_ok,
    dI_new,
    K_lvl,
    T_ref_new,
    aff_ab,
    cutoff_th,
    settings: Settings = default_settings(),
    compute_flow: bool = True,
) -> ResStats:
    """Photometric residuals of all reference points warped into the new frame
    (calcRes legacy semantics, CoarseTracker.cpp:600-792).

    K_lvl: (4,) = (fx, fy, cx, cy) at this level; T_ref_new: (4,4) refToNew;
    aff_ab: (2,) final (a, b) of the brightness transfer (already through
    AffLight::fromToVecExposure).
    """
    H, W = dI_new.shape[:2]
    fx, fy, cx, cy = K_lvl[0], K_lvl[1], K_lvl[2], K_lvl[3]
    R = T_ref_new[:3, :3]
    t = T_ref_new[:3, 3]

    # back-project: Ki @ (u, v, 1) with diagonal Ki
    xn = (pc_u - cx) / fx
    yn = (pc_v - cy) / fy
    ones = jnp.ones_like(xn)
    P = jnp.stack([xn, yn, ones], -1)  # (N, 3)
    pt = P @ R.T + t[None, :] * pc_idepth[:, None]
    u_n = pt[:, 0] / pt[:, 2]
    v_n = pt[:, 1] / pt[:, 2]
    Ku = fx * u_n + cx
    Kv = fy * v_n + cy
    new_idepth = pc_idepth / pt[:, 2]

    inb = (
        pc_ok
        & (Ku > 2)
        & (Kv > 2)
        & (Ku < W - 3)
        & (Kv < H - 3)
        & (new_idepth > 0)
    )

    hit = _bilinear3(dI_new, Ku, Kv)
    residual = hit[..., 0] - (aff_ab[0] * pc_color + aff_ab[1])
    ar = jnp.abs(residual)
    hw = jnp.where(
        ar < settings.huber_th, 1.0, settings.huber_th / jnp.maximum(ar, 1e-12)
    )

    saturated = inb & (ar > cutoff_th)
    good = inb & ~saturated
    max_energy = 2.0 * settings.huber_th * cutoff_th - settings.huber_th**2
    e_term = jnp.where(
        good, hw * residual * residual * (2.0 - hw), jnp.where(saturated, max_energy, 0.0)
    )
    energy = jnp.sum(e_term)
    num_terms = jnp.sum(inb)
    num_saturated = jnp.sum(saturated)

    # flow indicators, every 32nd point at the caller's discretion (:663-712):
    # here over all valid points (denser estimate, same scale). Skipped inside
    # the LM loop (compute_flow=False) — only the final evaluation needs them.
    if compute_flow:
        ptT = P + t[None, :] * pc_idepth[:, None]
        KuT = fx * ptT[:, 0] / ptT[:, 2] + cx
        KvT = fy * ptT[:, 1] / ptT[:, 2] + cy
        ptT2 = P - t[None, :] * pc_idepth[:, None]
        KuT2 = fx * ptT2[:, 0] / ptT2[:, 2] + cx
        KvT2 = fy * ptT2[:, 1] / ptT2[:, 2] + cy
        pt3 = P @ R.T - t[None, :] * pc_idepth[:, None]
        Ku3 = fx * pt3[:, 0] / pt3[:, 2] + cx
        Kv3 = fy * pt3[:, 1] / pt3[:, 2] + cy

        m = pc_ok
        nsel = jnp.maximum(jnp.sum(m), 1)
        flow_t = (
            jnp.sum(jnp.where(m, (KuT - pc_u) ** 2 + (KvT - pc_v) ** 2, 0.0))
            + jnp.sum(jnp.where(m, (KuT2 - pc_u) ** 2 + (KvT2 - pc_v) ** 2, 0.0))
        ) / (2.0 * nsel + 0.1)
        flow_rt = (
            jnp.sum(jnp.where(m, (Ku - pc_u) ** 2 + (Kv - pc_v) ** 2, 0.0))
            + jnp.sum(jnp.where(m, (Ku3 - pc_u) ** 2 + (Kv3 - pc_v) ** 2, 0.0))
        ) / (2.0 * nsel + 0.1)
    else:
        flow_t = jnp.asarray(0.0, dI_new.dtype)
        flow_rt = jnp.asarray(0.0, dI_new.dtype)

    return ResStats(
        energy=energy,
        num_terms=num_terms,
        num_saturated=num_saturated,
        flow_t=flow_t,
        flow_rt=flow_rt,
        buf_ok=good,
        buf_inb=inb,
        buf_idepth=new_idepth,
        buf_u=u_n,
        buf_v=v_n,
        buf_dx=hit[..., 1],
        buf_dy=hit[..., 2],
        buf_residual=residual,
        buf_weight=hw,
        buf_ref_color=pc_color,
    )


@jax.jit
def calc_gs(stats: ResStats, K_lvl, a_coeff, b0):
    """8x8 H and 8x1 b from the warped buffers (calcGSSSE, :537-596).

    a_coeff: scalar a of fromToVecExposure (photometric transfer slope);
    b0: reference frame's aff b. Returns (H, b) already scaled by the
    reference's preconditioners (including its rot/trans scale swap).
    """
    fx, fy = K_lvl[0], K_lvl[1]
    ok = stats.buf_ok
    n = jnp.maximum(jnp.sum(ok), 1).astype(jnp.float32)

    dx = stats.buf_dx * fx
    dy = stats.buf_dy * fy
    u = stats.buf_u
    v = stats.buf_v
    idp = stats.buf_idepth

    J = jnp.stack(
        [
            idp * dx,
            idp * dy,
            -idp * (u * dx + v * dy),
            -(u * v * dx + dy * (1.0 + v * v)),
            u * v * dy + dx * (1.0 + u * u),
            u * dy - v * dx,
            a_coeff * (b0 - stats.buf_ref_color),
            -jnp.ones_like(u),
            stats.buf_residual,
        ],
        axis=-1,
    )  # (N, 9)
    w = jnp.where(ok, stats.buf_weight, 0.0)
    Hfull = jnp.einsum("ni,nj,n->ij", J, J, w) / n
    Hm = Hfull[:8, :8]
    bv = Hfull[:8, 8]

    # preconditioning with the reference's swapped rot/trans scales (:585-596)
    scale = jnp.asarray(
        [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B],
        dtype=Hm.dtype,
    )
    Hm = Hm * scale[:, None] * scale[None, :]
    bv = bv * scale
    return Hm, bv


# ---------------------------------------------------------------------------
# per-level LM loop
# ---------------------------------------------------------------------------


class LevelResult(NamedTuple):
    T: jax.Array  # (4,4) refined refToNew
    aff: jax.Array  # (2,) refined (a, b) of aff_g2l for the new frame
    res_per_point: jax.Array  # () sqrt(E/num)
    flow_t: jax.Array
    flow_rt: jax.Array
    num_terms: jax.Array
    sat_frac: jax.Array  # () final saturation fraction at the FINAL cutoff
    repeated: jax.Array  # () bool: this level ran the cutoff-repeat pass


def _aff_transfer(ref_exposure, new_exposure, ref_aff, new_aff):
    """AffLight::fromToVecExposure (util/NumType.h:159-170)."""
    a = jnp.exp(new_aff[0] - ref_aff[0]) * new_exposure / ref_exposure
    b = new_aff[1] - a * ref_aff[1]
    return jnp.stack([a, b])


def _cutoff_rep_of(ar, inb, settings: Settings):
    """The while-doubling of levelCutoffRepeat (legacy :897-906), closed form
    from one residual evaluation: saturation at repeat r depends only on the
    per-point |residual| (ar) and the in-bounds mask, both cutoff-independent.
    Doubles while sat > 0.6 and rep < 50 (so rep in {1,2,...,64})."""
    n = jnp.maximum(jnp.sum(inb), 1)
    rep = jnp.asarray(1.0, jnp.float32)
    for _ in range(7):
        sat = jnp.sum(inb & (ar > settings.coarse_cutoff_th * rep)) / n
        rep = jnp.where((sat > 0.6) & (rep < 50.0), rep * 2.0, rep)
    return rep


def _energy_at_cutoff(ar, inb, cutoff, settings: Settings):
    """Recompute (energy, num_terms, sat_frac) at a new cutoff from carried
    per-point |residual| + in-bounds buffers (calcRes energy semantics)."""
    hw = jnp.where(
        ar < settings.huber_th, 1.0,
        settings.huber_th / jnp.maximum(ar, 1e-12),
    )
    saturated = inb & (ar > cutoff)
    good = inb & ~saturated
    max_energy = 2.0 * settings.huber_th * cutoff - settings.huber_th**2
    e = jnp.where(
        good, hw * ar * ar * (2.0 - hw), jnp.where(saturated, max_energy, 0.0)
    )
    n = jnp.sum(inb)
    return jnp.sum(e), n, jnp.sum(saturated) / jnp.maximum(n, 1)


@functools.partial(jax.jit, static_argnames=("settings", "max_iterations"))
def lm_level(
    pc_u,
    pc_v,
    pc_idepth,
    pc_color,
    pc_ok,
    dI_new,
    K_lvl,
    T_init,
    aff_init,
    ref_aff,
    ref_exposure,
    new_exposure,
    have_repeated,  # () bool: a cutoff-repeat already ran this cascade
    settings: Settings = default_settings(),
    max_iterations: int = 10,
) -> LevelResult:
    """One pyramid level of the tracker's LM (legacy loop, :930-1038),
    including the cutoff-repeat machinery IN-GRAPH:

    - the initial while-doubling of levelCutoffRepeat (:891-906) runs as a
      closed-form computation on one probe evaluation;
    - the one-shot level repeat (:1036-1041: rerun the level with the repeat
      re-derived at the refined pose) is folded into the same lax.while_loop
      (iteration counter + lambda reset, energy re-based at the new cutoff).
      Deviation: the first step of the repeat pass reuses the H/b assembled
      at the previous cutoff (one slightly stale GN direction); the reference
      rebuilds them before stepping. Both are GN approximations and the
      accept test runs at the new cutoff either way.
    """
    s = settings
    lambda_extrap_limit = 0.001

    def res_of(T, aff, cutoff, compute_flow=False):
        ab = _aff_transfer(ref_exposure, new_exposure, ref_aff, aff)
        return calc_res(
            pc_u, pc_v, pc_idepth, pc_color, pc_ok, dI_new, K_lvl, T, ab,
            cutoff, settings=settings, compute_flow=compute_flow,
        ), ab

    # probe at an effectively-infinite cutoff: buf_ok == in-bounds mask, and
    # |residual| is cutoff-independent -> derive the repeat + masks from it
    stats_p, ab0 = res_of(T_init, aff_init, jnp.asarray(1e30, jnp.float32))
    ar0 = jnp.abs(stats_p.buf_residual)
    inb0 = stats_p.buf_inb
    rep0 = _cutoff_rep_of(ar0, inb0, s)
    cutoff0 = s.coarse_cutoff_th * rep0
    stats0 = stats_p._replace(buf_ok=inb0 & (ar0 <= cutoff0))
    E0, n0, _ = _energy_at_cutoff(ar0, inb0, cutoff0, s)
    H0, b0v = calc_gs(stats0, K_lvl, ab0[0], ref_aff[1])
    rep_pending0 = (rep0 > 1.0) & ~have_repeated

    opt_a = settings.affine_opt_mode_a >= 0
    opt_b = settings.affine_opt_mode_b >= 0

    from stereo_dso_g2o_tpu.utils.smalls import cholesky_solve_small

    def solve(Hm, bv, lam):
        Hl = Hm + jnp.diag(jnp.diag(Hm)) * lam
        if opt_a and opt_b:
            inc = cholesky_solve_small(Hl, -bv)
        elif not opt_a and not opt_b:
            inc6 = cholesky_solve_small(Hl[:6, :6], -bv[:6])
            inc = jnp.concatenate([inc6, jnp.zeros(2, Hl.dtype)])
        elif opt_a and not opt_b:
            inc7 = cholesky_solve_small(Hl[:7, :7], -bv[:7])
            inc = jnp.concatenate([inc7, jnp.zeros(1, Hl.dtype)])
        else:  # fix a, optimize b (stitch trick, :1003-1017)
            idx = jnp.asarray([0, 1, 2, 3, 4, 5, 7])
            Hs = Hl[jnp.ix_(idx, idx)]
            bs = bv[idx]
            inc7 = cholesky_solve_small(Hs, -bs)
            inc = jnp.zeros(8, Hl.dtype)
            inc = inc.at[:6].set(inc7[:6])
            inc = inc.at[7].set(inc7[6])
        extrap = jnp.where(
            lam < lambda_extrap_limit,
            jnp.sqrt(jnp.sqrt(lambda_extrap_limit / jnp.maximum(lam, 1e-12))),
            1.0,
        )
        inc = inc * extrap
        scale = jnp.asarray(
            [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B],
            dtype=inc.dtype,
        )
        inc_scaled = inc * scale
        return jnp.where(jnp.isfinite(inc_scaled).all(), inc_scaled, 0.0), inc

    def cond(carry):
        return ~carry[-1]

    def body(carry):
        (it, total, T, aff, E_old, n_old, lam, Hm, bv, cutoff, ar, inb,
         rep_pending, done_all) = carry
        inc_scaled, inc_raw = solve(Hm, bv, lam)
        T_new = se3.se3_exp(inc_scaled[:6]) @ T
        aff_new = aff + inc_scaled[6:8]
        stats_new, ab_new = res_of(T_new, aff_new, cutoff)
        accept = (stats_new.energy / jnp.maximum(stats_new.num_terms, 1)) < (
            E_old / jnp.maximum(n_old, 1)
        )

        Hn, bn = calc_gs(stats_new, K_lvl, ab_new[0], ref_aff[1])
        T_out = jnp.where(accept, T_new, T)
        aff_out = jnp.where(accept, aff_new, aff)
        E_out = jnp.where(accept, stats_new.energy, E_old)
        n_out = jnp.where(accept, stats_new.num_terms, n_old)
        H_out = jnp.where(accept, Hn, Hm)
        b_out = jnp.where(accept, bn, bv)
        lam_out = jnp.where(
            accept, lam * 0.5, jnp.maximum(lam * 4.0, lambda_extrap_limit)
        )
        ar_out = jnp.where(accept, jnp.abs(stats_new.buf_residual), ar)
        inb_out = jnp.where(accept, stats_new.buf_inb, inb)

        it1 = it + 1
        pass_end = (jnp.linalg.norm(inc_raw) <= 1e-3) | (it1 >= max_iterations)
        do_rep = pass_end & rep_pending
        # repeat transition (:1036-1041): re-derive the repeat at the refined
        # pose, re-base the energy at the new cutoff, reset iteration + lambda
        rep2 = _cutoff_rep_of(ar_out, inb_out, s)
        cutoff2 = s.coarse_cutoff_th * rep2
        E2, n2, _ = _energy_at_cutoff(ar_out, inb_out, cutoff2, s)
        it_out = jnp.where(do_rep, 0, it1)
        lam_out = jnp.where(do_rep, jnp.asarray(0.01, lam.dtype), lam_out)
        cutoff_out = jnp.where(do_rep, cutoff2, cutoff)
        E_out = jnp.where(do_rep, E2, E_out)
        n_out = jnp.where(do_rep, n2, n_out)
        done_out = (pass_end & ~do_rep) | (total + 1 >= 2 * max_iterations + 2)
        return (
            it_out, total + 1, T_out, aff_out, E_out, n_out, lam_out, H_out,
            b_out, cutoff_out, ar_out, inb_out, rep_pending & ~do_rep, done_out,
        )

    init = (
        jnp.asarray(0),
        jnp.asarray(0),
        T_init,
        aff_init,
        E0,
        n0,
        jnp.asarray(0.01, dtype=jnp.float32),
        H0,
        b0v,
        cutoff0,
        ar0,
        inb0,
        rep_pending0,
        jnp.asarray(max_iterations <= 0),
    )
    (_, _, T, aff, E, n, _, _, _, cutoff_f, ar_f, inb_f, _, _) = (
        jax.lax.while_loop(cond, body, init)
    )

    _, _, sat_f = _energy_at_cutoff(ar_f, inb_f, cutoff_f, s)
    stats_f, _ = res_of(T, aff, cutoff_f, compute_flow=True)
    return LevelResult(
        T=T,
        aff=aff,
        res_per_point=jnp.sqrt(E / jnp.maximum(n, 1)),
        flow_t=stats_f.flow_t,
        flow_rt=stats_f.flow_rt,
        num_terms=n,
        sat_frac=sat_f,
        repeated=rep_pending0,
    )
