"""Batched epipolar depth tracing — the unified trace kernel.

JAX rebuild of ImmaturePoint::traceOn (ImmaturePoint.cpp:459-806) and
ImmaturePoint::traceStereo (ImmaturePoint.cpp:94-457). The reference runs the
same machinery in two guises (temporal epipolar search with general KRK^-1/Kt,
and static stereo with identity rotation and horizontal baseline); here both
are one vectorized kernel over the whole point set:

  1. project the inverse-depth interval endpoints -> epipolar segment
  2. discrete search along the segment (<=100 steps x 8-pixel pattern energy,
     Huber), best + second-best-outside-radius quality
  3. <=3-step 1-dof Gauss-Newton refinement along the epipolar direction
     (legacy solver semantics: H init 1, step clamp +-0.5, step-back halving —
     ImmaturePoint.cpp:735-769 — not the g2o VertexUVDSO detour)
  4. error bound from the gradient-vs-epipolar angle, interval update,
     status state machine (GOOD/OOB/OUTLIER/SKIPPED/BADCONDITION)

Everything is masked fixed-trip: no data-dependent shapes, so one XLA program
traces every immature point of every keyframe at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.config import PATTERN, Settings, default_settings
from stereo_dso_g2o_tpu.ops.interp import bilinear

# Status codes (ImmaturePoint.h:50-56).
IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5


class TraceResult(NamedTuple):
    status: jax.Array  # (N,) int32
    idepth_min: jax.Array  # (N,) f32 — updated interval
    idepth_max: jax.Array  # (N,) f32
    last_uv: jax.Array  # (N, 2) f32 — best match position (-1,-1 if none)
    pixel_interval: jax.Array  # (N,) f32 — 2*errorInPixel
    quality: jax.Array  # (N,) f32 — best/second-best ratio
    best_energy: jax.Array  # (N,) f32


def extract_point_data(dI0: jax.Array, u: jax.Array, v: jax.Array, settings: Settings):
    """Gather per-point pattern colors, weights, gradH from the host image.

    Mirrors the ImmaturePoint constructor (ImmaturePoint.cpp:33-62): colors by
    bilinear interpolation, gradH = sum of outer products of the cell-difference
    gradients (getInterpolatedElement33BiLin, globalFuncs.h:160-184), weights =
    sqrt(c^2 / (c^2 + |grad|^2)).

    dI0: (H, W, 3); u, v: (N,). Returns (color (N,8), weights (N,8),
    gradH (N,2,2), energy_th (N,)).
    """
    pat = jnp.asarray(PATTERN, dtype=u.dtype)  # (8, 2)
    px = u[:, None] + pat[None, :, 0]
    py = v[:, None] + pat[None, :, 1]
    img = dI0[..., 0]
    # BiLin scheme: intensity bilinear; gradients are cell finite differences.
    H, W = img.shape
    x = jnp.clip(px, 0.0, W - 1.001)
    y = jnp.clip(py, 0.0, H - 1.001)
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    dx = x - ix
    dy = y - iy
    tl = img[iy, ix]
    tr = img[iy, ix + 1]
    bl = img[iy + 1, ix]
    br = img[iy + 1, ix + 1]
    top = dx * tr + (1 - dx) * tl
    bot = dx * br + (1 - dx) * bl
    left = dy * bl + (1 - dy) * tl
    right = dy * br + (1 - dy) * tr
    color = dx * right + (1 - dx) * left  # (N, 8)
    gx = right - left
    gy = bot - top
    g2 = gx * gx + gy * gy
    c2 = settings.outlier_th_sum_component
    weights = jnp.sqrt(c2 / (c2 + g2))
    gradH = jnp.stack(
        [
            jnp.stack([jnp.sum(gx * gx, -1), jnp.sum(gx * gy, -1)], -1),
            jnp.stack([jnp.sum(gx * gy, -1), jnp.sum(gy * gy, -1)], -1),
        ],
        axis=-2,
    )  # (N, 2, 2)
    energy_th = jnp.full_like(u, settings.energy_th())
    return color, weights, gradH, energy_th


def _pattern_energy(dI, px, py, color, aff_a, aff_b, huber_th):
    """Bilinear Huber pattern energy at sample positions.

    dI: (H,W,3); px, py: (..., 8); color / aff_a / aff_b broadcastable.
    Returns (...,) energy = sum_p hw*r^2*(2-hw)  (ImmaturePoint.cpp:659-691).
    """
    H, W = dI.shape[:2]
    img = dI[..., 0]
    x = jnp.clip(px, 0.0, W - 1.001)
    y = jnp.clip(py, 0.0, H - 1.001)
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = x - ix
    fy = y - iy
    hit = (
        (1 - fx) * (1 - fy) * img[iy, ix]
        + fx * (1 - fy) * img[iy, ix + 1]
        + (1 - fx) * fy * img[iy + 1, ix]
        + fx * fy * img[iy + 1, ix + 1]
    )
    r = hit - (aff_a * color + aff_b)
    ar = jnp.abs(r)
    hw = jnp.where(ar < huber_th, 1.0, huber_th / jnp.maximum(ar, 1e-12))
    return jnp.sum(hw * r * r * (2.0 - hw), axis=-1)


@functools.partial(jax.jit, static_argnames=("settings",))
def trace_batch(
    u,
    v,
    idepth_min,
    idepth_max,
    color,
    weights,
    gradH,
    energy_th,
    quality,
    status,
    KRKi,
    Kt,
    aff,
    dI_target,
    settings: Settings = default_settings(),
) -> TraceResult:
    """Trace every point's epipolar interval onto the target image.

    Per-point variant: KRKi (N,3,3), Kt (N,3), aff (N,2) — every point may
    target the new frame from a different host keyframe. The discrete search
    gathers all N x S x 8 bilinear samples at once; XLA fuses the gather with
    the Huber energy and the argmin.

    u, v: (N,) host pixel coords; idepth_min/max: (N,) interval (max may be
    NaN/inf for fresh points); color/weights: (N,8); gradH: (N,2,2);
    energy_th, quality: (N,); status: (N,) previous status; dI_target:
    (H,W,3).
    """
    H, W = dI_target.shape[:2]
    w_f = float(W)
    h_f = float(H)
    max_pix_search = (w_f + h_f) * settings.max_pix_search
    # static step budget: numSteps = 1.9999 + dist/stepsize and dist is
    # clamped to maxPixSearch, so the reference's errors[100] cap only binds
    # for very large images (ImmaturePoint.cpp:260,634)
    S = min(
        settings.trace_max_steps,
        int(np.ceil(max_pix_search / settings.trace_stepsize)) + 3,
    )

    f32 = u.dtype

    def inb(x, y):
        return (x > 4.0) & (y > 4.0) & (x < w_f - 5.0) & (y < h_f - 5.0)

    # -- STEP 1: project interval endpoints (ImmaturePoint.cpp:489-566) --
    ones = jnp.ones_like(u)
    pr = jnp.einsum("nij,nj->ni", KRKi, jnp.stack([u, v, ones], -1))  # (N,3)
    ptp_min = pr + Kt * idepth_min[:, None]
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]
    oob_min = ~inb(u_min, v_min)

    finite_max = jnp.isfinite(idepth_max)
    id_max_safe = jnp.where(finite_max, idepth_max, 0.0)
    ptp_max = pr + Kt * id_max_safe[:, None]
    u_max_f = ptp_max[:, 0] / ptp_max[:, 2]
    v_max_f = ptp_max[:, 1] / ptp_max[:, 2]
    oob_max_f = finite_max & ~inb(u_max_f, v_max_f)
    dist_f = jnp.sqrt((u_min - u_max_f) ** 2 + (v_min - v_max_f) ** 2)
    skipped = finite_max & (dist_f < settings.trace_slack_interval)

    # infinite-max branch: direction from idepth=0.01 projection (:543-566)
    ptp_dir = pr + Kt * 0.01
    u_dir = ptp_dir[:, 0] / ptp_dir[:, 2]
    v_dir = ptp_dir[:, 1] / ptp_dir[:, 2]
    ddx = u_dir - u_min
    ddy = v_dir - v_min
    dnorm = 1.0 / jnp.sqrt(ddx * ddx + ddy * ddy + 1e-20)
    u_max_i = u_min + max_pix_search * ddx * dnorm
    v_max_i = v_min + max_pix_search * ddy * dnorm
    oob_max_i = (~finite_max) & ~inb(u_max_i, v_max_i)

    u_max = jnp.where(finite_max, u_max_f, u_max_i)
    v_max = jnp.where(finite_max, v_max_f, v_max_i)
    dist = jnp.where(finite_max, dist_f, max_pix_search)

    # scale-change gate (:574-581)
    oob_scale = ~((idepth_min < 0) | ((ptp_min[:, 2] > 0.75) & (ptp_min[:, 2] < 1.5)))

    # -- STEP 2: error bound from gradient-vs-epipolar angle (:585-606) --
    dx0 = settings.trace_stepsize * (u_max - u_min)
    dy0 = settings.trace_stepsize * (v_max - v_min)
    gxx = gradH[:, 0, 0]
    gxy = gradH[:, 0, 1]
    gyy = gradH[:, 1, 1]
    a = dx0 * dx0 * gxx + 2 * dx0 * dy0 * gxy + dy0 * dy0 * gyy
    b = dy0 * dy0 * gxx - 2 * dx0 * dy0 * gxy + dx0 * dx0 * gyy
    error_in_pixel = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-20)
    badcond = (
        error_in_pixel * settings.trace_min_improvement_factor > dist
    ) & finite_max
    error_in_pixel = jnp.minimum(error_in_pixel, 10.0)

    # -- STEP 3: discrete search (:610-693) --
    dx = dx0 / jnp.maximum(dist, 1e-20)
    dy = dy0 / jnp.maximum(dist, 1e-20)
    over = dist > max_pix_search
    u_max = jnp.where(over, u_min + max_pix_search * dx, u_max)
    v_max = jnp.where(over, v_min + max_pix_search * dy, v_max)
    dist = jnp.minimum(dist, max_pix_search)

    num_steps = jnp.minimum(
        (1.9999 + dist / settings.trace_stepsize).astype(jnp.int32), S - 1
    )
    oob_dxdy = ~(jnp.isfinite(dx) & jnp.isfinite(dy))

    # deterministic sub-pixel shift (:637-639)
    rand_shift = u_min * 1000.0 - jnp.floor(u_min * 1000.0)
    ptx = u_min - rand_shift * dx
    pty = v_min - rand_shift * dy

    # pattern rotated by the in-plane 2x2 of KRKi (:633-645)
    pat = jnp.asarray(PATTERN, dtype=f32)  # (8,2)
    rot_pat = jnp.einsum("nij,pj->npi", KRKi[:, :2, :2], pat)  # (N,8,2)

    aff_a = aff[:, 0]
    aff_b = aff[:, 1]
    n_gn = settings.trace_gn_iterations

    steps = jnp.arange(S, dtype=f32)  # (S,)
    sx = ptx[:, None] + steps[None, :] * dx[:, None]  # (N,S)
    sy = pty[:, None] + steps[None, :] * dy[:, None]
    px = sx[:, :, None] + rot_pat[:, None, :, 0]  # (N,S,8)
    py = sy[:, :, None] + rot_pat[:, None, :, 1]
    energies = _pattern_energy(
        dI_target,
        px,
        py,
        color[:, None, :],
        aff_a[:, None, None],
        aff_b[:, None, None],
        settings.huber_th,
    )  # (N,S)
    step_valid = steps[None, :] < num_steps[:, None].astype(f32)
    energies = jnp.where(step_valid, energies, jnp.inf)

    best_idx = jnp.argmin(energies, axis=1)
    best_energy_search = jnp.min(energies, axis=1)
    best_u0 = ptx + best_idx.astype(f32) * dx
    best_v0 = pty + best_idx.astype(f32) * dy

    # second best outside +-radius (:696-702)
    radius = settings.min_trace_test_radius
    idxs = jnp.arange(S)
    outside = jnp.abs(idxs[None, :] - best_idx[:, None]) > radius
    second_best = jnp.min(jnp.where(outside, energies, jnp.inf), axis=1)

    # -- STEP 4: 1-dof GN refinement along the epipolar line (:706-769) --
    best_energy = jnp.where(
        n_gn > 0, jnp.full_like(best_energy_search, 1e5), best_energy_search
    )

    def gn_body(_, carry):
        best_u, best_v, u_bak, v_bak, step_back, best_e, done = carry
        qx = best_u[:, None] + rot_pat[:, :, 0]
        qy = best_v[:, None] + rot_pat[:, :, 1]
        hit = bilinear(dI_target, qx, qy)  # (N,8,3)
        r = hit[..., 0] - (aff_a[:, None] * color + aff_b[:, None])
        d_res = dx[:, None] * hit[..., 1] + dy[:, None] * hit[..., 2]
        ar = jnp.abs(r)
        hw = jnp.where(
            ar < settings.huber_th,
            1.0,
            settings.huber_th / jnp.maximum(ar, 1e-12),
        )
        Hgn = 1.0 + jnp.sum(hw * d_res * d_res, axis=1)
        bgn = jnp.sum(hw * r * d_res, axis=1)
        energy = jnp.sum(weights * weights * hw * r * r * (2.0 - hw), axis=1)

        worse = energy > best_e
        # worse: halve the step and retreat from the backup point
        sb_worse = step_back * 0.5
        u_worse = u_bak + sb_worse * dx
        v_worse = v_bak + sb_worse * dy
        # better: take a clamped GN step from here
        step = jnp.clip(-bgn / Hgn, -0.5, 0.5)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        u_better = best_u + step * dx
        v_better = best_v + step * dy

        new_u = jnp.where(done, best_u, jnp.where(worse, u_worse, u_better))
        new_v = jnp.where(done, best_v, jnp.where(worse, v_worse, v_better))
        new_ubak = jnp.where(done | worse, u_bak, best_u)
        new_vbak = jnp.where(done | worse, v_bak, best_v)
        new_sb = jnp.where(done, step_back, jnp.where(worse, sb_worse, step))
        new_e = jnp.where(done | worse, best_e, energy)
        new_done = done | (jnp.abs(new_sb) < settings.trace_gn_threshold)
        return (new_u, new_v, new_ubak, new_vbak, new_sb, new_e, new_done)

    carry = (
        best_u0,
        best_v0,
        best_u0,
        best_v0,
        jnp.zeros_like(best_u0),
        best_energy,
        jnp.zeros_like(best_u0, dtype=bool),
    )
    best_u, best_v, _, _, _, best_energy, _ = jax.lax.fori_loop(
        0, n_gn, gn_body, carry
    )

    # quality updates ONLY for points that actually reach the discrete
    # search: the reference's traceOn early-returns for OOB/skipped/
    # badcondition/scale-gated points BEFORE the quality update
    # (ImmaturePoint.cpp:489-606 vs :696-702). Without this gate the
    # masked lanes corrupt their carried quality with ratios the reference
    # never computes (the num_steps>10 arm forces the update). Quality feeds
    # the activation candidate gate, so this was a real accuracy leak.
    reached_search = ~(
        (status == IPS_OOB)
        | oob_min
        | oob_max_f
        | oob_max_i
        | skipped
        | oob_scale
        | badcond
        | oob_dxdy
    )
    new_quality = second_best / jnp.maximum(best_energy_search, 1e-20)
    quality_out = jnp.where(
        reached_search & ((new_quality < quality) | (num_steps > 10)),
        new_quality,
        quality,
    )

    # energy-based outlier gate (:774-793)
    too_high = ~(best_energy < energy_th * settings.trace_extra_slack_on_th)
    # repeat-outlier -> OOB (:788-791)
    outlier_status = jnp.where(status == IPS_OUTLIER, IPS_OOB, IPS_OUTLIER)

    # -- STEP 5: interval update (:797-806) --
    horiz = dx * dx > dy * dy
    e = error_in_pixel

    def interval(coord, d, pr_c, kt_c):
        lo = (pr[:, 2] * (coord - e * d) - pr_c) / (
            kt_c - Kt[:, 2] * (coord - e * d)
        )
        hi = (pr[:, 2] * (coord + e * d) - pr_c) / (
            kt_c - Kt[:, 2] * (coord + e * d)
        )
        return lo, hi

    lo_u, hi_u = interval(best_u, dx, pr[:, 0], Kt[:, 0])
    lo_v, hi_v = interval(best_v, dy, pr[:, 1], Kt[:, 1])
    id_lo = jnp.where(horiz, lo_u, lo_v)
    id_hi = jnp.where(horiz, hi_u, hi_v)
    id_min_new = jnp.minimum(id_lo, id_hi)
    id_max_new = jnp.maximum(id_lo, id_hi)
    bad_interval = (
        ~jnp.isfinite(id_min_new) | ~jnp.isfinite(id_max_new) | (id_max_new < 0)
    )

    # -- status resolution: later `where`s override, so apply in REVERSE of the
    # reference's early-exit order (oob_min > oob_max > skipped > oob_scale >
    # badcond > oob_dxdy > outlier > bad_interval; ImmaturePoint.cpp:489-806) --
    frozen = status == IPS_OOB  # OOB points never trace again (:466-468)

    st = jnp.full_like(status, IPS_GOOD)
    st = jnp.where(bad_interval, IPS_OUTLIER, st)
    st = jnp.where(too_high, outlier_status, st)
    st = jnp.where(oob_dxdy, IPS_OOB, st)
    st = jnp.where(badcond, IPS_BADCONDITION, st)
    st = jnp.where(oob_scale, IPS_OOB, st)
    st = jnp.where(skipped, IPS_SKIPPED, st)
    st = jnp.where(oob_max_f | oob_max_i, IPS_OOB, st)
    st = jnp.where(oob_min, IPS_OOB, st)
    st = jnp.where(frozen, IPS_OOB, st)

    updated = (st == IPS_GOOD) & ~frozen
    out_min = jnp.where(updated, id_min_new, idepth_min)
    out_max = jnp.where(updated, id_max_new, idepth_max)

    # lastTraceUV: (-1,-1) unless GOOD (bestU/bestV) or SKIPPED/BADCOND (midpoint)
    mid_u = 0.5 * (u_min + u_max)
    mid_v = 0.5 * (v_min + v_max)
    last_u = jnp.where(
        st == IPS_GOOD,
        best_u,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), mid_u, -1.0),
    )
    last_v = jnp.where(
        st == IPS_GOOD,
        best_v,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), mid_v, -1.0),
    )
    pixel_interval = jnp.where(
        st == IPS_GOOD,
        2.0 * error_in_pixel,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), dist, 0.0),
    )
    quality_out = jnp.where(frozen, quality, quality_out)

    return TraceResult(
        status=st,
        idepth_min=out_min,
        idepth_max=out_max,
        last_uv=jnp.stack([last_u, last_v], axis=-1),
        pixel_interval=pixel_interval,
        quality=quality_out,
        best_energy=best_energy,
    )


@functools.partial(jax.jit, static_argnames=("settings",))
def trace(
    u,
    v,
    idepth_min,
    idepth_max,
    color,
    weights,
    gradH,
    energy_th,
    quality,
    status,
    KRKi,
    Kt,
    aff,
    dI_target,
    settings: Settings = default_settings(),
) -> TraceResult:
    """Single host->target trace: KRKi (3,3), Kt (3,), aff (2,) shared by all
    points. Thin wrapper over trace_batch."""
    N = u.shape[0]
    return trace_batch(
        u,
        v,
        idepth_min,
        idepth_max,
        color,
        weights,
        gradH,
        energy_th,
        quality,
        status,
        jnp.broadcast_to(KRKi, (N, 3, 3)),
        jnp.broadcast_to(Kt, (N, 3)),
        jnp.broadcast_to(aff, (N, 2)),
        dI_target,
        settings=settings,
    )


def _stereo_finish(
    u_stereo, u, v, u_min, u_max, dist, best_u, best_energy,
    best_energy_search, quality, quality_out, status, energy_th,
    error_in_pixel, ktx, bf, dirx, idepth_min_stereo, idepth_max_stereo,
    oob_min, oob_max, skipped, badcond, settings: Settings,
):
    """Shared trace_stereo tail: outlier gate, interval update, status
    machine, last-UV bookkeeping (ImmaturePoint.cpp:411-457)."""
    too_high = ~(best_energy < energy_th * settings.trace_extra_slack_on_th)
    outlier_status = jnp.where(status == IPS_OUTLIER, IPS_OOB, IPS_OUTLIER)

    # -- interval update: idepth = (bestU +- e - u) / ktx  (Kt_z = 0) --
    e = error_in_pixel
    id_a = (best_u - e * dirx - u) / ktx
    id_b = (best_u + e * dirx - u) / ktx
    id_min_new = jnp.minimum(id_a, id_b)
    id_max_new = jnp.maximum(id_a, id_b)
    bad_interval = (
        ~jnp.isfinite(id_min_new) | ~jnp.isfinite(id_max_new) | (id_max_new < 0)
    )

    frozen = status == IPS_OOB
    st = jnp.full_like(status, IPS_GOOD)
    st = jnp.where(bad_interval, IPS_OUTLIER, st)
    st = jnp.where(too_high, outlier_status, st)
    st = jnp.where(badcond, IPS_BADCONDITION, st)
    st = jnp.where(skipped, IPS_SKIPPED, st)
    st = jnp.where(oob_max, IPS_OOB, st)
    st = jnp.where(oob_min, IPS_OOB, st)
    st = jnp.where(frozen, IPS_OOB, st)

    updated = (st == IPS_GOOD) & ~frozen
    out_min = jnp.where(updated, id_min_new, idepth_min_stereo)
    out_max = jnp.where(updated, id_max_new, idepth_max_stereo)

    mid_u = 0.5 * (u_min + u_max)
    last_u = jnp.where(
        st == IPS_GOOD,
        best_u,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), mid_u, -1.0),
    )
    last_v = jnp.where(
        st == IPS_GOOD,
        v,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), v, -1.0),
    )
    pixel_interval = jnp.where(
        st == IPS_GOOD,
        2.0 * error_in_pixel,
        jnp.where((st == IPS_SKIPPED) | (st == IPS_BADCONDITION), dist, 0.0),
    )
    quality_out = jnp.where(frozen, quality, quality_out)

    res = TraceResult(
        status=st,
        idepth_min=out_min,
        idepth_max=out_max,
        last_uv=jnp.stack([last_u, last_v], axis=-1),
        pixel_interval=pixel_interval,
        quality=quality_out,
        best_energy=best_energy,
    )
    idepth_stereo = (u_stereo - res.last_uv[:, 0]) / bf
    return res, idepth_stereo


@functools.partial(
    jax.jit, static_argnames=("settings", "mode_right")
)
def trace_stereo(
    u_stereo,
    v_stereo,
    idepth_min_stereo,
    idepth_max_stereo,
    color,
    weights,
    gradH,
    energy_th,
    quality,
    status,
    K,
    baseline,
    dI_target,
    mode_right: bool = True,
    settings: Settings = default_settings(),
):
    """Static stereo trace (ImmaturePoint.cpp:94-457), strip-optimized.

    mode_right=True matches left->right (bl = (-baseline,0,0)); False is the
    reverse check. Affine is fixed to (1,0) (:113-115). Returns
    (TraceResult, idepth_stereo) with idepth_stereo = (u_stereo-bestU)/bf
    (:448), valid where status==GOOD.

    Stereo specialization: with KRK^-1 = I and Kt = (+-fx*b, 0, 0) the epipolar
    line is exactly horizontal (Kt_z = 0, so the projective division is
    trivial), the search direction is +-1 px/step, and all samples of the
    discrete search share one fractional offset per point. The search
    therefore reads per-point contiguous row strips (ONE coalesced
    dynamic-slice gather) and computes every step's 8-pattern Huber energy
    with static shifted slices — no per-sample gathers. This replaces the
    reference's per-point scalar loop (and the generic gather kernel) on the
    hot static-stereo path; only the tiny <=3-iteration GN refinement uses
    point-gathers.
    """
    H, W = dI_target.shape[:2]
    f32 = u_stereo.dtype
    w_f, h_f = float(W), float(H)
    max_pix_search = (w_f + h_f) * settings.max_pix_search
    # static step budget: numSteps = 1.9999 + dist <= 2 + maxPixSearch
    S = min(settings.trace_max_steps, int(np.ceil(max_pix_search)) + 3)
    SW = S + 8  # strip width: K0 margin (4) + pattern halo (2+1) + lerp (1)

    sign = -1.0 if mode_right else 1.0
    ktx = sign * K[0, 0] * baseline  # Kt = K @ (sign*b, 0, 0)
    bf = K[0, 0] * baseline * (1.0 if mode_right else -1.0)  # -K00*bl_x
    dirx = -1.0 if mode_right else 1.0  # sign(ktx): search direction, static

    u = u_stereo.astype(f32)
    v = v_stereo.astype(f32)
    n = u.shape[0]

    def inb(x, y):
        return (x > 4.0) & (y > 4.0) & (x < w_f - 5.0) & (y < h_f - 5.0)

    # -- interval endpoints (pr = (u, v, 1); ptp_z = 1 identically) --
    u_min = u + ktx * idepth_min_stereo
    oob_min = ~inb(u_min, v)

    finite_max = jnp.isfinite(idepth_max_stereo)
    id_max_safe = jnp.where(finite_max, idepth_max_stereo, 0.0)
    u_max_f = u + ktx * id_max_safe
    oob_max_f = finite_max & ~inb(u_max_f, v)
    dist_f = jnp.abs(u_min - u_max_f)
    skipped = finite_max & (dist_f < settings.trace_slack_interval)

    u_max_i = u_min + max_pix_search * dirx
    oob_max_i = (~finite_max) & ~inb(u_max_i, v)
    u_max = jnp.where(finite_max, u_max_f, u_max_i)
    dist = jnp.where(finite_max, dist_f, max_pix_search)
    # scale gate (:195-200): ptp_min_z == 1 in (0.75, 1.5) — always passes.

    # -- error bound: dy0 = 0, so a = dx0^2*gxx, b = dx0^2*gyy --
    gxx = gradH[:, 0, 0]
    gyy = gradH[:, 1, 1]
    error_in_pixel = 0.2 + 0.2 * (gxx + gyy) / jnp.maximum(gxx, 1e-20)
    badcond = (
        error_in_pixel * settings.trace_min_improvement_factor > dist
    ) & finite_max
    error_in_pixel = jnp.minimum(error_in_pixel, 10.0)

    over = dist > max_pix_search
    u_max = jnp.where(over, u_min + max_pix_search * dirx, u_max)
    dist = jnp.minimum(dist, max_pix_search)
    num_steps = jnp.minimum(
        (1.9999 + dist / settings.trace_stepsize).astype(jnp.int32), S - 1
    )

    rand_shift = u_min * 1000.0 - jnp.floor(u_min * 1000.0)
    ptx = u_min - rand_shift * dirx  # pty = v
    n_gn = settings.trace_gn_iterations

    # -- strip extraction: ONE contiguous gather per point --
    PADX, PADY = SW, 8
    img = jnp.pad(dI_target[..., 0], ((PADY, PADY), (PADX, PADX)))
    ptx_f = jnp.floor(ptx)
    v_f = jnp.floor(v)
    fu = ptx - ptx_f
    fv = v - v_f
    if dirx > 0:
        K0 = 4  # strip col of floor(ptx)
    else:
        K0 = SW - 5
    x0 = ptx_f.astype(jnp.int32) - K0 + PADX
    y0 = v_f.astype(jnp.int32) - 2 + PADY  # rows floor(v)-2 .. floor(v)+3

    # one XLA gather for all strips, not a vmapped dynamic_slice per point
    strip = img[
        (y0[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :])[:, :, None],
        (x0[:, None] + jnp.arange(SW, dtype=jnp.int32)[None, :])[:, None, :],
    ]  # (N, 6, SW)
    # vertical lerp -> rows at pattern dy in {-2..2}: (N, 5, SW)
    rows = (1.0 - fv[:, None, None]) * strip[:, :-1, :] + fv[:, None, None] * strip[
        :, 1:, :
    ]

    # -- discrete search: static shifted slices per pattern pixel --
    pat = PATTERN  # numpy (8, 2) ints; rotation is identity here
    huber = settings.huber_th
    energies = jnp.zeros((n, S), dtype=f32)
    for p in range(pat.shape[0]):
        dxp, dyp = int(pat[p, 0]), int(pat[p, 1])
        row = rows[:, dyp + 2, :]  # (N, SW)
        if dirx > 0:
            seg0 = jax.lax.slice_in_dim(row, K0 + dxp, K0 + dxp + S, axis=1)
            seg1 = jax.lax.slice_in_dim(row, K0 + dxp + 1, K0 + dxp + S + 1, axis=1)
        else:
            s0 = jax.lax.slice_in_dim(row, K0 + dxp - (S - 1), K0 + dxp + 1, axis=1)
            s1 = jax.lax.slice_in_dim(row, K0 + dxp + 1 - (S - 1), K0 + dxp + 2, axis=1)
            seg0 = s0[:, ::-1]
            seg1 = s1[:, ::-1]
        val = (1.0 - fu[:, None]) * seg0 + fu[:, None] * seg1  # (N, S)
        r = val - color[:, p : p + 1]
        ar = jnp.abs(r)
        hw = jnp.where(ar < huber, 1.0, huber / jnp.maximum(ar, 1e-12))
        energies = energies + hw * r * r * (2.0 - hw)

    steps = jnp.arange(S, dtype=f32)
    step_valid = steps[None, :] < num_steps[:, None].astype(f32)
    energies = jnp.where(step_valid, energies, jnp.inf)

    best_idx = jnp.argmin(energies, axis=1)
    best_energy_search = jnp.min(energies, axis=1)
    best_u0 = ptx + best_idx.astype(f32) * dirx
    best_v0 = v

    radius = settings.min_trace_test_radius
    idxs = jnp.arange(S)
    outside = jnp.abs(idxs[None, :] - best_idx[:, None]) > radius
    second_best = jnp.min(jnp.where(outside, energies, jnp.inf), axis=1)
    reached_search = ~(
        oob_min | oob_max_f | oob_max_i | skipped | badcond
        | (status == IPS_OOB)
    )
    new_quality = second_best / jnp.maximum(best_energy_search, 1e-20)
    quality_out = jnp.where(
        reached_search & ((new_quality < quality) | (num_steps > 10)),
        new_quality,
        quality,
    )

    # -- GN refinement along the row (few samples: generic bilinear is fine) --
    best_energy = jnp.where(
        n_gn > 0, jnp.full_like(best_energy_search, 1e5), best_energy_search
    )
    patx = jnp.asarray(pat[:, 0], dtype=f32)
    paty = jnp.asarray(pat[:, 1], dtype=f32)

    def gn_body(_, carry):
        best_u, u_bak, step_back, best_e, done = carry
        qx = best_u[:, None] + patx[None, :]
        qy = v[:, None] + paty[None, :]
        hit = bilinear(dI_target, qx, qy)
        r = hit[..., 0] - color
        d_res = dirx * hit[..., 1]
        ar = jnp.abs(r)
        hw = jnp.where(ar < huber, 1.0, huber / jnp.maximum(ar, 1e-12))
        Hgn = 1.0 + jnp.sum(hw * d_res * d_res, axis=1)
        bgn = jnp.sum(hw * r * d_res, axis=1)
        energy = jnp.sum(weights * weights * hw * r * r * (2.0 - hw), axis=1)

        worse = energy > best_e
        sb_worse = step_back * 0.5
        u_worse = u_bak + sb_worse * dirx
        step = jnp.clip(-bgn / Hgn, -0.5, 0.5)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        u_better = best_u + step * dirx

        new_u = jnp.where(done, best_u, jnp.where(worse, u_worse, u_better))
        new_ubak = jnp.where(done | worse, u_bak, best_u)
        new_sb = jnp.where(done, step_back, jnp.where(worse, sb_worse, step))
        new_e = jnp.where(done | worse, best_e, energy)
        new_done = done | (jnp.abs(new_sb) < settings.trace_gn_threshold)
        return (new_u, new_ubak, new_sb, new_e, new_done)

    carry = (
        best_u0,
        best_u0,
        jnp.zeros_like(best_u0),
        best_energy,
        jnp.zeros_like(best_u0, dtype=bool),
    )
    best_u, _, _, best_energy, _ = jax.lax.fori_loop(0, n_gn, gn_body, carry)

    return _stereo_finish(
        u_stereo, u, v, u_min, u_max, dist, best_u, best_energy,
        best_energy_search, quality, quality_out, status, energy_th,
        error_in_pixel, ktx, bf, dirx,
        idepth_min_stereo, idepth_max_stereo,
        oob_min, oob_max_f | oob_max_i, skipped, badcond, settings,
    )
