"""Batched point-frame residual linearization — the atomic unit of the BA.

JAX rebuild of PointFrameResidual::linearize (Residuals.cpp:83-335)
over the whole [NP points x F target frames] residual cube at once: one
host-point -> target-frame photometric residual over the 8-pixel pattern, with
the factored first-estimate Jacobian layout of RawResidualJacobian.h:32-65:

  geometry rows  Jpdxi [2x6], Jpdc [2x4], Jpdd [2x1]   (at the FEJ point)
  image columns  JIdx [8x2] = huber-weighted image gradients
  photometric    JabF [8x2]
  resF [8]       huber-weighted residuals

Gradient-dependent weights + Huber, OOB/outlier state machine
(Residuals.cpp:325-335), centerProjectedTo side channel. The reference's
per-residual scalar loop (and its g2o edge twin, dso_g2o_edge.cpp:5-282)
becomes a single jitted program with fused patch gathers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.config import (
    PATTERN,
    SCALE_C,
    SCALE_F,
    SCALE_IDEPTH,
    Settings,
    default_settings,
)
from stereo_dso_g2o_tpu.backend import window as W


class LinearizeOut(NamedTuple):
    new_state: jax.Array  # (NP, F) int32
    energy: jax.Array  # (NP, F) state_NewEnergy
    energy_wo: jax.Array  # (NP, F) state_NewEnergyWithOutlier (-1 if not eval)
    center: jax.Array  # (NP, F, 3)
    resF: jax.Array  # (NP, F, 8)
    Jpdxi: jax.Array  # (NP, F, 2, 6)
    Jpdc: jax.Array  # (NP, F, 2, 4)
    Jpdd: jax.Array  # (NP, F, 2)
    JIdx: jax.Array  # (NP, F, 2, 8)
    JabF: jax.Array  # (NP, F, 2, 8)


def _bilinear3_frames(dI_stack, f_idx, x, y):
    """Bilinear (I, gx, gy) sample from stacked frames.

    dI_stack: (F, H, W, 3); f_idx: (...,) int32; x, y: (...,).
    The 2x2x3 neighbourhood of every sample comes back as ONE XLA gather
    (broadcast advanced indexing, not a vmapped dynamic_slice).
    """
    F, H, Wd = dI_stack.shape[:3]
    x = jnp.clip(x, 0.0, Wd - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = (x - ix)[..., None]
    fy = (y - iy)[..., None]
    fi = jnp.broadcast_to(f_idx, x.shape).astype(jnp.int32)
    d2 = jnp.arange(2, dtype=jnp.int32)
    p = dI_stack[
        fi[..., None, None],
        iy[..., None, None] + d2[:, None],
        ix[..., None, None] + d2[None, :],
    ]  # (..., 2, 2, 3)
    top = (1 - fx) * p[..., 0, 0, :] + fx * p[..., 0, 1, :]
    bot = (1 - fx) * p[..., 1, 0, :] + fx * p[..., 1, 1, :]
    return (1 - fy) * top + fy * bot


@functools.partial(jax.jit, static_argnames=("settings",))
def linearize(
    win: W.Window,
    dI_stack: jax.Array,  # (F, H, W, 3) level-0 pyramids of all window frames
    settings: Settings = default_settings(),
) -> LinearizeOut:
    F = win.F
    NP = win.NP
    Wd = dI_stack.shape[2]
    Hd = dI_stack.shape[1]
    wM3 = float(Wd - 3)
    hM3 = float(Hd - 3)

    pre = W.precalc(win)
    h = win.pt_host  # (NP,)
    tgt = jnp.arange(F, dtype=jnp.int32)  # target axis

    # gather per-residual precalc: index [host, target]
    def ht(x):
        return x[h][:, tgt]  # (NP, F, ...)

    RTll_0 = pre["RTll_0"][h]  # (NP, F, 3, 3)
    tTll_0 = pre["tTll_0"][h]
    KRKi = pre["KRKi"][h]
    Kt = pre["Kt"][h]
    aff = pre["aff"][h]  # (NP, F, 2)
    b0 = pre["b0"][h]  # (NP,)

    fx, fy, cx, cy = (win.c_value[i] for i in range(4))
    fxi = 1.0 / fx
    fyi = 1.0 / fy

    u = win.pt_u
    v = win.pt_v
    id_zero = win.pt_idepth_zero * SCALE_IDEPTH  # idepth_zero_scaled
    id_cur = win.pt_idepth * SCALE_IDEPTH  # idepth_scaled
    color = win.pt_color  # (NP, 8)
    weights = win.pt_weights

    # ---- center projection at the FEJ point (projectPoint long form,
    # ResidualProjections.h:64-96) ----
    KliP = jnp.stack(
        [(u - cx) * fxi, (v - cy) * fyi, jnp.ones_like(u)], -1
    )  # (NP, 3)
    ptp = jnp.einsum("nfij,nj->nfi", RTll_0, KliP) + tTll_0 * id_zero[:, None, None]
    drescale = 1.0 / ptp[..., 2]
    new_idepth = id_zero[:, None] * drescale
    uC = ptp[..., 0] * drescale
    vC = ptp[..., 1] * drescale
    Ku = uC * fx + cx
    Kv = vC * fy + cy
    center_ok = (
        (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < wM3) & (Kv < hM3)
    )
    center = jnp.stack([Ku, Kv, new_idepth], -1)

    # ---- geometric Jacobians at FEJ (Residuals.cpp:133-186) ----
    t0x, t0y, t0z = tTll_0[..., 0], tTll_0[..., 1], tTll_0[..., 2]
    d_d_x = drescale * (t0x - t0z * uC) * SCALE_IDEPTH * fx
    d_d_y = drescale * (t0y - t0z * vC) * SCALE_IDEPTH * fy

    R = RTll_0
    dCx2 = drescale * (R[..., 2, 0] * uC - R[..., 0, 0])
    dCx3 = fx * drescale * (R[..., 2, 1] * uC - R[..., 0, 1]) * fyi
    dCx0 = KliP[:, None, 0] * dCx2
    dCx1 = KliP[:, None, 1] * dCx3
    dCy2 = fy * drescale * (R[..., 2, 0] * vC - R[..., 1, 0]) * fxi
    dCy3 = drescale * (R[..., 2, 1] * vC - R[..., 1, 1])
    dCy0 = KliP[:, None, 0] * dCy2
    dCy1 = KliP[:, None, 1] * dCy3

    dCx0 = (dCx0 + uC) * SCALE_F
    dCx1 = dCx1 * SCALE_F
    dCx2 = (dCx2 + 1.0) * SCALE_C
    dCx3 = dCx3 * SCALE_C
    dCy0 = dCy0 * SCALE_F
    dCy1 = (dCy1 + vC) * SCALE_F
    dCy2 = dCy2 * SCALE_C
    dCy3 = (dCy3 + 1.0) * SCALE_C
    Jpdc = jnp.stack(
        [
            jnp.stack([dCx0, dCx1, dCx2, dCx3], -1),
            jnp.stack([dCy0, dCy1, dCy2, dCy3], -1),
        ],
        axis=-2,
    )  # (NP, F, 2, 4)

    zero = jnp.zeros_like(uC)
    Jx = jnp.stack(
        [
            new_idepth * fx,
            zero,
            -new_idepth * uC * fx,
            -uC * vC * fx,
            (1 + uC * uC) * fx,
            -vC * fx,
        ],
        -1,
    )
    Jy = jnp.stack(
        [
            zero,
            new_idepth * fy,
            -new_idepth * vC * fy,
            -(1 + vC * vC) * fy,
            uC * vC * fy,
            uC * fy,
        ],
        -1,
    )
    Jpdxi = jnp.stack([Jx, Jy], axis=-2)  # (NP, F, 2, 6)
    Jpdd = jnp.stack([d_d_x, d_d_y], -1)  # (NP, F, 2)

    # ---- pattern residuals at the CURRENT state (Residuals.cpp:213-302) ----
    pat = jnp.asarray(PATTERN, dtype=u.dtype)  # (8, 2)
    pu = u[:, None] + pat[None, :, 0]  # (NP, 8)
    pv = v[:, None] + pat[None, :, 1]
    P3 = jnp.stack([pu, pv, jnp.ones_like(pu)], -1)  # (NP, 8, 3)
    ptp8 = (
        jnp.einsum("nfij,npj->nfpi", KRKi, P3)
        + Kt[:, :, None, :] * id_cur[:, None, None, None]
    )  # (NP, F, 8, 3)
    Ku8 = ptp8[..., 0] / ptp8[..., 2]
    Kv8 = ptp8[..., 1] / ptp8[..., 2]
    pat_ok = (Ku8 > 1.1) & (Kv8 > 1.1) & (Ku8 < wM3) & (Kv8 < hM3)
    all_pat_ok = jnp.all(pat_ok, axis=-1)

    f_idx = jnp.broadcast_to(tgt[None, :, None], Ku8.shape)
    hit = _bilinear3_frames(dI_stack, f_idx, Ku8, Kv8)  # (NP, F, 8, 3)
    hitI = hit[..., 0]
    gx = hit[..., 1]
    gy = hit[..., 2]

    residual = hitI - (aff[..., 0:1] * color[:, None, :] + aff[..., 1:2])
    drdA = color[:, None, :] - b0[:, None, None]  # (NP, F, 8)

    g2 = gx * gx + gy * gy
    c2 = settings.outlier_th_sum_component
    w_grad = jnp.sqrt(c2 / (c2 + g2))
    w = 0.5 * (w_grad + weights[:, None, :])

    ar = jnp.abs(residual)
    hw0 = jnp.where(
        ar < settings.huber_th, 1.0, settings.huber_th / jnp.maximum(ar, 1e-12)
    )
    energy_terms = w * w * hw0 * residual * residual * (2.0 - hw0)
    energy_left = jnp.sum(energy_terms, axis=-1)  # (NP, F)

    hw = jnp.where(hw0 < 1.0, jnp.sqrt(hw0), hw0) * w
    resF = residual * hw
    JIdx = jnp.stack([gx * hw, gy * hw], axis=-2)  # (NP, F, 2, 8)
    JabF = jnp.stack(
        [drdA * hw, hw], axis=-2
    )  # (NP, F, 2, 8)
    if settings.affine_opt_mode_a < 0:
        JabF = JabF.at[..., 0, :].set(0.0)
    if settings.affine_opt_mode_b < 0:
        JabF = JabF.at[..., 1, :].set(0.0)

    wJI2_sum = jnp.sum(hw * hw * (gx * gx + gy * gy), axis=-1)

    # ---- state machine (Residuals.cpp:304-335) ----
    prev_oob = win.res_state == W.RES_OOB
    proj_fail = ~(center_ok & all_pat_ok)

    fe_th = jnp.maximum(
        win.frame_energy_th[h][:, None], win.frame_energy_th[None, :]
    )  # max(host, target)
    outlier = (energy_left > fe_th) | (wJI2_sum < 2.0)
    energy_new = jnp.where(outlier, fe_th, energy_left)

    new_state = jnp.full((NP, F), W.RES_IN, jnp.int32)
    new_state = jnp.where(outlier, W.RES_OUTLIER, new_state)
    new_state = jnp.where(proj_fail, W.RES_OOB, new_state)
    new_state = jnp.where(prev_oob, W.RES_OOB, new_state)

    # on OOB (incl. early-outs) energy stays at the previous value (:88, :126)
    keep_old = prev_oob | proj_fail
    energy_out = jnp.where(keep_old, win.res_energy, energy_new)
    energy_wo = jnp.where(keep_old, -1.0, energy_left)

    return LinearizeOut(
        new_state=new_state,
        energy=energy_out,
        energy_wo=energy_wo,
        center=center,
        resF=resF,
        Jpdxi=Jpdxi,
        Jpdc=Jpdc,
        Jpdd=Jpdd,
        JIdx=JIdx,
        JabF=JabF,
    )


def apply_res(win: W.Window, lin: LinearizeOut, active_mask) -> W.Window:
    """PointFrameResidual::applyRes(copyJacobians=true) (Residuals.cpp:367-):
    copy Jacobians for residuals whose new state is IN, advance the state
    machine. active_mask selects which cube entries were (re)linearized."""
    upd = active_mask & win.res_exists
    take = upd & (lin.new_state == W.RES_IN) & (win.res_state != W.RES_OOB)

    def cp(old, new):
        m = take
        extra = new.ndim - m.ndim
        if extra:
            m = m.reshape(m.shape + (1,) * extra)
        return jnp.where(m, new, old)

    return win.replace(
        J_resF=cp(win.J_resF, lin.resF),
        J_pdxi=cp(win.J_pdxi, lin.Jpdxi),
        J_pdc=cp(win.J_pdc, lin.Jpdc),
        J_pdd=cp(win.J_pdd, lin.Jpdd),
        J_Idx=cp(win.J_Idx, lin.JIdx),
        J_abF=cp(win.J_abF, lin.JabF),
        res_center=cp(win.res_center, lin.center),
        res_state=jnp.where(
            upd & (win.res_state != W.RES_OOB), lin.new_state, win.res_state
        ),
        res_energy=jnp.where(upd, lin.energy, win.res_energy),
        res_new_energy_wo=jnp.where(upd, lin.energy_wo, win.res_new_energy_wo),
    )
