"""The sliding-window optimization state as one device-resident pytree.

Replaces the reference's pointer graph (FrameHessian/PointHessian/
PointFrameResidual + the EFFrame/EFPoint/EFResidual mirror,
HessianBlocks.{h,cpp} + EnergyFunctionalStructs.{h,cpp}) with fixed-capacity
structure-of-arrays + masks:

- F = window_cap frame slots. A slot holds one keyframe's 8-dof state
  (FEJ pose `evalPT`, preconditioned delta `state` = [xi(6), a, b] with
  worldToCam = exp(SCALE*state[:6]) * evalPT, HessianBlocks.h:164-186),
  plus exposure, priors and the per-frame energy threshold.
- NP point slots across the whole window, each with a host-slot index
  (PointHessian: u, v, 1-dof inverse depth + FEJ value, 8-pattern colors).
- A dense [NP, F] residual cube: point x target-frame. res_exists marks
  created residuals (host != target and created by the frontend);
  res_state carries the IN/OOB/OUTLIER machine (Residuals.h:49).
- The dense marginalization prior HM/bM over the full (CPARS + 8F) state,
  indexed by slot (the reference compacts/permutes HM on frame removal,
  EnergyFunctional.cpp:554-660; with fixed slots the Schur elimination is
  permutation-free and freed slots are simply zeroed).

State/scale conventions follow HessianBlocks.h:54-70 and util/NumType.h.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.config import (
    CPARS,
    SCALE_A,
    SCALE_B,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    Settings,
)
from stereo_dso_g2o_tpu.utils import se3
from stereo_dso_g2o_tpu.utils.pytree import dataclass

# point status (PointHessian::PtStatus, HessianBlocks.h:374+)
PT_INACTIVE = 0
PT_ACTIVE = 1
PT_MARGINALIZE = 2  # flagged: will be folded into HM/bM
PT_DROP = 3  # flagged: removed without marginalization

# residual states (Residuals.h:49: ResState IN/OOB/OUTLIER)
RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2

import numpy as _np

STATE_SCALE = _np.asarray(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
    dtype=_np.float32,
)


@dataclass
class Window:
    # -- frames --
    frame_valid: jax.Array  # (F,) bool
    evalPT: jax.Array  # (F, 4, 4) worldToCam at the FEJ point
    state: jax.Array  # (F, 8) preconditioned [xi(6), a, b]
    state_zero: jax.Array  # (F, 8) FEJ state (pose part == 0)
    prior: jax.Array  # (F, 8) diagonal prior Hessian
    ab_exposure: jax.Array  # (F,)
    frame_energy_th: jax.Array  # (F,)
    frame_id: jax.Array  # (F,) int32 keyframe id (-1 = empty)

    # -- camera intrinsics (CalibHessian value/value_zero) --
    c_value: jax.Array  # (4,) fx fy cx cy
    c_zero: jax.Array  # (4,)

    # -- points --
    pt_status: jax.Array  # (NP,) int32
    pt_host: jax.Array  # (NP,) int32 host frame slot
    pt_u: jax.Array  # (NP,)
    pt_v: jax.Array  # (NP,)
    pt_idepth: jax.Array  # (NP,)
    pt_idepth_zero: jax.Array  # (NP,)
    pt_color: jax.Array  # (NP, 8)
    pt_weights: jax.Array  # (NP, 8)
    pt_has_prior: jax.Array  # (NP,) bool (idepth prior from initialization)
    pt_energy_th: jax.Array  # (NP,)
    pt_num_good_res: jax.Array  # (NP,) int32
    pt_max_rel_baseline: jax.Array  # (NP,)
    pt_idepth_hessian: jax.Array  # (NP,)

    # -- residual cube [NP, F] --
    res_exists: jax.Array  # (NP, F) bool
    res_state: jax.Array  # (NP, F) int32
    res_energy: jax.Array  # (NP, F)
    res_linearized: jax.Array  # (NP, F) bool
    res_to_zero: jax.Array  # (NP, F, 8) res_toZeroF
    res_new_state: jax.Array  # (NP, F) int32 (state_NewState scratch)
    res_new_energy_wo: jax.Array  # (NP, F) state_NewEnergyWithOutlier
    res_center: jax.Array  # (NP, F, 3) centerProjectedTo (Ku, Kv, new_idepth)

    # -- accepted Jacobians (written by apply_res) --
    J_resF: jax.Array  # (NP, F, 8)
    J_pdxi: jax.Array  # (NP, F, 2, 6)
    J_pdc: jax.Array  # (NP, F, 2, 4)
    J_pdd: jax.Array  # (NP, F, 2)
    J_Idx: jax.Array  # (NP, F, 2, 8)
    J_abF: jax.Array  # (NP, F, 2, 8)

    # -- marginalization prior --
    HM: jax.Array  # (D, D), D = CPARS + 8F
    bM: jax.Array  # (D,)

    @property
    def F(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def NP(self) -> int:
        return self.pt_status.shape[0]

    # -- derived state (HessianBlocks.h:164-186) --
    def state_scaled(self):
        return self.state * STATE_SCALE[None, :]

    def w2c(self):
        """PRE_worldToCam = exp(state_scaled[:6]) * evalPT."""
        return se3.se3_exp(self.state_scaled()[:, :6]) @ self.evalPT

    def aff_g2l(self):
        return self.state_scaled()[:, 6:8]

    def aff_g2l_0(self):
        """FEJ affine params (HessianBlocks.h:158)."""
        return self.state_zero[:, 6:8] * STATE_SCALE[None, 6:8]


def empty_window(F: int, NP: int, c_value, dtype=jnp.float32) -> Window:
    D = CPARS + 8 * F
    z = jnp.zeros
    return Window(
        frame_valid=z((F,), bool),
        evalPT=jnp.broadcast_to(jnp.eye(4, dtype=dtype), (F, 4, 4)),
        state=z((F, 8), dtype),
        state_zero=z((F, 8), dtype),
        prior=z((F, 8), dtype),
        ab_exposure=jnp.ones((F,), dtype),
        frame_energy_th=jnp.full((F,), 8 * 12.0 * 12.0, dtype),
        frame_id=jnp.full((F,), -1, jnp.int32),
        c_value=jnp.asarray(c_value, dtype),
        c_zero=jnp.asarray(c_value, dtype),
        pt_status=z((NP,), jnp.int32),
        pt_host=z((NP,), jnp.int32),
        pt_u=z((NP,), dtype),
        pt_v=z((NP,), dtype),
        pt_idepth=z((NP,), dtype),
        pt_idepth_zero=z((NP,), dtype),
        pt_color=z((NP, 8), dtype),
        pt_weights=z((NP, 8), dtype),
        pt_has_prior=z((NP,), bool),
        pt_energy_th=z((NP,), dtype),
        pt_num_good_res=z((NP,), jnp.int32),
        pt_max_rel_baseline=z((NP,), dtype),
        pt_idepth_hessian=z((NP,), dtype),
        res_exists=z((NP, F), bool),
        res_state=z((NP, F), jnp.int32),
        res_energy=z((NP, F), dtype),
        res_linearized=z((NP, F), bool),
        res_to_zero=z((NP, F, 8), dtype),
        res_new_state=z((NP, F), jnp.int32),
        res_new_energy_wo=z((NP, F), dtype),
        res_center=z((NP, F, 3), dtype),
        J_resF=z((NP, F, 8), dtype),
        J_pdxi=z((NP, F, 2, 6), dtype),
        J_pdc=z((NP, F, 2, 4), dtype),
        J_pdd=z((NP, F, 2), dtype),
        J_Idx=z((NP, F, 2, 8), dtype),
        J_abF=z((NP, F, 2, 8), dtype),
        HM=z((D, D), dtype),
        bM=z((D,), dtype),
    )


def aff_transfer(exp_h, exp_t, aff_h, aff_t):
    """AffLight::fromToVecExposure (util/NumType.h:159-170), batched."""
    a = jnp.exp(aff_t[..., 0] - aff_h[..., 0]) * exp_t / exp_h
    b = aff_t[..., 1] - a * aff_h[..., 1]
    return jnp.stack([a, b], axis=-1)


def precalc(win: Window):
    """FrameFramePrecalc::set for every (host, target) pair
    (HessianBlocks.cpp:206-242). Returns dict of (F, F, ...) arrays."""
    w2c = win.w2c()  # (F,4,4) current
    ev = win.evalPT  # FEJ
    c2w = se3.inverse(w2c)
    ev_inv = se3.inverse(ev)

    # T_th = T_t_w * T_w_h, at FEJ and at current state
    T0 = jnp.einsum("tij,hjk->thik", ev, ev_inv)  # FEJ (leftToLeft_0)
    T = jnp.einsum("tij,hjk->thik", w2c, c2w)  # current

    fx, fy, cx, cy = (win.c_value[i] for i in range(4))
    K = jnp.array(
        [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], dtype=win.c_value.dtype
    )
    K = K.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx).at[1, 2].set(cy)
    Ki = jnp.linalg.inv(K)

    R = T[..., :3, :3]
    t = T[..., :3, 3]
    R0 = jnp.swapaxes(T0[..., :3, :3], 0, 1)  # index [h,t]
    t0 = jnp.swapaxes(T0[..., :3, 3], 0, 1)
    R = jnp.swapaxes(R, 0, 1)
    t = jnp.swapaxes(t, 0, 1)

    aff = win.aff_g2l()
    aff_ht = aff_transfer(
        win.ab_exposure[:, None],
        win.ab_exposure[None, :],
        aff[:, None, :],
        aff[None, :, :],
    )  # (h, t, 2)
    b0 = win.state_zero[:, 7] * SCALE_B  # host aff_g2l_0 b

    return dict(
        RTll_0=R0,  # (F,F,3,3) [host, target]
        tTll_0=t0,  # (F,F,3)
        KRKi=jnp.einsum("ij,htjk,kl->htil", K, R, Ki),
        Kt=jnp.einsum("ij,htj->hti", K, t),
        RTll=R,
        tTll=t,
        aff=aff_ht,  # (F,F,2) PRE_aff_mode
        b0=b0,  # (F,) PRE_b0_mode (host's)
        K=K,
        Ki=Ki,
    )
