"""Host-side window construction/bookkeeping (the FullSystem's insert ops).

Functional .at[] updates of the Window pytree corresponding to
EnergyFunctional::insertFrame/insertPoint/insertResidual
(EnergyFunctional.cpp:445-522) and FrameHessian::setEvalPT_scaled
(HessianBlocks.h:205-221). These run between jitted pipeline stages; each is
O(slots touched) and cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.config import SCALE_A, SCALE_B
from stereo_dso_g2o_tpu.utils import se3


def insert_frame(
    win: W.Window,
    slot: int,
    T_w2c,
    aff,
    exposure: float,
    frame_id: int,
    energy_th: float = 8 * 12.0 * 12.0,
) -> W.Window:
    """Insert a keyframe at `slot` with FEJ pose = T_w2c and given affine.

    Mirrors setEvalPT_scaled: state pose part zero, ab part set, state_zero =
    state (HessianBlocks.h:205-221). The FEJ pose is projected onto SE(3):
    every later keyframe's pose is composed from this one.
    """
    T_w2c = se3.orthonormalize(jnp.asarray(T_w2c, win.evalPT.dtype))
    state = jnp.zeros(8, dtype=win.state.dtype)
    state = state.at[6].set(aff[0] / SCALE_A).at[7].set(aff[1] / SCALE_B)
    return win.replace(
        frame_valid=win.frame_valid.at[slot].set(True),
        evalPT=win.evalPT.at[slot].set(T_w2c),
        state=win.state.at[slot].set(state),
        state_zero=win.state_zero.at[slot].set(state),
        ab_exposure=win.ab_exposure.at[slot].set(exposure),
        frame_energy_th=win.frame_energy_th.at[slot].set(energy_th),
        frame_id=win.frame_id.at[slot].set(frame_id),
    )


def set_frame_eval_pt(win: W.Window, slot: int) -> W.Window:
    """Re-linearize a frame at its current pose (end of optimize,
    FullSystemOptimize.cpp:1000-1006): evalPT <- current worldToCam; pose
    state zeroed; ab kept as both state and state_zero."""
    w2c = win.w2c()[slot]
    state = win.state[slot]
    new_state = jnp.zeros_like(state).at[6].set(state[6]).at[7].set(state[7])
    return win.replace(
        evalPT=win.evalPT.at[slot].set(w2c),
        state=win.state.at[slot].set(new_state),
        state_zero=win.state_zero.at[slot].set(new_state),
    )


def insert_points(
    win: W.Window,
    idx,  # (k,) point slot indices
    host_slot: int,
    u,
    v,
    idepth,
    color,
    weights,
    energy_th,
    has_prior=False,
) -> W.Window:
    idx = jnp.asarray(idx)
    F = win.F
    return win.replace(
        pt_status=win.pt_status.at[idx].set(W.PT_ACTIVE),
        pt_host=win.pt_host.at[idx].set(host_slot),
        pt_u=win.pt_u.at[idx].set(u),
        pt_v=win.pt_v.at[idx].set(v),
        pt_idepth=win.pt_idepth.at[idx].set(idepth),
        pt_idepth_zero=win.pt_idepth_zero.at[idx].set(idepth),
        pt_color=win.pt_color.at[idx].set(color),
        pt_weights=win.pt_weights.at[idx].set(weights),
        pt_has_prior=win.pt_has_prior.at[idx].set(has_prior),
        pt_energy_th=win.pt_energy_th.at[idx].set(energy_th),
        pt_num_good_res=win.pt_num_good_res.at[idx].set(0),
        pt_max_rel_baseline=win.pt_max_rel_baseline.at[idx].set(0.0),
        pt_idepth_hessian=win.pt_idepth_hessian.at[idx].set(0.0),
        res_exists=win.res_exists.at[idx].set(False),
        res_linearized=win.res_linearized.at[idx].set(False),
        res_state=win.res_state.at[idx].set(W.RES_IN),
        res_energy=win.res_energy.at[idx].set(0.0),
    )


def add_residuals(win: W.Window, pt_idx, target_slot) -> W.Window:
    """Create residuals point(s) -> target frame (state IN, not linearized)."""
    pt_idx = jnp.asarray(pt_idx)
    return win.replace(
        res_exists=win.res_exists.at[pt_idx, target_slot].set(True),
        res_state=win.res_state.at[pt_idx, target_slot].set(W.RES_IN),
        res_linearized=win.res_linearized.at[pt_idx, target_slot].set(False),
        res_energy=win.res_energy.at[pt_idx, target_slot].set(0.0),
    )


def add_residuals_all_pairs(win: W.Window) -> W.Window:
    """Create residuals from every active point to every other valid frame."""
    F = win.F
    active = win.pt_status == W.PT_ACTIVE
    tgt_ok = win.frame_valid[None, :] & (
        win.pt_host[:, None] != jnp.arange(F)[None, :]
    )
    new = active[:, None] & tgt_ok
    return win.replace(
        res_exists=new,
        res_state=jnp.where(new, W.RES_IN, win.res_state),
        res_linearized=jnp.zeros_like(win.res_linearized),
    )


def free_point_slots(win: W.Window, k: int) -> np.ndarray:
    """Indices of up to k inactive point slots (host-side)."""
    status = np.asarray(win.pt_status)
    free = np.nonzero(status == W.PT_INACTIVE)[0]
    return free[:k]
