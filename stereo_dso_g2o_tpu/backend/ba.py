"""Windowed photometric bundle adjustment with FEJ + marginalization.

JAX rebuild of the reference's *legacy* DSO solver semantics — the
numerically correct path whose accuracy the published numbers come from
(SURVEY.md par. 2 #9 quirk: the fork's g2o detour drops the marginal prior):

- host/target adjoint transfer of relative 8-dof Jacobians to absolute states
  (EnergyFunctional::setAdjointsF, EnergyFunctional.cpp:41-119)
- H/b assembly in three parts: active (A-mode), linearized-at-FEJ priors
  (L-mode), and the Schur complement over per-point inverse depths (SC)
  (accumulateAF/LF/SCF + AccumulatedTopHessian/AccumulatedSCHessian)
- marginal prior bM + HM*delta, preconditioned solve with fixed lambda and
  late nullspace orthogonalization of x (solveSystemF, :838-977;
  default solver mode = SOLVER_FIX_LAMBDA | SOLVER_ORTHOGONALIZE_X_LATER)
- back-substitution of per-point idepth steps (resubstituteF, :272-341)
- point marginalization into HM/bM (mode-2 accumulation, :663-736) and frame
  marginalization by scaled Schur elimination (:554-660) — slot-indexed here,
  so no permutation shuffle is needed
- 7-dof gauge nullspace handling (orthogonalize, :775-835; nullspaces from
  FrameHessian::setStateZero, HessianBlocks.cpp:78-123 — the numeric diff
  there is the adjoint of the FEJ pose, used in closed form here)

The per-(host,target) pair accumulation is a segment-sum over the dense
[NP, F] residual cube; the stitch is a batch of 8x8 einsums over the F*F pair
adjoints — the structure that later shards across devices by psum-ing the
pair-block sums (SURVEY.md par. 5 long-context analog).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.config import (
    CPARS,
    SCALE_A,
    SCALE_B,
    SCALE_C,
    SCALE_F,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    Settings,
    default_settings,
)
from stereo_dso_g2o_tpu.ops import residuals as R
from stereo_dso_g2o_tpu.utils import se3

import numpy as _np

C_SCALE = _np.asarray([SCALE_F, SCALE_F, SCALE_C, SCALE_C], dtype=_np.float32)


# ---------------------------------------------------------------------------
# adjoints & deltas
# ---------------------------------------------------------------------------


def adjoints(win: W.Window):
    """adHost/adTarget per (host, target) pair (setAdjointsF)."""
    ev = win.evalPT
    T_th = jnp.einsum("tij,hjk->htik", ev, se3.inverse(ev))  # [h,t] = T_t * T_h^-1
    Adj = se3.adjoint(T_th)  # (F,F,6,6), (trans, rot) ordering
    F = win.F
    AH = jnp.zeros((F, F, 8, 8), ev.dtype)
    AT = jnp.zeros((F, F, 8, 8), ev.dtype)
    AH = AH.at[..., :6, :6].set(-jnp.swapaxes(Adj, -1, -2))
    AT = AT.at[..., :6, :6].set(jnp.eye(6, dtype=ev.dtype))

    aff0 = win.aff_g2l_0()
    affLL = W.aff_transfer(
        win.ab_exposure[:, None],
        win.ab_exposure[None, :],
        aff0[:, None, :],
        aff0[None, :, :],
    )  # (h, t, 2)
    a = affLL[..., 0]
    AT = AT.at[..., 6, 6].set(-a)
    AT = AT.at[..., 7, 7].set(-1.0)
    AH = AH.at[..., 6, 6].set(a)
    AH = AH.at[..., 7, 7].set(a)

    row_scale = jnp.asarray(
        [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
        dtype=ev.dtype,
    )
    AH = AH * row_scale[None, None, :, None]
    AT = AT * row_scale[None, None, :, None]
    return AH, AT


def deltas(win: W.Window):
    """Frame/calib/point deltas from the FEJ point (setDeltaF)."""
    d_frame = win.state - win.state_zero  # (F, 8) preconditioned
    dc = (win.c_value - win.c_zero) / C_SCALE  # (4,) preconditioned
    d_pt = win.pt_idepth - win.pt_idepth_zero  # (NP,)
    return d_frame, dc, d_pt


def ht_delta(win: W.Window, AH, AT, d_frame):
    """adHTdeltaF: per-pair relative 8-dof delta row vectors (setDeltaF)."""
    return jnp.einsum("h i, htij -> htj", d_frame, AH) + jnp.einsum(
        "t i, htij -> htj", d_frame, AT
    )


def stitched_delta(win: W.Window, d_frame, dc):
    """getStitchedDeltaF: (D,) = [dc, d_frame_0, ..., d_frame_{F-1}]."""
    return jnp.concatenate([dc, d_frame.reshape(-1)])


def frame_priors(win: W.Window, settings: Settings):
    """FrameHessian::getPrior (HessianBlocks.h:239-264), per slot."""
    F = win.F
    first = win.frame_id == 0
    p = jnp.zeros((F, 8), win.state.dtype)
    p = p.at[:, 6].set(
        jnp.where(
            first,
            settings.initial_aff_a_prior,
            settings.initial_aff_a_prior
            if settings.affine_opt_mode_a < 0
            else settings.affine_opt_mode_a,
        )
    )
    p = p.at[:, 7].set(
        jnp.where(
            first,
            settings.initial_aff_b_prior,
            settings.initial_aff_b_prior
            if settings.affine_opt_mode_b < 0
            else settings.affine_opt_mode_b,
        )
    )
    p = p.at[:, 0:3].set(jnp.where(first[:, None], settings.initial_trans_prior, 0.0))
    p = p.at[:, 3:6].set(jnp.where(first[:, None], settings.initial_rot_prior, 0.0))
    return p * win.frame_valid[:, None]


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------


class Accum(NamedTuple):
    H: jax.Array  # (D, D)
    b: jax.Array  # (D,)
    # per-point Schur inputs
    Hdd: jax.Array  # (NP,)
    bd: jax.Array  # (NP,)
    Hcd: jax.Array  # (NP, 4)
    nres: jax.Array  # () active residual count


def _res_approx(win: W.Window, mode: int, dp, dc, d_pt):
    """resApprox per mode (AccumulatedTopHessian.cpp:82-115), from ACCEPTED J."""
    if mode == 0:
        return win.J_resF
    # mode 1/2 use res_toZero (+ J*delta for mode 1)
    if mode == 2:
        return win.res_to_zero
    Jp_dx = (
        jnp.einsum("nfk,nfk->nf", win.J_pdxi[:, :, 0, :], dp[..., :6])
        + jnp.einsum("nfk,k->nf", win.J_pdc[:, :, 0, :], dc)
        + win.J_pdd[:, :, 0] * d_pt[:, None]
    )
    Jp_dy = (
        jnp.einsum("nfk,nfk->nf", win.J_pdxi[:, :, 1, :], dp[..., :6])
        + jnp.einsum("nfk,k->nf", win.J_pdc[:, :, 1, :], dc)
        + win.J_pdd[:, :, 1] * d_pt[:, None]
    )
    return (
        win.res_to_zero
        + win.J_Idx[:, :, 0, :] * Jp_dx[..., None]
        + win.J_Idx[:, :, 1, :] * Jp_dy[..., None]
        + win.J_abF[:, :, 0, :] * dp[..., 6][..., None]
        + win.J_abF[:, :, 1, :] * dp[..., 7][..., None]
    )


def accumulate_top(
    win: W.Window,
    AH,
    AT,
    mask,  # (NP, F) residuals to accumulate
    mode: int,
    settings: Settings,
    use_prior: bool,
    axis_name=None,
):
    """AccumulatedTopHessianSSE::addPoint<mode> + stitchDouble."""
    F = win.F
    dtype = win.state.dtype
    d_frame, dc, d_pt = deltas(win)
    dp = ht_delta(win, AH, AT, d_frame)[win.pt_host]  # (NP, F, 8)

    resA = _res_approx(win, mode, dp, dc, d_pt)  # (NP, F, 8)
    m = mask.astype(dtype)

    JIdx = win.J_Idx  # (NP, F, 2, 8)
    JabF = win.J_abF
    Jpdxi = win.J_pdxi
    Jpdc = win.J_pdc
    Jpdd = win.J_pdd

    JI_r = jnp.einsum("nfp,nfkp->nfk", resA, JIdx)  # (NP, F, 2)
    JIdx2 = jnp.einsum("nfip,nfjp->nfij", JIdx, JIdx)  # (NP, F, 2, 2)

    # G: 2 x 10 = [Jpdc, Jpdxi]
    G = jnp.concatenate([Jpdc, Jpdxi], axis=-1)  # (NP, F, 2, 10)

    # Per-residual 13x13 = sum over pattern pixels of v v^T with
    # v = [G^T JIdx[:, p] (10), JabF[:, p] (2), resA[p] (1)] — the MatPCPC
    # layout rows/cols (c(4), pose(6), ab(2), r(1)). Building V and letting
    # ONE one-hot-host contraction produce the per-(host, target) pair sums
    # keeps the whole accumulation in one matmul instead of scatter-adding
    # an (NP, F, 13, 13) buffer. Whether a segment_sum / scatter-add beats
    # it on the GPU is not measured yet.
    u10 = jnp.einsum("nfip,nfia->nfpa", JIdx, G)  # (NP, F, 8, 10)
    V = jnp.concatenate(
        [u10, jnp.swapaxes(JabF, -1, -2), resA[..., None]], axis=-1
    )  # (NP, F, 8, 13)

    onehot = (
        win.pt_host[:, None] == jnp.arange(F, dtype=win.pt_host.dtype)[None, :]
    ).astype(dtype)  # (NP, F_host)
    Vm = V * m[..., None, None]
    pair = jnp.einsum("nh,nfpa,nfpb->hfab", onehot, Vm, V)  # (F, F, 13, 13)

    # reorder 13x13 from [c, pose, ab, r] into [c(0:4), p(4:12), r(12)]:
    # G was [Jpdc(4), Jpdxi(6)] so indices 0:4=c, 4:10=pose, 10:12=ab, 12=r —
    # relative-state block p = (pose, ab) = indices 4:12. Matches MatPCPC.
    A8 = pair[..., 4:12, 4:12]
    Ac = pair[..., 4:12, 0:4]
    Acc = jnp.sum(pair[..., 0:4, 0:4], axis=(0, 1))
    br = pair[..., 4:12, 12]
    bc = jnp.sum(pair[..., 0:4, 12], axis=(0, 1))

    # stitch with adjoints (stitchDouble, AccumulatedTopHessian.cpp:201-260).
    # The reference fills H[h,t] += adH A8 adT^T then mirrors; building the
    # symmetric form directly is equivalent: off-diagonal pair blocks get the
    # contribution and its transpose at the mirrored position, diagonal
    # frame blocks sum adH A8 adH^T over targets and adT A8 adT^T over hosts.
    eyeF = jnp.eye(F, dtype=dtype)
    Hoff = jnp.einsum("htab,htbc,htdc->htad", AH, A8, AT)
    Hsym = Hoff + jnp.swapaxes(jnp.swapaxes(Hoff, 0, 1), -1, -2)
    Hsym = Hsym * (1.0 - eyeF)[:, :, None, None]
    diag_h = jnp.einsum("htab,htbc,htdc->had", AH, A8, AH)  # sum over t
    diag_t = jnp.einsum("htab,htbc,htdc->tad", AT, A8, AT)  # sum over h

    D = CPARS + 8 * F
    Hout = jnp.zeros((D, D), dtype)
    bout = jnp.zeros((D,), dtype)

    Hff_total = Hsym + jnp.einsum("had,ht->htad", diag_h + diag_t, eyeF)
    Hout = Hout.at[CPARS:, CPARS:].set(
        Hff_total.transpose(0, 2, 1, 3).reshape(8 * F, 8 * F)
    )
    # frame-calib blocks
    Hfc = jnp.einsum("htab,htbc->hac", AH, Ac) + jnp.einsum(
        "htab,htbc->tac", AT, Ac
    )
    Hout = Hout.at[CPARS:, :CPARS].set(Hfc.reshape(8 * F, CPARS))
    Hout = Hout.at[:CPARS, CPARS:].set(Hfc.reshape(8 * F, CPARS).T)
    Hout = Hout.at[:CPARS, :CPARS].set(Acc)

    bf = jnp.einsum("htab,htb->ha", AH, br) + jnp.einsum("htab,htb->ta", AT, br)
    bout = bout.at[CPARS:].set(bf.reshape(-1))
    bout = bout.at[:CPARS].set(bc)

    if axis_name is not None:
        # distributed BA: the pair-block sums are partial over the local point
        # shard; all-reduce before (replicated) priors (SURVEY.md par. 5)
        Hout = jax.lax.psum(Hout, axis_name)
        bout = jax.lax.psum(bout, axis_name)

    if use_prior:
        prior_f = frame_priors(win, settings)
        d_prior = win.state  # delta_prior = state - priorZero(=0)
        Hout = Hout.at[jnp.arange(CPARS), jnp.arange(CPARS)].add(
            settings.initial_calib_hessian
        )
        bout = bout.at[:CPARS].add(settings.initial_calib_hessian * dc)
        idx = CPARS + jnp.arange(8 * F)
        Hout = Hout.at[idx, idx].add(prior_f.reshape(-1))
        bout = bout.at[CPARS:].add((prior_f * d_prior).reshape(-1))

    # per-point Schur inputs (Hdd, bd, Hcd; AccumulatedTopHessian.cpp:159-192)
    JJd = jnp.einsum("nfij,nfj->nfi", JIdx2, Jpdd)  # (NP, F, 2)
    bd = jnp.sum(m * jnp.einsum("nfi,nfi->nf", JI_r, Jpdd), axis=1)
    Hdd = jnp.sum(m * jnp.einsum("nfi,nfi->nf", JJd, Jpdd), axis=1)
    Hcd = jnp.sum(
        m[..., None]
        * (
            Jpdc[:, :, 0, :] * JJd[:, :, 0, None]
            + Jpdc[:, :, 1, :] * JJd[:, :, 1, None]
        ),
        axis=1,
    )
    nres = jnp.sum(mask)
    if axis_name is not None:
        nres = jax.lax.psum(nres, axis_name)
    return Accum(H=Hout, b=bout, Hdd=Hdd, bd=bd, Hcd=Hcd, nres=nres)


def point_prior(win: W.Window, settings: Settings, marg_fac=None):
    """EFPoint::priorF (EnergyFunctionalStructs.cpp:105-112)."""
    p = jnp.where(win.pt_has_prior, settings.idepth_fix_prior, 0.0)
    if marg_fac is not None:
        p = p * marg_fac
    return p


class Schur(NamedTuple):
    H: jax.Array
    b: jax.Array
    HdiF: jax.Array  # (NP,)
    bdSum: jax.Array  # (NP,)
    Hcd: jax.Array  # (NP, 4)
    JpJdF: jax.Array  # (NP, F, 8)
    idepth_hessian: jax.Array  # (NP,)


def accumulate_sc(
    win: W.Window,
    AH,
    AT,
    active,  # (NP, F) active residual mask
    acc: Accum,
    prior_pt,  # (NP,)
    shift_prior_to_zero: bool,
    axis_name=None,
):
    """AccumulatedSCHessianSSE::addPoint + stitchDouble."""
    F = win.F
    dtype = win.state.dtype
    _, _, d_pt = deltas(win)

    ngood = jnp.sum(active, axis=1)  # (NP,)
    has = ngood > 0

    Hdd = acc.Hdd + prior_pt
    Hdd = jnp.maximum(Hdd, 1e-10)
    idepth_hessian = jnp.where(has, Hdd, 0.0)
    HdiF = jnp.where(has, 1.0 / Hdd, 0.0)
    bdSum = acc.bd
    if shift_prior_to_zero:
        bdSum = bdSum + prior_pt * d_pt
    bdSum = jnp.where(has, bdSum, 0.0)
    Hcd = jnp.where(has[:, None], acc.Hcd, 0.0)

    # JpJdF per residual from ACCEPTED J (EFResidual::takeDataF)
    JIdx2 = jnp.einsum("nfip,nfjp->nfij", win.J_Idx, win.J_Idx)
    JJd = jnp.einsum("nfij,nfj->nfi", JIdx2, win.J_pdd)  # (NP, F, 2)
    JabJIdx = jnp.einsum("nfip,nfjp->nfij", win.J_abF, win.J_Idx)
    JpJd_pose = jnp.einsum("nfki,nfk->nfi", win.J_pdxi, JJd)  # (NP, F, 6)
    JpJd_ab = jnp.einsum("nfij,nfj->nfi", JabJIdx, win.J_pdd)  # (NP, F, 2)
    JpJdF = jnp.concatenate([JpJd_pose, JpJd_ab], axis=-1)  # (NP, F, 8)
    JpJdF = JpJdF * active[..., None]

    D = CPARS + 8 * F
    Hout = jnp.zeros((D, D), dtype)
    bout = jnp.zeros((D,), dtype)

    # Hcc / bc
    Hcc = jnp.einsum("ni,nj,n->ij", Hcd, Hcd, HdiF)
    bcc = jnp.einsum("ni,n->i", Hcd, bdSum * HdiF)
    Hout = Hout.at[:CPARS, :CPARS].set(Hcc)
    bout = bout.at[:CPARS].set(bcc)

    # accD[h, t1, t2] = sum over points hosted at h of JpJd_t1 JpJd_t2^T HdiF.
    # One one-hot-host contraction of the flattened (F*8) target axis —
    # instead of materializing and scatter-adding an (NP, F, F, 8, 8)
    # buffer (~33 MB/iteration of device-memory traffic).
    onehot = (
        win.pt_host[:, None] == jnp.arange(F, dtype=win.pt_host.dtype)[None, :]
    ).astype(dtype)  # (NP, F_host)
    X = JpJdF.reshape(JpJdF.shape[0], F * 8)  # (NP, F*8)
    Xw = X * (HdiF[:, None])
    Dflat = jnp.einsum("nh,na,nb->hab", onehot, Xw, X)  # (F, F*8, F*8)
    Dacc = Dflat.reshape(F, F, 8, F, 8).transpose(0, 1, 3, 2, 4)
    # accE[h, t] = sum JpJd_t Hcd^T HdiF ; accEB[h, t] = JpJd_t HdiF bdSum
    Eacc = jnp.einsum("nh,nti,nj,n->htij", onehot, JpJdF, Hcd, HdiF)
    EBacc = jnp.einsum("nh,nti,n->hti", onehot, JpJdF, HdiF * bdSum)

    # stitch (AccumulatedSCHessian.cpp:196-257); i=host, j/k=targets
    Hfc = jnp.einsum("ijab,ijbc->iac", AH, Eacc) + jnp.einsum(
        "ijab,ijbc->jac", AT, Eacc
    )
    Hout = Hout.at[CPARS:, :CPARS].add(Hfc.reshape(8 * F, CPARS))
    Hout = Hout.at[:CPARS, CPARS:].add(Hfc.reshape(8 * F, CPARS).T)
    bf = jnp.einsum("ijab,ijb->ia", AH, EBacc) + jnp.einsum(
        "ijab,ijb->ja", AT, EBacc
    )
    bout = bout.at[CPARS:].add(bf.reshape(-1))

    # frame-frame: four adjoint combinations (:232-247)
    Hff = jnp.zeros((F, F, 8, 8), dtype)
    # H[i,i] += adH_ij D_ijk adH_ik^T (sum j,k)
    t1 = jnp.einsum("ijab,ijkbc,ikdc->iad", AH, Dacc, AH)
    Hff = Hff + jnp.einsum("iad,ij->ijad", t1, jnp.eye(F, dtype=dtype))
    # H[j,k] += adT_ij D_ijk adT_ik^T (sum i)
    Hff = Hff + jnp.einsum("ijab,ijkbc,ikdc->jkad", AT, Dacc, AT)
    # H[j,i] += adT_ij D_ijk adH_ik^T (sum k)
    Hff = Hff + jnp.einsum("ijab,ijkbc,ikdc->jiad", AT, Dacc, AH)
    # H[i,k] += adH_ij D_ijk adT_ik^T (sum j)
    Hff = Hff + jnp.einsum("ijab,ijkbc,ikdc->ikad", AH, Dacc, AT)

    Hout = Hout.at[CPARS:, CPARS:].add(
        Hff.transpose(0, 2, 1, 3).reshape(8 * F, 8 * F)
    )
    if axis_name is not None:
        Hout = jax.lax.psum(Hout, axis_name)
        bout = jax.lax.psum(bout, axis_name)
    return Schur(
        H=Hout,
        b=bout,
        HdiF=HdiF,
        bdSum=bdSum,
        Hcd=Hcd,
        JpJdF=JpJdF,
        idepth_hessian=idepth_hessian,
    )


# ---------------------------------------------------------------------------
# nullspaces & orthogonalization
# ---------------------------------------------------------------------------


def nullspaces(win: W.Window):
    """Gauge nullspace columns N (D, 7): 6 pose + 1 scale
    (FullSystem::getNullspaces + FrameHessian::setStateZero)."""
    F = win.F
    D = CPARS + 8 * F
    dtype = win.state.dtype
    Adj = se3.adjoint(win.evalPT)  # (F, 6, 6) — d log(T exp(eps) T^-1)/d eps
    t = win.evalPT[:, :3, 3]

    inv_scale = jnp.asarray(
        [1.0 / SCALE_XI_TRANS] * 3 + [1.0 / SCALE_XI_ROT] * 3, dtype=dtype
    )
    cols = []
    for i in range(6):
        n = jnp.zeros((F, 8), dtype)
        n = n.at[:, :6].set(Adj[:, :, i] * inv_scale[None, :])
        n = n * win.frame_valid[:, None]
        cols.append(jnp.concatenate([jnp.zeros(CPARS, dtype), n.reshape(-1)]))
    # scale nullspace: d log(T_scaled T^-1) ~ (t, 0)
    n = jnp.zeros((F, 8), dtype)
    n = n.at[:, :3].set(t * (1.0 / SCALE_XI_TRANS))
    n = n * win.frame_valid[:, None]
    cols.append(jnp.concatenate([jnp.zeros(CPARS, dtype), n.reshape(-1)]))
    return jnp.stack(cols, axis=1)  # (D, 7)


def orthogonalize(x, N):
    """Remove nullspace components: x - N (N^T N)^-1 N^T x (:775-835)."""
    norms = jnp.linalg.norm(N, axis=0, keepdims=True)
    Nn = N / jnp.maximum(norms, 1e-12)
    NtN = Nn.T @ Nn
    coef = jnp.linalg.solve(
        NtN + 1e-10 * jnp.eye(NtN.shape[0], dtype=N.dtype), Nn.T @ x
    )
    return x - Nn @ coef


# ---------------------------------------------------------------------------
# solve + resubstitute
# ---------------------------------------------------------------------------


class SolveOut(NamedTuple):
    x: jax.Array  # (D,) frame+calib increments (pre-negation, ref convention)
    step_c: jax.Array  # (4,) calib step (preconditioned)
    step_f: jax.Array  # (F, 8) frame step (preconditioned)
    step_pt: jax.Array  # (NP,) idepth step


def solve_system(
    win: W.Window,
    acc_A: Accum,
    sc: Schur,
    settings: Settings,
    iteration,
    lam=1e-5,
    do_orth=True,
):
    F = win.F
    D = CPARS + 8 * F
    dtype = win.state.dtype
    d_frame, dc, _ = deltas(win)

    bM_top = win.bM + win.HM @ stitched_delta(win, d_frame, dc)

    HFinal = acc_A.H + win.HM
    bFinal = acc_A.b + bM_top - sc.b

    diag = jnp.arange(D)
    HFinal = HFinal.at[diag, diag].multiply(1.0 + lam)
    HFinal = HFinal - sc.H * (1.0 / (1.0 + lam))

    # inactive frame slots: unit diagonal, zero rhs
    slot_active = jnp.concatenate(
        [
            jnp.ones(CPARS, bool),
            jnp.repeat(win.frame_valid, 8),
        ]
    )
    HFinal = jnp.where(
        slot_active[:, None] & slot_active[None, :], HFinal, 0.0
    )
    HFinal = HFinal.at[diag, diag].add(jnp.where(slot_active, 0.0, 1.0))
    bFinal = jnp.where(slot_active, bFinal, 0.0)

    # zero-information dimensions (e.g. the pose block of a keyframe whose
    # residuals all died and that has no marginal-prior coverage yet): H is a
    # sum of PSD terms, so a ~zero diagonal implies a ~zero row — exactly
    # singular. Unit-pin those dims (zero step) instead of letting the LU
    # solve produce NaN for the whole window. The reference never hits this
    # (its double LDLT + per-point graph keeps such frames out), but the
    # fixed-capacity window can transiently hold an unsupported frame.
    no_info = jnp.abs(HFinal[diag, diag]) < 1e-6
    HFinal = HFinal.at[diag, diag].add(jnp.where(no_info, 1.0, 0.0))
    bFinal = jnp.where(no_info, 0.0, bFinal)

    SVecI = 1.0 / jnp.sqrt(jnp.abs(HFinal[diag, diag]) + 10.0)
    Hs = SVecI[:, None] * HFinal * SVecI[None, :]
    bs = SVecI * bFinal
    xs = jnp.linalg.solve(Hs, bs)
    x = SVecI * xs

    if do_orth:
        N = nullspaces(win)
        x_orth = orthogonalize(x, N)
        x = jnp.where(iteration >= 2, x_orth, x)

    # step-sanity gate: a non-finite solve (numerically singular reduced
    # system) must not poison the window state — reject the whole step
    # (zero increments also read as converged, ending the LM loop early).
    x = jnp.where(jnp.isfinite(x).all(), x, jnp.zeros_like(x))

    # resubstitute (EnergyFunctional.cpp:272-341)
    step_c = -x[:CPARS]
    step_f = -x[CPARS:].reshape(F, 8) * win.frame_valid[:, None]

    AH, AT = adjoints(win)
    xf = x[CPARS:].reshape(F, 8)
    xAd = jnp.einsum("hi,htij->htj", xf, AH) + jnp.einsum(
        "ti,htij->htj", xf, AT
    )  # (F_host, F_target, 8)

    active = win.res_exists & (win.res_state == W.RES_IN)
    ngood = jnp.sum(active, axis=1)
    b_pt = sc.bdSum - x[:CPARS] @ sc.Hcd.T  # (NP,)
    b_pt = b_pt - jnp.einsum(
        "nfj,nfj->n", xAd[win.pt_host], sc.JpJdF * active[..., None]
    )
    step_pt = jnp.where(ngood > 0, -b_pt * sc.HdiF, 0.0)
    step_pt = jnp.where(jnp.isfinite(step_pt), step_pt, 0.0)

    return SolveOut(x=x, step_c=step_c, step_f=step_f, step_pt=step_pt)


def apply_step(win: W.Window, out: SolveOut) -> W.Window:
    """doStepFromBackup with stepfac=1 (FullSystemOptimize.cpp:258-289):
    state += step; point idepth steps also reset idepth_zero (no point FEJ)."""
    new_state = win.state + out.step_f
    new_c = win.c_value + out.step_c * C_SCALE
    new_id = win.pt_idepth + out.step_pt
    return win.replace(
        state=new_state,
        c_value=new_c,
        pt_idepth=new_id,
        pt_idepth_zero=new_id,
    )


def step_converged(win: W.Window, out: SolveOut, settings: Settings, axis_name=None):
    """Convergence test of doStepFromBackup (:289-304)."""
    nf = jnp.maximum(jnp.sum(win.frame_valid), 1)
    sumA = jnp.sum(out.step_f[:, 6] ** 2) / nf
    sumB = jnp.sum(out.step_f[:, 7] ** 2) / nf
    sumT = jnp.sum(out.step_f[:, 0:3] ** 2) / nf
    sumR = jnp.sum(out.step_f[:, 3:6] ** 2) / nf
    pt_ok = win.pt_status == W.PT_ACTIVE
    n_pt = jnp.sum(pt_ok)
    sum_id = jnp.sum(jnp.where(pt_ok, jnp.abs(win.pt_idepth), 0.0))
    if axis_name is not None:
        n_pt = jax.lax.psum(n_pt, axis_name)
        sum_id = jax.lax.psum(sum_id, axis_name)
    sumNID = sum_id / jnp.maximum(n_pt, 1)
    th = settings.th_opt_iterations
    return (
        (jnp.sqrt(sumA) < 0.0005 * th)
        & (jnp.sqrt(sumB) < 0.00005 * th)
        & (jnp.sqrt(sumR) < 0.00005 * th)
        & (jnp.sqrt(sumT) * sumNID < 0.00005 * th)
    )


# ---------------------------------------------------------------------------
# the optimization driver
# ---------------------------------------------------------------------------


def accumulate_priors(win: W.Window, settings: Settings):
    """The prior-only part of accumulateLF: in this system linearized
    residuals exist only transiently between point flagging and their
    marginalization within the same keyframe pass, so during optimize() the
    L-mode accumulation reduces to the frame/calib priors (the reference
    notes the same: 'there are no points involved at all here, only a priori
    information', EnergyFunctional.cpp solveSystemF comment)."""
    F = win.F
    D = CPARS + 8 * F
    dtype = win.state.dtype
    _, dc, _ = deltas(win)
    H = jnp.zeros((D, D), dtype)
    b = jnp.zeros((D,), dtype)
    prior_f = frame_priors(win, settings)
    d_prior = win.state
    H = H.at[jnp.arange(CPARS), jnp.arange(CPARS)].add(
        settings.initial_calib_hessian
    )
    b = b.at[:CPARS].add(settings.initial_calib_hessian * dc)
    idx = CPARS + jnp.arange(8 * F)
    H = H.at[idx, idx].add(prior_f.reshape(-1))
    b = b.at[CPARS:].add((prior_f * d_prior).reshape(-1))
    NP = win.NP
    return Accum(
        H=H, b=b,
        Hdd=jnp.zeros((NP,), dtype), bd=jnp.zeros((NP,), dtype),
        Hcd=jnp.zeros((NP, CPARS), dtype), nres=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("settings", "axis_name"))
def ba_iteration(
    win: W.Window, dI_stack, iteration, settings: Settings = default_settings(),
    axis_name=None,
):
    """One GN/LM iteration of the windowed BA (legacy optimize loop body with
    setting_forceAceptStep=true: linearize -> accumulate -> solve -> step)."""
    # linearize all existing, non-linearized residuals (activeResiduals)
    active_set = win.res_exists & ~win.res_linearized
    lin = R.linearize(win, dI_stack, settings=settings)
    win = R.apply_res(win, lin, active_set)

    AH, AT = adjoints(win)
    active = win.res_exists & (win.res_state == W.RES_IN)
    mode0 = active & ~win.res_linearized
    accA = accumulate_top(
        win, AH, AT, mode0, 0, settings, use_prior=False, axis_name=axis_name
    )
    accL = accumulate_priors(win, settings)
    acc = Accum(
        H=accA.H + accL.H,
        b=accA.b + accL.b,
        Hdd=accA.Hdd + accL.Hdd,
        bd=accA.bd + accL.bd,
        Hcd=accA.Hcd + accL.Hcd,
        nres=accA.nres,
    )
    prior_pt = point_prior(win, settings)
    sc = accumulate_sc(
        win, AH, AT, active, acc, prior_pt, True, axis_name=axis_name
    )
    out = solve_system(win, acc, sc, settings, iteration)
    win = apply_step(win, out)
    win = win.replace(pt_idepth_hessian=sc.idepth_hessian)

    energy = jnp.sum(jnp.where(active_set, lin.energy, 0.0))
    if axis_name is not None:
        energy = jax.lax.psum(energy, axis_name)
    converged = step_converged(win, out, settings, axis_name=axis_name)
    return win, energy, converged, acc.nres


def optimize(win: W.Window, dI_stack, settings: Settings = default_settings(), max_its: int = 6):
    """FullSystem::optimize (legacy, FullSystemOptimize.cpp:871-1041)."""
    energy = None
    nres = 0
    for it in range(max_its):
        win, energy, converged, nres = ba_iteration(
            win, dI_stack, jnp.asarray(it), settings=settings
        )
        if it >= settings.min_opt_iterations and bool(converged):
            break
    return win, energy, nres


# ---------------------------------------------------------------------------
# final linearization pass, point flagging, marginalization
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("settings",))
def linearize_all_final(
    win: W.Window,
    dI_stack,
    newest_slot,
    settings: Settings = default_settings(),
):
    """linearizeAll(fixLinearization=true) + setNewFrameEnergyTH
    (FullSystemOptimize.cpp:98-205): final relinearization at the accepted
    state, residual pruning, per-point good-residual stats, and the adaptive
    energy threshold of the newest keyframe (70th-percentile residual)."""
    active_set = win.res_exists & ~win.res_linearized
    lin = R.linearize(win, dI_stack, settings=settings)
    win = R.apply_res(win, lin, active_set)

    active = win.res_exists & (win.res_state == W.RES_IN)

    # setNewFrameEnergyTH over active residuals targeting the newest frame
    tgt_new = jnp.arange(win.F)[None, :] == newest_slot
    sel = active_set & tgt_new & (win.res_new_energy_wo >= 0)
    vals = jnp.where(sel, win.res_new_energy_wo, jnp.inf).ravel()
    count = jnp.sum(sel)
    svals = jnp.sort(vals)
    nth = (settings.frame_energy_th_n * count).astype(jnp.int32)
    nth_val = jnp.sqrt(svals[jnp.clip(nth, 0, svals.shape[0] - 1)])
    th = nth_val * settings.frame_energy_th_fac_median
    th = (
        26.0 * settings.frame_energy_th_const_weight
        + th * (1.0 - settings.frame_energy_th_const_weight)
    )
    th = th * th * settings.overall_energy_th_weight**2
    th = jnp.where(count > 0, th, 12.0 * 12.0 * 8.0)
    new_th = jnp.where(
        jnp.arange(win.F) == newest_slot, th, win.frame_energy_th
    )
    win = win.replace(frame_energy_th=new_th)

    # stats for active residuals (numGoodResiduals, maxRelBaseline; :61-85)
    pre = W.precalc(win)
    h = win.pt_host
    KRKi = pre["KRKi"][h]
    Kt = pre["Kt"][h]
    P3 = jnp.stack([win.pt_u, win.pt_v, jnp.ones_like(win.pt_u)], -1)
    ptp_inf = jnp.einsum("nfij,nj->nfi", KRKi, P3)
    ptp = ptp_inf + Kt * win.pt_idepth[:, None, None]
    rel_bs = 0.01 * jnp.linalg.norm(
        ptp_inf[..., :2] / ptp_inf[..., 2:3] - ptp[..., :2] / ptp[..., 2:3],
        axis=-1,
    )
    rel_bs = jnp.where(active, rel_bs, 0.0)
    win = win.replace(
        pt_max_rel_baseline=jnp.maximum(
            win.pt_max_rel_baseline, jnp.max(rel_bs, axis=1)
        ),
        pt_num_good_res=win.pt_num_good_res
        + jnp.sum(active & active_set, axis=1).astype(jnp.int32),
    )

    # prune residuals that did not survive (toRemove; :165-200)
    win = win.replace(res_exists=win.res_exists & active)

    energy = jnp.sum(jnp.where(active_set, lin.energy, 0.0))
    return win, energy


def res_to_zero_fixed(win: W.Window):
    """EFResidual::fixLinearizationF for every active residual: res_toZeroF =
    resF - J * delta at the current state (EnergyFunctionalStructs.cpp:96-123)."""
    AH, AT = adjoints(win)
    d_frame, dc, d_pt = deltas(win)
    dp = ht_delta(win, AH, AT, d_frame)[win.pt_host]
    Jp_dx = (
        jnp.einsum("nfk,nfk->nf", win.J_pdxi[:, :, 0, :], dp[..., :6])
        + jnp.einsum("nfk,k->nf", win.J_pdc[:, :, 0, :], dc)
        + win.J_pdd[:, :, 0] * d_pt[:, None]
    )
    Jp_dy = (
        jnp.einsum("nfk,nfk->nf", win.J_pdxi[:, :, 1, :], dp[..., :6])
        + jnp.einsum("nfk,k->nf", win.J_pdc[:, :, 1, :], dc)
        + win.J_pdd[:, :, 1] * d_pt[:, None]
    )
    return (
        win.J_resF
        - win.J_Idx[:, :, 0, :] * Jp_dx[..., None]
        - win.J_Idx[:, :, 1, :] * Jp_dy[..., None]
        - win.J_abF[:, :, 0, :] * dp[..., 6][..., None]
        - win.J_abF[:, :, 1, :] * dp[..., 7][..., None]
    )


@functools.partial(jax.jit, static_argnames=("settings",))
def flag_points_for_removal(
    win: W.Window,
    dI_stack,
    frames_to_marg,  # (F,) bool — keyframes flagged for marginalization
    last_slot,  # newest frame slot (lastResiduals[0] target)
    prev_slot,  # second-newest (lastResiduals[1] target); -1 if none
    settings: Settings = default_settings(),
):
    """FullSystem::flagPointsForRemoval (FullSystem.cpp:965-1056): classify
    every active point as KEEP / MARGINALIZE / DROP; for marginalization
    candidates relinearize + fix res_toZero at the current state."""
    active_pt = win.pt_status == W.PT_ACTIVE
    nres = jnp.sum(win.res_exists, axis=1)

    # drop: behind camera or no residuals
    drop_simple = active_pt & ((win.pt_idepth < 0) | (nres == 0))

    # isOOB (HessianBlocks.h:439-462)
    res_in = win.res_exists & (win.res_state == W.RES_IN)
    vis_in_to_marg = jnp.sum(res_in & frames_to_marg[None, :], axis=1)
    oob_a = (
        (nres >= settings.min_good_active_res_for_marg)
        & (win.pt_num_good_res > settings.min_good_res_for_marg + 10)
        & (nres - vis_in_to_marg < settings.min_good_active_res_for_marg)
    )
    # lastResiduals[k].second semantics: the RECORDED state outlives the
    # residual's removal (linearizeAll's toRemove zeroes .first but keeps
    # .second, FullSystemOptimize.cpp:165-200; isOOB reads .second only,
    # HessianBlocks.h:458-460). Our res_state column retains that recorded
    # state after linearize_all_final prunes res_exists, so do NOT gate on
    # existence — gating on it silently disabled the OOB rule, letting
    # points invisible in the newest KFs (and their host frames) linger in
    # the window forever and starving new keyframes of residual support.
    lr0_state = win.res_state[:, last_slot]
    prev_ok = prev_slot >= 0
    safe_prev = jnp.maximum(prev_slot, 0)
    lr1_state = win.res_state[:, safe_prev]
    oob_b = lr0_state == W.RES_OOB
    oob_c = (
        (nres >= 2)
        & (lr0_state == W.RES_OUTLIER)
        & prev_ok
        & (lr1_state == W.RES_OUTLIER)
    )
    host_flagged = frames_to_marg[win.pt_host]
    oob = active_pt & ~drop_simple & (oob_a | oob_b | oob_c | host_flagged)

    inlier = (nres >= settings.min_good_active_res_for_marg) & (
        win.pt_num_good_res >= settings.min_good_res_for_marg
    )

    # relinearize the marginalization candidates at the current state
    lin = R.linearize(win, dI_stack, settings=settings)
    relin_mask = (oob & inlier)[:, None] & win.res_exists
    win = R.apply_res(win, lin, relin_mask)

    rtz = res_to_zero_fixed(win)
    fix_mask = relin_mask & (win.res_state == W.RES_IN)
    win = win.replace(
        res_to_zero=jnp.where(fix_mask[..., None], rtz, win.res_to_zero),
        res_linearized=win.res_linearized | fix_mask,
    )

    marg = oob & inlier & (win.pt_idepth_hessian > settings.min_idepth_h_marg)
    drop = drop_simple | (oob & ~(inlier & (win.pt_idepth_hessian > settings.min_idepth_h_marg)))

    status = win.pt_status
    status = jnp.where(marg, W.PT_MARGINALIZE, status)
    status = jnp.where(drop & ~marg, W.PT_DROP, status)
    return win.replace(pt_status=status)


@functools.partial(jax.jit, static_argnames=("settings",))
def marginalize_points(win: W.Window, settings: Settings = default_settings()):
    """EnergyFunctional::marginalizePointsF (:663-736): mode-2 accumulation of
    flagged points' fixed residuals, Schur over their idepth, folded into
    HM/bM with the marginalization weight; points and residuals removed."""
    AH, AT = adjoints(win)
    marg_pt = win.pt_status == W.PT_MARGINALIZE
    mask = (
        marg_pt[:, None]
        & win.res_exists
        & (win.res_state == W.RES_IN)
        & win.res_linearized
    )
    acc2 = accumulate_top(win, AH, AT, mask, 2, settings, use_prior=False)
    prior_pt = jnp.where(
        marg_pt,
        point_prior(win, settings) * settings.idepth_fix_prior_marg_fac,
        0.0,
    )
    # zero Schur inputs of non-marginalized points
    acc_masked = Accum(
        H=acc2.H,
        b=acc2.b,
        Hdd=jnp.where(marg_pt, acc2.Hdd, 0.0),
        bd=jnp.where(marg_pt, acc2.bd, 0.0),
        Hcd=jnp.where(marg_pt[:, None], acc2.Hcd, 0.0),
        nres=acc2.nres,
    )
    sc2 = accumulate_sc(win, AH, AT, mask, acc_masked, prior_pt, False)
    Hm = acc2.H - sc2.H
    bm = acc2.b - sc2.b
    win = win.replace(
        HM=win.HM + settings.marg_weight_fac * Hm,
        bM=win.bM + settings.marg_weight_fac * bm,
    )

    # remove marginalized + dropped points
    gone = (win.pt_status == W.PT_MARGINALIZE) | (win.pt_status == W.PT_DROP)
    win = win.replace(
        pt_status=jnp.where(gone, W.PT_INACTIVE, win.pt_status),
        res_exists=win.res_exists & ~gone[:, None],
        res_linearized=win.res_linearized & ~gone[:, None],
    )
    return win


@functools.partial(jax.jit, static_argnames=("settings",))
def marginalize_frame(
    win: W.Window, slot, settings: Settings = default_settings()
):
    """EnergyFunctional::marginalizeFrame (:554-660), slot-indexed: add the
    frame's prior, scaled Schur-eliminate its 8-dof block from HM/bM, zero the
    slot. The caller guarantees the frame hosts no points and no residuals
    target it."""
    F = win.F
    D = CPARS + 8 * F
    io = CPARS + 8 * slot
    idx8 = io + jnp.arange(8)

    HM = win.HM
    bM = win.bM
    prior_f = frame_priors(win, settings)[slot]
    d_prior = win.state[slot]
    HM = HM.at[idx8, idx8].add(prior_f)
    bM = bM.at[idx8].add(prior_f * d_prior)

    SVec = jnp.sqrt(jnp.abs(jnp.diagonal(HM)) + 10.0)
    SVecI = 1.0 / SVec
    Hs = SVecI[:, None] * HM * SVecI[None, :]
    bs = SVecI * bM

    # block inverse of the slot's 8x8. In the scaled domain informative
    # entries are O(1); the epsilon guards the degenerate case of a frame
    # that contributed no marginalized-point information (the reference would
    # invert a singular matrix there, EnergyFunctional.cpp:612-616).
    blk = Hs[idx8][:, idx8]
    blk = 0.5 * (blk + blk.T)
    blk_inv = jnp.linalg.inv(blk + 1e-6 * jnp.eye(8, dtype=blk.dtype))
    rows = Hs[idx8, :]  # (8, D)
    # eliminate: H -= rows^T blk_inv rows ; b -= rows^T blk_inv b8
    corr = rows.T @ blk_inv @ rows
    Hs = Hs - corr
    bs = bs - rows.T @ (blk_inv @ bs[idx8])

    HM_new = SVec[:, None] * Hs * SVec[None, :]
    bM_new = SVec * bs
    HM_new = 0.5 * (HM_new + HM_new.T)

    # zero the eliminated slot
    slot_mask = jnp.ones((D,), bool).at[idx8].set(False)
    HM_new = jnp.where(slot_mask[:, None] & slot_mask[None, :], HM_new, 0.0)
    bM_new = jnp.where(slot_mask, bM_new, 0.0)

    win = win.replace(
        HM=HM_new,
        bM=bM_new,
        frame_valid=win.frame_valid.at[slot].set(False),
        frame_id=win.frame_id.at[slot].set(-1),
        state=win.state.at[slot].set(0.0),
        state_zero=win.state_zero.at[slot].set(0.0),
        prior=win.prior.at[slot].set(0.0),
    )
    return win


@functools.partial(jax.jit, static_argnames=("settings",))
def marginalize_frames_masked(
    win: W.Window, flagged, settings: Settings = default_settings()
):
    """All flagged-frame marginalizations (drop refs + Schur-eliminate) as
    ONE program. flagged: (F,) bool. Replaces the host loop of per-slot
    dispatches: 2 flagged frames cost 4-6 round trips; this costs one."""
    F = win.F

    def body(s_, w):
        w_m = marginalize_frame(
            drop_frame_refs(w, s_), s_, settings=settings
        )
        return jax.tree.map(
            lambda a, b: jnp.where(flagged[s_], b, a), w, w_m
        )

    return jax.lax.fori_loop(0, F, body, win, unroll=False)


@functools.partial(jax.jit, static_argnames=("settings", "max_its"))
def optimize_fused(
    win: W.Window,
    dI_stack,
    settings: Settings = default_settings(),
    max_its: int = 6,
):
    """The whole GN loop as ONE device program. lax.while_loop so converged
    runs actually stop iterating (the fori_loop+done-flag formulation still
    paid all max_its linearizations and discarded the converged ones — a
    measured ~40% of the 133 ms steady-state BA cost)."""

    def cond(carry):
        _, _, _, done, it = carry
        return (it < max_its) & ~done

    def body(carry):
        win_c, _, _, done, it = carry
        win_n, e, conv, nr = ba_iteration(
            win_c, dI_stack, it, settings=settings
        )
        done_out = conv & (it + 1 >= settings.min_opt_iterations)
        return (win_n, e.astype(jnp.float32), nr.astype(jnp.int32),
                done_out, it + 1)

    init = (
        win,
        jnp.asarray(0.0, jnp.float32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )
    win, energy, nres, _, _ = jax.lax.while_loop(cond, body, init)
    return win, energy, nres


@jax.jit
def drop_frame_refs(win: W.Window, slot):
    """Remove residuals targeting `slot` and drop points hosted there
    (marginalizeFrame preamble, FullSystemMarginalize.cpp:146-180)."""
    F = win.F
    tgt = jnp.arange(F) == slot
    res_exists = win.res_exists & ~tgt[None, :]
    hosted = (win.pt_host == slot) & (win.pt_status == W.PT_ACTIVE)
    return win.replace(
        res_exists=res_exists & ~hosted[:, None],
        pt_status=jnp.where(hosted, W.PT_INACTIVE, win.pt_status),
    )
