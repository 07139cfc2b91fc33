"""Mono coarse initializer: joint pose + per-point inverse-depth GN bootstrap.

JAX rebuild of CoarseInitializer's monocular path
(CoarseInitializer.{h,cpp}: trackFrame:76-345, calcResAndGS:346-660,
calcEC:660-688, optReg:690-731, propagateUp:733-776, propagateDown:778-811,
resetPoints:1121-1147, doStep:1149-1196, applyStep:1198-1215, makeNN:1249+).

In stereo mode this path is dead code (stereo init completes after frame 0,
FullSystem.cpp:1088-1097; SURVEY.md par. 3.3) — it is provided for capability
parity and for mono operation. The per-point scalar loops become batched
kernels; the nanoflann 10-NN graph becomes the occupancy-grid KNN of
utils/knn.py; each pyramid level's LM runs as one jitted program.

Per-level point capacities derive from the reference densities
{0.03, 0.05, 0.15, 0.5, 1.0} x (w_l * h_l) (setFirstStereo:860).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.config import PATTERN, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS, Settings, default_settings
from stereo_dso_g2o_tpu.models.camera import Calib
from stereo_dso_g2o_tpu.ops.interp import bilinear
from stereo_dso_g2o_tpu.utils import knn, se3
from stereo_dso_g2o_tpu.utils.pytree import dataclass

DENSITIES = (0.03, 0.05, 0.15, 0.5, 1.0)  # CoarseInitializer.cpp:860
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
MAX_ITERATIONS = (5, 5, 10, 30, 50, 50)

# wM state scale (CoarseInitializer.cpp:59-62 — note the reference applies
# SCALE_XI_ROT to the translation rows; kept faithfully)
WM = np.asarray(
    [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B],
    dtype=np.float32,
)


@dataclass
class InitLevel:
    """Fixed-capacity point set of one pyramid level (Pnt, .h:38-97)."""

    valid: jax.Array  # (N,)
    u: jax.Array
    v: jax.Array
    idepth: jax.Array
    idepth_new: jax.Array
    iR: jax.Array
    is_good: jax.Array  # bool
    energy: jax.Array  # (N, 2)
    last_hessian: jax.Array
    max_step: jax.Array
    outlier_th: jax.Array
    my_type: jax.Array
    nn: jax.Array  # (N, 10) neighbour indices (-1 fill)
    parent: jax.Array  # (N,) parent in coarser level (-1 at top)
    Jb: jax.Array  # (N, 10) Schur buffer


class MonoInitializer:
    """Host orchestration: select -> NN graph -> per-frame trackFrame."""

    def __init__(self, calib: Calib, settings: Settings = default_settings()):
        self.calib = calib
        self.settings = settings
        self.levels: List[InitLevel] = []
        self.snapped = False
        self.frame_id = -1
        self.snapped_at = 0
        self.this_to_next = np.eye(4)
        self.this_to_next_aff = np.zeros(2)
        self.dI_first = None

    # -- first frame ----------------------------------------------------
    def set_first(self, dIp, asg):
        """Mono setFirst: select per-level pixels, init idepth=1, build NN."""
        from stereo_dso_g2o_tpu.ops.selector import PixelSelector, map_to_points

        s = self.settings
        n_lvl = self.calib.n_levels
        self.dI_first = dIp
        self.levels = []
        sel = PixelSelector(s)
        for lvl in range(n_lvl):
            w_l, h_l = self.calib.w[lvl], self.calib.h[lvl]
            density = DENSITIES[min(lvl, len(DENSITIES) - 1)] * w_l * h_l
            cap = int(min(w_l * h_l, max(256, int(density * 1.5))))
            if lvl == 0:
                status, _ = sel.make_maps(
                    dIp[0], asg[0], asg[1], asg[2], density
                )
                us, vs, types, valid = map_to_points(status, cap)
            else:
                us, vs, valid = _grid_max_select(dIp[lvl], asg[lvl], cap)
                types = jnp.ones(cap, jnp.int32)
            self.levels.append(_new_level(us, vs, types, valid, s))
        self._make_nn()
        self.snapped = False
        self.frame_id = 0
        self.snapped_at = 0

    def _make_nn(self):
        n_lvl = len(self.levels)
        for lvl in range(n_lvl):
            L = self.levels[lvl]
            w_l, h_l = self.calib.w[lvl], self.calib.h[lvl]
            cell = jnp.float32(max(2.0, np.sqrt(w_l * h_l / max(L.u.shape[0], 1))))
            gh = max(2, int(np.ceil(h_l / 2.0)))
            gw = max(2, int(np.ceil(w_l / 2.0)))
            nn_idx, _ = knn.grid_knn(L.u, L.v, L.valid, cell, gh=gh, gw=gw, k=10)
            parent = jnp.full_like(L.parent, -1)
            if lvl + 1 < n_lvl:
                C = self.levels[lvl + 1]
                wc, hc = self.calib.w[lvl + 1], self.calib.h[lvl + 1]
                cellc = jnp.float32(
                    max(2.0, np.sqrt(wc * hc / max(C.u.shape[0], 1)))
                )
                parent = knn.grid_parent(
                    L.u, L.v, L.valid, C.u, C.v, C.valid, cellc,
                    gh=max(2, int(np.ceil(hc / 2.0))),
                    gw=max(2, int(np.ceil(wc / 2.0))),
                )
            self.levels[lvl] = L.replace(nn=nn_idx, parent=parent)

    # -- per-frame tracking ---------------------------------------------
    def track_frame(self, dI_new_pyr) -> bool:
        """trackFrame: coarse-to-fine joint pose+idepth GN with Schur over
        idepth. Returns snapped && frame_id > snapped_at + 5 (ready)."""
        n_lvl = self.calib.n_levels
        if not self.snapped:
            self.this_to_next = np.eye(4)
            for lvl in range(n_lvl):
                L = self.levels[lvl]
                self.levels[lvl] = L.replace(
                    iR=jnp.ones_like(L.iR),
                    idepth_new=jnp.ones_like(L.idepth_new),
                    last_hessian=jnp.zeros_like(L.last_hessian),
                )

        T = jnp.asarray(self.this_to_next, jnp.float32)
        aff = jnp.asarray(self.this_to_next_aff, jnp.float32)
        snapped_flag = bool(self.snapped)

        for lvl in range(n_lvl - 1, -1, -1):
            if lvl < n_lvl - 1:
                self.levels[lvl] = propagate_down(
                    self.levels[lvl], self.levels[lvl + 1]
                )
            K_lvl = jnp.stack(
                [
                    self.calib.fx(lvl), self.calib.fy(lvl),
                    self.calib.cx(lvl), self.calib.cy(lvl),
                ]
            )
            top = lvl == n_lvl - 1
            L, T, aff, res1, snapped_new = lm_level_init(
                self.levels[lvl], self.dI_first[lvl], dI_new_pyr[lvl], K_lvl,
                T, aff, jnp.asarray(snapped_flag),
                settings=self.settings, top_level=top,
                max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)],
            )
            self.levels[lvl] = L
            snapped_flag = snapped_flag or bool(snapped_new)

        self.this_to_next = np.asarray(T, np.float64)
        self.this_to_next_aff = np.asarray(aff, np.float64)

        for lvl in range(n_lvl - 1):
            up = propagate_up(self.levels[lvl], self.levels[lvl + 1])
            self.levels[lvl + 1] = up

        self.frame_id += 1
        if not snapped_flag:
            self.snapped_at = 0
        if snapped_flag and self.snapped_at == 0 and not self.snapped:
            self.snapped_at = self.frame_id
        self.snapped = snapped_flag
        return self.snapped and self.frame_id > self.snapped_at + 5


def _new_level(us, vs, types, valid, settings: Settings) -> InitLevel:
    n = us.shape[0]
    z = jnp.zeros
    return InitLevel(
        valid=valid,
        u=us.astype(jnp.float32),
        v=vs.astype(jnp.float32),
        idepth=jnp.ones(n, jnp.float32),
        idepth_new=jnp.ones(n, jnp.float32),
        iR=jnp.ones(n, jnp.float32),
        is_good=valid,
        energy=z((n, 2), jnp.float32),
        last_hessian=z(n, jnp.float32),
        max_step=jnp.full(n, 1e10, jnp.float32),
        outlier_th=jnp.full(n, 8.0 * settings.outlier_th, jnp.float32),
        my_type=types,
        nn=jnp.full((n, 10), -1, jnp.int32),
        parent=jnp.full(n, -1, jnp.int32),
        Jb=z((n, 10), jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("cap",))
def _grid_max_select(dI, asg, cap: int):
    """Coarse-level selection: strongest gradient per sparsityFactor-grid cell
    above threshold (PixelSelector.h makePixelStatus/gridMaxSelection)."""
    H, W = asg.shape
    pot = 5  # sparsityFactor (settings.cpp:158)
    hp, wp = H // pot, W // pot
    g = asg[: hp * pot, : wp * pot].reshape(hp, pot, wp, pot)
    g = g.transpose(0, 2, 1, 3).reshape(hp, wp, pot * pot)
    best = jnp.argmax(g, axis=-1)
    val = jnp.max(g, axis=-1)
    med = jnp.median(asg)
    ok = (val > med * 1.5) & (val > 1.0)
    iy = best // pot + jnp.arange(hp)[:, None] * pot
    ix = best % pot + jnp.arange(wp)[None, :] * pot
    flat_ok = ok.ravel()
    idx = jnp.nonzero(flat_ok, size=cap, fill_value=-1)[0]
    valid = idx >= 0
    safe = jnp.maximum(idx, 0)
    return (
        ix.ravel()[safe].astype(jnp.float32),
        iy.ravel()[safe].astype(jnp.float32),
        valid,
    )


def _calc_res_gs(L: InitLevel, dI_ref, dI_new, K_lvl, T, aff, snapped,
                 settings: Settings):
    """calcResAndGS: energies, 8x8 H/b, Schur parts, per-point Jb buffer."""
    fx, fy, cx, cy = K_lvl[0], K_lvl[1], K_lvl[2], K_lvl[3]
    Hd, Wd = dI_new.shape[:2]
    R = T[:3, :3]
    t = T[:3, 3]
    Ki_row0 = jnp.stack([1.0 / fx, jnp.zeros(()), -cx / fx])
    Ki_row1 = jnp.stack([jnp.zeros(()), 1.0 / fy, -cy / fy])
    Ki = jnp.stack([Ki_row0, Ki_row1, jnp.asarray([0.0, 0.0, 1.0], dtype=fx.dtype)])
    RKi = R @ Ki
    a_exp = jnp.exp(aff[0])

    pat = jnp.asarray(PATTERN, dtype=jnp.float32)
    pu = L.u[:, None] + pat[None, :, 0]  # (N, 8)
    pv = L.v[:, None] + pat[None, :, 1]
    P3 = jnp.stack([pu, pv, jnp.ones_like(pu)], -1)
    pt = jnp.einsum("ij,npj->npi", RKi, P3) + t[None, None, :] * L.idepth_new[:, None, None]
    u_n = pt[..., 0] / pt[..., 2]
    v_n = pt[..., 1] / pt[..., 2]
    Ku = fx * u_n + cx
    Kv = fy * v_n + cy
    new_idepth = L.idepth_new[:, None] / pt[..., 2]
    inb = (Ku > 1) & (Kv > 1) & (Ku < Wd - 2) & (Kv < Hd - 2) & (new_idepth > 0)

    hit = bilinear(dI_new, Ku, Kv)  # (N, 8, 3)
    ref_col = bilinear(dI_ref[..., 0], pu, pv)
    residual = hit[..., 0] - a_exp * ref_col - aff[1]
    ar = jnp.abs(residual)
    hw0 = jnp.where(ar < settings.huber_th, 1.0, settings.huber_th / jnp.maximum(ar, 1e-12))
    energy_pix = hw0 * residual * residual * (2.0 - hw0)

    all_ok = jnp.all(inb, axis=1) & L.valid & L.is_good
    energy = jnp.sum(energy_pix, axis=1)
    good_new = all_ok & (energy <= L.outlier_th * 20.0)

    dxdd = (t[0] - t[2] * u_n) / pt[..., 2]
    dydd = (t[1] - t[2] * v_n) / pt[..., 2]
    hw = jnp.where(hw0 < 1.0, jnp.sqrt(hw0), hw0)
    dxI = hw * hit[..., 1] * fx
    dyI = hw * hit[..., 2] * fy
    dp = jnp.stack(
        [
            new_idepth * dxI,
            new_idepth * dyI,
            -new_idepth * (u_n * dxI + v_n * dyI),
            -u_n * v_n * dxI - (1 + v_n * v_n) * dyI,
            (1 + u_n * u_n) * dxI + u_n * v_n * dyI,
            -v_n * dxI + u_n * dyI,
            -hw * a_exp * ref_col,
            -hw,
        ],
        axis=-1,
    )  # (N, 8pix, 8dof)
    dd = dxI * dxdd + dydd * dyI  # (N, 8)
    r = hw * residual

    max_step = 1.0 / jnp.linalg.norm(
        jnp.stack([dxdd * fx, dydd * fy], -1), axis=-1
    ).clip(1e-10)
    max_step = jnp.where(inb, max_step, 1e10).min(axis=1)

    m = good_new.astype(jnp.float32)
    J9 = jnp.concatenate([dp, r[..., None]], axis=-1)  # (N, 8, 9)
    acc9 = jnp.einsum("npi,npj,n->ij", J9, J9, m)

    Jb = jnp.zeros((L.u.shape[0], 10), jnp.float32)
    Jb = Jb.at[:, :8].set(jnp.einsum("npi,np->ni", dp, dd))
    Jb = Jb.at[:, 8].set(jnp.einsum("np,np->n", r, dd))
    Jb = Jb.at[:, 9].set(jnp.einsum("np,np->n", dd, dd))

    # energy bookkeeping: bad points contribute their OLD energy (:385-391)
    E_total = jnp.sum(jnp.where(good_new, energy, jnp.where(L.valid & L.is_good, L.energy[:, 0], 0.0)))
    n_pts = jnp.sum(L.valid)

    # alpha energy (:545-580)
    e1_new = (L.idepth_new - 1.0) ** 2
    E_alpha_pts = jnp.sum(jnp.where(good_new, e1_new, 0.0))
    alpha_energy = ALPHA_W * (
        E_alpha_pts + jnp.sum(t * t) * n_pts
    )
    snap_now = alpha_energy > ALPHA_K * n_pts
    alpha_energy = jnp.minimum(alpha_energy, ALPHA_K * n_pts)
    alpha_opt = jnp.where(snap_now, 0.0, ALPHA_W)

    last_hessian_new = Jb[:, 9]
    Jb = Jb.at[:, 8].add(alpha_opt * (L.idepth_new - 1.0))
    Jb = Jb.at[:, 9].add(alpha_opt)
    coup = jnp.where(alpha_opt == 0.0, COUPLING_WEIGHT, 0.0)
    Jb = Jb.at[:, 8].add(coup * (L.idepth_new - L.iR))
    Jb = Jb.at[:, 9].add(coup)
    Jb = Jb.at[:, 9].set(1.0 / (1.0 + Jb[:, 9]))

    acc9SC = jnp.einsum(
        "ni,nj,n,n->ij",
        jnp.concatenate([Jb[:, :8], Jb[:, 8:9]], axis=1),
        jnp.concatenate([Jb[:, :8], Jb[:, 8:9]], axis=1),
        Jb[:, 9],
        m,
    )

    H = acc9[:8, :8]
    b = acc9[:8, 8]
    Hsc = acc9SC[:8, :8]
    bsc = acc9SC[:8, 8]
    H = H.at[jnp.arange(3), jnp.arange(3)].add(alpha_opt * n_pts)
    tlog = se3.se3_log(T)[:3]
    b = b.at[:3].add(tlog * alpha_opt * n_pts)

    energies = jnp.stack([energy, e1_new], -1)
    f32 = jnp.float32
    out = dict(
        H=H.astype(f32), b=b.astype(f32), Hsc=Hsc.astype(f32),
        bsc=bsc.astype(f32), Jb=Jb.astype(f32),
        E=E_total.astype(f32), alpha=alpha_energy.astype(f32),
        n=n_pts.astype(f32),
        good_new=good_new, energy_new=energies.astype(f32),
        last_hessian_new=last_hessian_new.astype(f32),
        max_step=max_step.astype(f32),
        snap=snap_now & (alpha_energy == ALPHA_K * n_pts),
    )
    return out


def _opt_reg(L: InitLevel, snapped):
    """optReg: iR <- (1-w)*idepth + w*median(neighbour iR) (:690-731)."""
    nn = L.nn
    safe = jnp.maximum(nn, 0)
    n_iR = L.iR[safe]
    ok = (nn >= 0) & L.is_good[safe] & L.valid[safe]
    n_ok = jnp.sum(ok, axis=1)
    vals = jnp.where(ok, n_iR, jnp.inf)
    vals = jnp.sort(vals, axis=1)
    mid = jnp.clip(n_ok // 2, 0, 9)
    med = jnp.take_along_axis(vals, mid[:, None], axis=1)[:, 0]
    new_iR = (1.0 - REG_WEIGHT) * L.idepth + REG_WEIGHT * med
    upd = L.valid & L.is_good & (n_ok > 2)
    iR = jnp.where(upd, new_iR, L.iR)
    iR = jnp.where(snapped, iR, jnp.ones_like(iR))
    return L.replace(iR=iR)


@functools.partial(jax.jit, static_argnames=("settings", "top_level", "max_iterations"))
def lm_level_init(
    L: InitLevel, dI_ref, dI_new, K_lvl, T, aff, snapped,
    settings: Settings = default_settings(), top_level: bool = False,
    max_iterations: int = 10,
):
    """One pyramid level of the initializer's LM (trackFrame STEP4-5)."""
    # resetPoints (:1121-1147)
    L = L.replace(energy=jnp.zeros_like(L.energy), idepth_new=L.idepth)
    if top_level:
        nn = L.nn
        safe = jnp.maximum(nn, 0)
        ok = (nn >= 0) & L.is_good[safe] & L.valid[safe]
        snd = jnp.sum(jnp.where(ok, L.iR[safe], 0.0), axis=1)
        sn = jnp.sum(ok, axis=1)
        revive = L.valid & ~L.is_good & (sn > 0)
        mean_iR = snd / jnp.maximum(sn, 1)
        L = L.replace(
            is_good=L.is_good | revive,
            iR=jnp.where(revive, mean_iR, L.iR),
            idepth=jnp.where(revive, mean_iR, L.idepth),
            idepth_new=jnp.where(revive, mean_iR, L.idepth_new),
        )

    first = _calc_res_gs(L, dI_ref, dI_new, K_lvl, T, aff, snapped, settings)
    # applyStep semantics for the pre-iteration state
    L = _apply(L, first)

    wM = jnp.asarray(WM)

    def body(it, carry):
        L, T, aff, H, b, Hsc, bsc, E_old, lam, fails, done, snapped_c = carry
        Hl = H + jnp.diag(jnp.diag(H)) * lam - Hsc * (1.0 / (1.0 + lam))
        bl = b - bsc * (1.0 / (1.0 + lam))
        npx = dI_new.shape[0] * dI_new.shape[1]
        Hl = wM[:, None] * Hl * wM[None, :] * (0.01 / npx)
        bl = wM * bl * (0.01 / npx)
        inc = -(wM * jnp.linalg.solve(
            Hl + 1e-10 * jnp.eye(8, dtype=Hl.dtype), bl
        ))
        inc = jnp.where(jnp.isfinite(inc), inc, 0.0)

        T_new = se3.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        # doStep (:1149-1196)
        bstep = L.Jb[:, 8] + L.Jb[:, :8] @ inc
        step = -bstep * L.Jb[:, 9] / (1.0 + lam)
        mstep = jnp.minimum(0.25 * L.max_step, 1e10)
        step = jnp.clip(step, -mstep, mstep)
        new_id = jnp.clip(L.idepth + step, 1e-3, 50.0)
        L_try = L.replace(idepth_new=jnp.where(L.is_good, new_id, L.idepth_new))

        res = _calc_res_gs(L_try, dI_ref, dI_new, K_lvl, T_new, aff_new,
                           snapped_c, settings)
        # calcEC regularizer energies (:660-688)
        reg_old = jnp.sum(
            jnp.where(res["good_new"], (L_try.idepth - L_try.iR) ** 2, 0.0)
        ) * COUPLING_WEIGHT
        reg_new = jnp.sum(
            jnp.where(res["good_new"], (L_try.idepth_new - L_try.iR) ** 2, 0.0)
        ) * COUPLING_WEIGHT
        reg_old = jnp.where(snapped_c, reg_old, 0.0)
        reg_new = jnp.where(snapped_c, reg_new, 0.0)

        accept = (E_old[0] + E_old[1] + reg_old) > (res["E"] + res["alpha"] + reg_new)
        accept = accept & ~done

        snapped_c = snapped_c | (accept & res["snap"])
        L_acc = _apply(L_try, res)
        L_acc = _opt_reg(L_acc, snapped_c)
        L_out = jax.tree.map(lambda a, b: jnp.where(accept, b, a), L, L_acc)
        T_out = jnp.where(accept, T_new, T)
        aff_out = jnp.where(accept, aff_new, aff)
        H_out = jnp.where(accept, res["H"], H)
        b_out = jnp.where(accept, res["b"], b)
        Hsc_out = jnp.where(accept, res["Hsc"], Hsc)
        bsc_out = jnp.where(accept, res["bsc"], bsc)
        E_out = jnp.where(
            accept, jnp.stack([res["E"], res["alpha"]]), E_old
        )
        lam_out = jnp.where(
            done, lam,
            jnp.where(accept, jnp.maximum(lam * 0.5, 1e-4), jnp.minimum(lam * 4.0, 1e4)),
        )
        fails_out = jnp.where(done, fails, jnp.where(accept, 0, fails + 1))
        done_out = done | (jnp.linalg.norm(inc) <= 1e-4) | (fails_out >= 2)
        return (L_out, T_out, aff_out, H_out, b_out, Hsc_out, bsc_out,
                E_out, lam_out, fails_out, done_out, snapped_c)

    carry = (
        L, T, aff, first["H"], first["b"], first["Hsc"], first["bsc"],
        jnp.stack([first["E"], first["alpha"]]),
        jnp.asarray(0.1, jnp.float32), jnp.asarray(0), jnp.asarray(False), snapped,
    )
    L, T, aff, _, _, _, _, E_fin, _, _, _, snapped_out = jax.lax.fori_loop(
        0, max_iterations, body, carry
    )
    return L, T, aff, E_fin, snapped_out


def _apply(L: InitLevel, res) -> InitLevel:
    """applyStep (:1198-1215)."""
    good = res["good_new"]
    return L.replace(
        energy=jnp.where(good[:, None], res["energy_new"], L.energy),
        is_good=good,
        idepth=jnp.where(L.is_good, L.idepth_new, L.iR),
        idepth_new=jnp.where(L.is_good, L.idepth_new, L.iR),
        last_hessian=jnp.where(good, res["last_hessian_new"], L.last_hessian),
        max_step=res["max_step"],
        Jb=res["Jb"],
    )


@jax.jit
def propagate_up(src: InitLevel, dst: InitLevel) -> InitLevel:
    """propagateUp: information-weighted idepth pooling into parents."""
    parent = jnp.maximum(src.parent, 0)
    w_src = jnp.where(src.valid & src.is_good & (src.parent >= 0), src.last_hessian, 0.0)
    iR_sum = jnp.zeros_like(dst.iR).at[parent].add(src.iR * w_src)
    w_sum = jnp.zeros_like(dst.iR).at[parent].add(w_src)
    has = w_sum > 0
    new_iR = jnp.where(has, iR_sum / jnp.maximum(w_sum, 1e-12), dst.iR)
    out = dst.replace(
        iR=new_iR,
        idepth=jnp.where(has, new_iR, dst.idepth),
        is_good=dst.is_good | (has & dst.valid),
    )
    return _opt_reg(out, jnp.asarray(True))


@jax.jit
def propagate_down(dst: InitLevel, src: InitLevel) -> InitLevel:
    """propagateDown: parent-informed idepth init for the finer level."""
    parent = jnp.maximum(dst.parent, 0)
    p_good = (dst.parent >= 0) & src.is_good[parent] & (src.last_hessian[parent] >= 0.1)
    p_iR = src.iR[parent]
    p_h = src.last_hessian[parent]

    revive = dst.valid & ~dst.is_good & p_good
    blend = dst.valid & dst.is_good & p_good
    new_iR = (dst.iR * dst.last_hessian * 2 + p_iR * p_h) / jnp.maximum(
        dst.last_hessian * 2 + p_h, 1e-12
    )
    iR = jnp.where(revive, p_iR, jnp.where(blend, new_iR, dst.iR))
    out = dst.replace(
        iR=iR,
        idepth=jnp.where(revive | blend, iR, dst.idepth),
        idepth_new=jnp.where(revive | blend, iR, dst.idepth_new),
        is_good=dst.is_good | revive,
        last_hessian=jnp.where(revive, 0.0, dst.last_hessian),
    )
    return _opt_reg(out, jnp.asarray(True))
