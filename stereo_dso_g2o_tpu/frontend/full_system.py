"""The full stereo direct-SLAM pipeline orchestrator.

JAX rebuild of FullSystem (FullSystem/FullSystem.{h,cpp}): owns the
window state, immature point sets, coarse tracker and selector, and drives
the per-frame pipeline:

  addActiveFrame (:1058) -> trackNewCoarse (:288, retry ladder)
    -> keyframe decision (:1127-1152, flow + affine delta)
    -> makeKeyFrame (:1331) | makeNonKeyFrame (:1309)

makeKeyFrame: temporal trace -> frame flagging -> window insert -> residual
creation -> activation -> windowed BA -> outlier removal -> tracker reference
rebuild (with per-point static-stereo re-verification, makeCoarseDepthL0
STEP1) -> point flagging/marginalization -> new traces -> frame
marginalization.

Initialization is the stereo path (setFirstStereo + initializeFromInitializer,
:1487-1600): frame 0's static-stereo depths seed the first keyframe; the
mono initializer is dead code in stereo mode (SURVEY.md par. 3.3).

The host code here is control flow only — every numeric stage is a jitted
program over fixed-capacity arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.backend import ba, builder
from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.config import Settings, default_settings
from stereo_dso_g2o_tpu.frontend import immature as IMM
from stereo_dso_g2o_tpu.frontend.coarse_tracker import (
    CoarseTracker,
    motion_model_tries,
    rotation_ladder,
)
from stereo_dso_g2o_tpu.models.camera import Calib
from stereo_dso_g2o_tpu.ops import distance_map as DM
from stereo_dso_g2o_tpu.ops import trace as trace_ops
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu.ops.selector import PixelSelector, map_to_points
from stereo_dso_g2o_tpu.utils import se3
from stereo_dso_g2o_tpu.utils.timing import PROF


@dataclasses.dataclass
class FrameShell:
    """util/FrameShell.h:33-70 — lightweight per-frame pose record."""

    id: int
    timestamp: float
    T_cam_to_ref: np.ndarray  # camToTrackingRef
    ref_kf_id: int  # tracking reference keyframe id (-1 for first)
    aff: np.ndarray
    is_kf: bool = False
    T_cw: Optional[np.ndarray] = None  # camToWorld (KFs: updated after BA)


class FullSystem:
    def __init__(self, calib: Calib, settings: Settings = default_settings()):
        self.calib = calib
        self.settings = settings
        F = settings.window_cap
        NP = settings.active_cap + 1024  # slack above the density target
        self.win = W.empty_window(F, NP, np.asarray(calib.c, dtype=np.float32))
        self.imm = IMM.empty(F, settings.immature_cap)
        self.selector = PixelSelector(settings)
        self.tracker = CoarseTracker(calib, settings)
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.log_stream = None  # optional file handle for per-KF stats

        self.history: List[FrameShell] = []
        self.slot_meta = {}  # slot -> (exposure, aff np) host cache
        self.kf_shells: List[FrameShell] = []  # by keyframe id
        self.kf_slots: List[int] = []  # window order oldest..newest
        self.slot_frame_id: dict = {}
        self.kf_out_count = np.zeros(F, dtype=np.int64)  # marg'd+dropped pts
        self.dI_slots = [None] * F  # per-slot full left pyramid (tuple)
        self.right_slots = [None] * F  # per-slot right level-0 dI
        self.current_min_act_dist = 2.0
        self.last_coarse_rmse = np.full(calib.n_levels, np.inf)
        self.first_pair = None  # (dIpL, dIpR) of frame 0 until init
        self.next_kf_id = 0
        self.stats_n_frames = 0

    # ------------------------------------------------------------------
    @property
    def n_levels(self):
        return self.calib.n_levels

    def _dI_stack(self):
        """(F, H, W, 3) stacked level-0 pyramids of window keyframes."""
        H0, W0 = self.calib.h[0], self.calib.w[0]
        mats = []
        for s in range(self.win.F):
            if self.dI_slots[s] is not None:
                mats.append(self.dI_slots[s][0])
            else:
                mats.append(jnp.zeros((H0, W0, 3), jnp.float32))
        return jnp.stack(mats)

    def _dist_ba(self, dI_stack, max_its: int):
        """Windowed BA over a dist_ba_shards-device mesh (Settings opt-in,
        BASELINE config 5): shard the point axis, run the whole GN loop as
        one shard_map program, gather back. The per-KF shard/gather is the
        single-chip-host trade; a resident multi-chip deployment would keep
        the window sharded between keyframes (parallel/dist_ba.py)."""
        import numpy as _np

        from stereo_dso_g2o_tpu.parallel import dist_ba as DBA

        key = ("dist_ba", max_its)
        cache = getattr(self, "_dist_ba_cache", None)
        if cache is None:
            cache = self._dist_ba_cache = {}
        if key not in cache:
            n = self.settings.dist_ba_shards
            devs = jax.devices()
            assert n <= len(devs), (
                f"dist_ba_shards={n} exceeds {len(devs)} devices"
            )
            assert self.win.pt_u.shape[0] % n == 0, (
                "point capacity must divide dist_ba_shards"
            )
            mesh = jax.sharding.Mesh(_np.array(devs[:n]), (DBA.AXIS,))
            run = DBA.sharded_optimize_fused(
                mesh, self.win, settings=self.settings, max_its=max_its
            )
            cache[key] = (mesh, run)
        mesh, run = cache[key]
        from jax.sharding import NamedSharding, PartitionSpec as _P

        win_sh = DBA.shard_window(mesh, self.win)
        dI_rep = jax.device_put(
            dI_stack, NamedSharding(mesh, _P(*([None] * 4)))
        )
        win_sh, energy, nres = run(win_sh, dI_rep)
        # gather back to the default single-device placement
        dev0 = jax.devices()[0]
        win = jax.tree.map(lambda x: jax.device_put(x, dev0), win_sh)
        return win, energy, nres

    def add_frame(self, left, right, frame_id: int, timestamp: float = 0.0,
                  exposure: float = 1.0, exposure_right: float = 1.0):
        """FullSystem::addActiveFrame."""
        if self.is_lost:
            return
        n_lvl = self.n_levels
        # 8-bit inputs transfer as-is (4x less host->device traffic; matches
        # the reference's 8-bit image sources) and are cast on device
        if getattr(left, "dtype", None) == np.uint8:
            left_dev = jnp.asarray(left)
            right_dev = jnp.asarray(right)
        else:
            left_dev = jnp.asarray(left, jnp.float32)
            right_dev = jnp.asarray(right, jnp.float32)

        if not self.initialized:
            # frame 0: store the stereo pair; first KF is created on frame 1
            dIpL, asgL = build_pyramid(left_dev.astype(jnp.float32), n_lvl)
            dIpR, _ = build_pyramid(right_dev.astype(jnp.float32), n_lvl)
            self.first_pair = (dIpL, dIpR, asgL, exposure)
            self.history.append(
                FrameShell(frame_id, timestamp, np.eye(4), -1, np.zeros(2))
            )
            self.initialized = True
            return

        if len(self.kf_slots) == 0:
            # frame 1: build the first keyframe from frame 0's stereo depths,
            # then track frame 1 against it (FullSystem.cpp:305-345 branch)
            self._initialize_first_kf()

        with PROF.section("track_frame"):
            out = self._track_frame(
                left_dev, right_dev, frame_id, timestamp, exposure
            )
        if out is None:
            return
        pyrs, imm_new, best_T, best_aff, flow, achieved, rmse0 = out
        with PROF.section("deliver"):
            self._deliver(
                pyrs, imm_new, best_T, best_aff, flow, achieved, rmse0,
                frame_id, timestamp, exposure,
            )

    # ------------------------------------------------------------------
    def _initialize_first_kf(self):
        """initializeFromInitializer + setFirstStereo condensed: select
        pixels on frame 0, static-stereo trace for idepth, create the first
        keyframe with depth-prior points."""
        s = self.settings
        dIpL, dIpR, asgL, exposure = self.first_pair
        status_map, _ = self.selector.make_maps(
            dIpL[0], asgL[0], asgL[1], asgL[2], s.desired_point_density
        )
        us, vs, types, valid = map_to_points(status_map, s.active_cap)

        color, weights, gradH, eth = trace_ops.extract_point_data(
            dIpL[0], us, vs, s
        )
        n = us.shape[0]
        res, idepth_stereo = trace_ops.trace_stereo(
            us, vs, jnp.zeros(n), jnp.full(n, jnp.nan), color, weights,
            gradH, eth, jnp.full(n, 10000.0),
            jnp.full(n, trace_ops.IPS_UNINITIALIZED, jnp.int32),
            self.calib.K(0), self.calib.baseline, dIpR[0],
            mode_right=True, settings=s,
        )
        good = (
            valid
            & (res.status == trace_ops.IPS_GOOD)
            & jnp.isfinite(res.idepth_min)
            & jnp.isfinite(res.idepth_max)
            & (res.idepth_min >= 0)
            & (res.idepth_max >= 0)
        )

        slot = 0
        kf_id = self.next_kf_id
        self.next_kf_id += 1
        self.win = builder.insert_frame(
            self.win, slot, np.eye(4), (0.0, 0.0), exposure, kf_id
        )
        idx = jnp.arange(n)
        self.win = builder.insert_points(
            self.win, idx, slot, us, vs,
            jnp.where(good, idepth_stereo, 0.0), color, weights, eth,
            has_prior=True,
        )
        # invalidate the failed slots
        self.win = self.win.replace(
            pt_status=self.win.pt_status.at[idx].set(
                jnp.where(good, W.PT_ACTIVE, W.PT_INACTIVE)
            )
        )
        self.dI_slots[slot] = dIpL
        self.right_slots[slot] = dIpR[0]
        self.kf_slots = [slot]
        self.slot_frame_id[slot] = kf_id
        self.slot_meta[slot] = (exposure, np.zeros(2))
        shell = self.history[0]
        shell.is_kf = True
        shell.T_cw = np.eye(4)
        self.kf_shells.append(shell)

        # tracking reference from the fresh stereo points
        # (setCTRefForFirstFrame / makeCoarseDepthForFirstFrame)
        self.tracker.set_reference(
            dIpL, us, vs, jnp.where(good, idepth_stereo, 0.0),
            jnp.ones(n), good, ref_aff=np.zeros(2), ref_exposure=exposure,
            ref_frame_id=kf_id,
        )

    # ------------------------------------------------------------------
    def _track_frame(self, left_dev, right_dev, frame_id, timestamp, exposure):
        """Fused fast path: ONE device program tracks the frame (and runs the
        non-keyframe depth refinement speculatively); the host syncs once on a
        small scalar bundle. The cutoff-repeat machinery runs in-graph inside
        the per-level LM; only a genuinely failed track (still saturated at
        the raised cutoff, or non-finite) falls back to the host cascade."""
        from stereo_dso_g2o_tpu.frontend import frame_step as FS

        s = self.settings
        n_lvl = self.n_levels

        ref_kf_id = self.tracker.ref_frame_id
        if len(self.history) >= 3:
            sl = self.history[-1]
            spl = self.history[-2]
            tries = motion_model_tries(
                self._shell_T_cw(spl), self._shell_T_cw(sl), self._kf_T_cw(ref_kf_id)
            )
            aff_last = sl.aff.copy()
        else:
            tries = [np.eye(4)] + rotation_ladder()
            aff_last = np.zeros(2)

        ref_slot = self.kf_slots[-1]
        if len(tries) == 5:
            # steady state: the WHOLE step (pyramids + try-0 cascade +
            # in-graph retry ladder + speculative depth refinement at the
            # selected pose) is one program with one small sync
            (dIpL, dIpR), imm_new, track, used_ladder = FS.frame_step_full(
                left_dev, right_dev, tuple(self.tracker.ref), self.win,
                self.imm, self.calib.c, self.calib.baseline,
                jnp.asarray(ref_slot),
                jnp.asarray(np.stack(tries), jnp.float32),
                jnp.asarray(aff_last, jnp.float32), self.tracker.ref_aff,
                jnp.float32(self.tracker.ref_exposure), jnp.float32(exposure),
                jnp.float32(self.last_coarse_rmse[0])
                if np.isfinite(self.last_coarse_rmse[0])
                else jnp.float32(1e30),
                settings=s, n_levels=n_lvl, n_tries=5,
            )
            T_np, aff_np, res_np, flow_np, ok_np, sat_np = jax.device_get(
                (track.T, track.aff, track.residuals, track.flow, track.ok,
                 track.sat_frac0)
            )
            if bool(ok_np) and float(sat_np) <= 0.6 and np.isfinite(res_np[0]):
                self.last_coarse_rmse = np.where(
                    np.isfinite(res_np), res_np, self.last_coarse_rmse
                )
                if self.tracker.first_coarse_rmse < 0:
                    self.tracker.first_coarse_rmse = float(res_np[0])
                return (
                    (dIpL, dIpR), imm_new,
                    np.asarray(T_np, np.float64),
                    np.asarray(aff_np, np.float64),
                    np.asarray(flow_np, np.float64),
                    np.asarray(res_np, np.float64),
                    float(res_np[0]),
                )
            # saturated or failed: fall through to the host cascade ladder
            best_T = None
            achieved = np.full(n_lvl, np.nan)
            flow = np.array([100.0, 0.0, 100.0])
            imm_new = None
            for T_try in tries:
                res = self.tracker.track_newest_coarse(
                    dIpL, T_try, aff_last, n_lvl - 1,
                    np.where(np.isfinite(achieved), achieved, np.inf),
                    new_exposure=exposure,
                )
                took = res.ok and np.isfinite(res.residuals[0]) and (
                    not np.isfinite(achieved[0]) or res.residuals[0] < achieved[0]
                )
                if took:
                    best_T = res.T_ref_new
                    best_aff = res.aff
                    flow = res.flow
                if best_T is not None:
                    upd = ~np.isfinite(achieved) | (achieved > res.residuals)
                    achieved = np.where(
                        upd & np.isfinite(res.residuals), res.residuals, achieved
                    )
                if (
                    best_T is not None
                    and achieved[0] < self.last_coarse_rmse[0] * s.re_track_threshold
                ):
                    break
        else:
            # initialization frame: big rotation ladder via the fused cascade
            abort_inf = jnp.full(n_lvl, jnp.inf, jnp.float32)
            (dIpL, dIpR), imm_spec, track = FS.frame_step(
                left_dev, right_dev, tuple(self.tracker.ref), self.win,
                self.imm, self.calib.c, self.calib.baseline,
                jnp.asarray(ref_slot), jnp.asarray(tries[0], jnp.float32),
                jnp.asarray(aff_last, jnp.float32), self.tracker.ref_aff,
                jnp.float32(self.tracker.ref_exposure), jnp.float32(exposure),
                abort_inf, settings=s, n_levels=n_lvl, is_kf=False,
            )
            T_np, aff_np, res_np, flow_np, ok_np, sat_np = jax.device_get(
                (track.T, track.aff, track.residuals, track.flow, track.ok,
                 track.sat_frac0)
            )
            achieved = np.full(n_lvl, np.nan)
            best_T = None
            flow = np.array([100.0, 0.0, 100.0])
            imm_new = None
            if bool(ok_np) and np.isfinite(res_np[0]) and float(sat_np) <= 0.6:
                best_T = np.asarray(T_np, np.float64)
                best_aff = np.asarray(aff_np, np.float64)
                flow = np.asarray(flow_np, np.float64)
                achieved = np.where(np.isfinite(res_np), res_np, np.nan)
                imm_new = imm_spec
            if not (
                best_T is not None
                and achieved[0] < self.last_coarse_rmse[0] * s.re_track_threshold
            ) and len(tries) > 1:
                for chunk in range(1, len(tries), 8):
                    sub = tries[chunk : chunk + 8]
                    while len(sub) < 8:
                        sub = sub + [np.eye(4)]
                    abort = jnp.asarray(
                        np.where(np.isfinite(achieved), achieved, np.inf),
                        jnp.float32,
                    )
                    trb = FS.cascade_batch(
                        dIpL, tuple(self.tracker.ref), self.calib.c,
                        self.calib.baseline,
                        jnp.asarray(np.stack(sub), jnp.float32),
                        jnp.asarray(aff_last, jnp.float32), self.tracker.ref_aff,
                        jnp.float32(self.tracker.ref_exposure),
                        jnp.float32(exposure), abort, settings=s, n_levels=n_lvl,
                    )
                    Tb, ab, rb, fb, okb = jax.device_get(
                        (trb.T, trb.aff, trb.residuals, trb.flow, trb.ok)
                    )
                    done = False
                    for k in range(len(sub)):
                        took = bool(okb[k]) and np.isfinite(rb[k, 0]) and (
                            not np.isfinite(achieved[0]) or rb[k, 0] < achieved[0]
                        )
                        if took:
                            best_T = np.asarray(Tb[k], np.float64)
                            best_aff = np.asarray(ab[k], np.float64)
                            flow = np.asarray(fb[k], np.float64)
                            imm_new = None
                        if best_T is not None:
                            upd = ~np.isfinite(achieved) | (achieved > rb[k])
                            achieved = np.where(
                                upd & np.isfinite(rb[k]), rb[k], achieved
                            )
                        if (
                            best_T is not None
                            and achieved[0]
                            < self.last_coarse_rmse[0] * s.re_track_threshold
                        ):
                            done = True
                            break
                    if done:
                        break

        if best_T is None:
            # take predicted pose and hope (FullSystem.cpp:503-508)
            best_T = tries[0]
            best_aff = aff_last
            flow = np.zeros(3)
            coarse_rmse0 = np.inf
        else:
            coarse_rmse0 = achieved[0]
            self.last_coarse_rmse = np.where(
                np.isfinite(achieved), achieved, self.last_coarse_rmse
            )
            if self.tracker.first_coarse_rmse < 0:
                self.tracker.first_coarse_rmse = coarse_rmse0

        if not np.all(np.isfinite(best_T)):
            self.is_lost = True
            return None
        return (dIpL, dIpR), imm_new, best_T, best_aff, flow, achieved, coarse_rmse0

    def _deliver(self, pyrs, imm_new, best_T, best_aff, flow, achieved,
                 coarse_rmse0, frame_id, timestamp, exposure):
        s = self.settings
        dIpL, dIpR = pyrs
        self.last_coarse_rmse = np.where(
            np.isfinite(achieved), achieved, self.last_coarse_rmse
        )
        if self.tracker.first_coarse_rmse < 0:
            self.tracker.first_coarse_rmse = coarse_rmse0

        shell = FrameShell(
            frame_id, timestamp, np.linalg.inv(best_T), self.tracker.ref_frame_id,
            np.asarray(best_aff, dtype=np.float64),
        )
        self.history.append(shell)

        # keyframe decision (:1127-1152) — all inputs are host-cached
        ref_slot = self.kf_slots[-1]
        ref_exp, ref_aff = self.slot_meta[ref_slot]
        a_rel = (
            np.exp(best_aff[0] - ref_aff[0]) * exposure / max(ref_exp, 1e-9)
        )
        wh = self.calib.w[0] + self.calib.h[0]
        delta = (
            s.kf_global_weight * s.max_shift_weight_t * np.sqrt(max(flow[0], 0)) / wh
            + s.kf_global_weight * s.max_shift_weight_r * np.sqrt(max(flow[1], 0)) / wh
            + s.kf_global_weight * s.max_shift_weight_rt * np.sqrt(max(flow[2], 0)) / wh
            + s.kf_global_weight * s.max_affine_weight * abs(np.log(max(a_rel, 1e-9)))
        )
        need_kf = (
            len(self.history) == 2
            or delta > 1.0
            or 2.0 * self.tracker.first_coarse_rmse < coarse_rmse0
        )

        self.stats_n_frames += 1
        if need_kf:
            # the speculative non-KF depth refinement is discarded (imm is a
            # functional pytree: the pre-step state is still at hand)
            self._make_keyframe(dIpL, dIpR, shell, best_T, best_aff, exposure)
        else:
            if imm_new is not None:
                self.imm = imm_new  # fused step already refined depths
            else:
                self._make_non_keyframe(dIpL, dIpR, shell, best_T, best_aff, exposure)

    # ------------------------------------------------------------------
    def _shell_T_cw(self, shell: FrameShell):
        """camToWorld composed through the (BA-updated) tracking reference."""
        if shell.is_kf and shell.T_cw is not None:
            return shell.T_cw
        if shell.ref_kf_id < 0:
            return shell.T_cam_to_ref
        return self._kf_T_cw_world(shell.ref_kf_id) @ shell.T_cam_to_ref

    def _kf_T_cw_world(self, kf_id):
        return self.kf_shells[kf_id].T_cw

    def _kf_T_cw(self, kf_id):
        """worldToCam... naming: returns camToWorld of the keyframe."""
        return self.kf_shells[kf_id].T_cw

    def _make_non_keyframe(self, dIpL, dIpR, shell, T_ref_new, aff, exposure):
        """makeNonKeyFrame: temporal + stereo depth refinement only (one
        fused device call; transforms computed in-graph)."""
        from stereo_dso_g2o_tpu.frontend import frame_step as FS

        self.imm = FS.nonkey_refine_step(
            self.win, self.imm, dIpL[0], dIpR[0], self.calib.c,
            self.calib.baseline, jnp.asarray(self.kf_slots[-1]),
            jnp.asarray(T_ref_new, jnp.float32),
            jnp.asarray(aff, jnp.float32), jnp.float32(exposure),
            settings=self.settings, n_levels=self.n_levels,
        )

    # ------------------------------------------------------------------
    def _make_keyframe(self, dIpL, dIpR, shell, T_ref_new, aff, exposure):
        s = self.settings
        F = self.win.F
        ref_T_cw = self._kf_T_cw(shell.ref_kf_id)
        T_new_w2c = T_ref_new @ np.linalg.inv(ref_T_cw)

        # STEP 1: temporal trace of every immature point onto the new KF
        from stereo_dso_g2o_tpu.frontend import frame_step as FS0

        with PROF.section("kf.trace", lambda: self.imm):
            self.imm = FS0.kf_trace_step(
                self.win, self.imm, dIpL[0], self.calib.c,
                self.calib.baseline, jnp.asarray(T_new_w2c, jnp.float32),
                jnp.asarray(aff, jnp.float32), jnp.float32(exposure),
                settings=s, n_levels=self.n_levels,
            )

        # STEP 2: flag frames for marginalization (host-side policy)
        with PROF.section("kf.flag_frames"):
            flagged = self._flag_frames()

        # STEP 3: insert the new KF into the window
        slot = self._free_slot()
        kf_id = self.next_kf_id
        self.next_kf_id += 1
        self.win = builder.insert_frame(
            self.win, slot, T_new_w2c, tuple(np.asarray(aff)), exposure, kf_id
        )
        self.dI_slots[slot] = dIpL
        self.right_slots[slot] = dIpR[0]
        self.kf_slots.append(slot)
        self.slot_frame_id[slot] = kf_id
        self.slot_meta[slot] = (exposure, np.asarray(best_aff := np.asarray(aff, np.float64)))
        shell.is_kf = True
        shell.T_cw = np.linalg.inv(T_new_w2c)
        self.kf_shells.append(shell)

        # STEP 4: residuals from every active point to the new KF
        active_pts = self.win.pt_status == W.PT_ACTIVE
        self.win = self.win.replace(
            res_exists=self.win.res_exists.at[:, slot].set(active_pts),
            res_state=self.win.res_state.at[:, slot].set(W.RES_IN),
            res_linearized=self.win.res_linearized.at[:, slot].set(False),
        )

        dI_stack = self._dI_stack()

        # STEP 5: activate points
        with PROF.section("kf.activate", lambda: self.win):
            self._activate_points(dI_stack, slot)

        # STEP 6: windowed BA
        max_its = s.max_opt_iterations
        if len(self.kf_slots) < 3:
            max_its = 20
        elif len(self.kf_slots) < 4:
            max_its = 15
        with PROF.section("kf.ba", lambda: self.win):
            if s.dist_ba_shards > 1:
                self.win, energy, nres = self._dist_ba(dI_stack, max_its)
            else:
                self.win, energy, nres = ba.optimize_fused(
                    self.win, dI_stack, settings=s, max_its=max_its
                )
        if s.log_eigenvalues and self.log_stream is not None:
            import json as _json

            from stereo_dso_g2o_tpu.runtime.diagnostics import eigenvalue_record

            rec = eigenvalue_record(self.win, settings=s)
            rec["kf_id"] = kf_id
            self.log_stream.write(_json.dumps(rec) + "\n")
        # STEPS 7-8 + final linearization: one fused program
        from stereo_dso_g2o_tpu.frontend import frame_step as FS
        prev_slot = self.kf_slots[-2] if len(self.kf_slots) >= 2 else -1
        with PROF.section("kf.finalize", lambda: self.win):
            self.win, ref_inputs, gone_dev, w2c_dev, aff_dev, _, _stats = \
                FS.kf_finalize(
                self.win, dI_stack, self.dI_slots[slot][0],
                self.right_slots[slot], jnp.asarray(slot),
                jnp.asarray(flagged), jnp.asarray(prev_slot),
                self.calib.c, self.calib.baseline,
                settings=s, n_levels=self.n_levels,
            )
        # ONE host fetch for shells + stats
        gone, w2c, aff_all, pt_host_np, energy_np, nres_np = jax.device_get(
            (gone_dev, w2c_dev, aff_dev, self.win.pt_host, energy, nres)
        )
        # initialization-failure check (FullSystem.cpp:1404-1418; rmse as in
        # statistics_lastFineTrackRMSE, slack factor = 2)
        rmse = float(np.sqrt(max(energy_np, 0.0) / max(8.0 * nres_np, 1.0)))
        n_kfs_hist = len(self.kf_shells)
        slack = 2.0
        if n_kfs_hist <= 4 and (
            (n_kfs_hist == 2 and rmse > 20 * slack)
            or (n_kfs_hist == 3 and rmse > 13 * slack)
            or (n_kfs_hist == 4 and rmse > 9 * slack)
        ):
            self.init_failed = True
        if not np.isfinite(energy_np):
            self.is_lost = True
        if self.log_stream is not None:
            import json as _json

            self.log_stream.write(
                _json.dumps(
                    {
                        "type": "kf",
                        "kf_id": self.slot_frame_id[slot],
                        "frame_id": shell.id,
                        "rmse": rmse,
                        "energy": float(energy_np),
                        "n_res": int(nres_np),
                        "n_points": int(np.asarray(
                            (self.win.pt_status == W.PT_ACTIVE)
                        ).sum()),
                        "n_kfs": len(self.kf_slots),
                        "marg_points": int(np.asarray(gone).sum()),
                    }
                )
                + "\n"
            )
        w2c = np.asarray(w2c, np.float64)
        aff_all = np.asarray(aff_all, np.float64)
        for s_ in self.kf_slots:
            kid = self.slot_frame_id[s_]
            self.kf_shells[kid].T_cw = np.linalg.inv(w2c[s_])
            self.kf_shells[kid].aff = aff_all[s_]
            self.slot_meta[s_] = (self.slot_meta[s_][0], aff_all[s_])
        np.add.at(self.kf_out_count, pt_host_np[np.asarray(gone)], 1)

        us_r, vs_r, id_r, w_r, sel_r = ref_inputs
        self.tracker.set_reference(
            self.dI_slots[slot], us_r, vs_r, id_r, w_r, sel_r,
            ref_aff=aff_all[slot],
            ref_exposure=self.slot_meta[slot][0],
            ref_frame_id=self.slot_frame_id[slot],
        )

        # STEP 9: seed new immature points on the new KF (makeNewTraces)
        with PROF.section("kf.new_traces", lambda: self.imm):
            asg = build_pyramid(dIpL[0][..., 0], 3)[1]
            status_map, _ = self.selector.make_maps(
                dIpL[0], asg[0], asg[1], asg[2], s.desired_immature_density
            )
            us, vs, types, valid = map_to_points(status_map, s.immature_cap)
            self.imm = IMM.seed_slot(
                self.imm, slot, dIpL[0], us, vs, types, valid, settings=s
            )

        # STEP 10: marginalize flagged frames — ONE masked device program for
        # all of them (drop refs + Schur eliminations), host bookkeeping after
        with PROF.section("kf.marg_frames", lambda: self.win):
            if flagged.any():
                self.win = ba.marginalize_frames_masked(
                    self.win, jnp.asarray(flagged), settings=s
                )
                self.imm = self.imm.replace(
                    valid=self.imm.valid & ~jnp.asarray(flagged)[:, None]
                )
                for s_ in list(self.kf_slots):
                    if flagged[s_]:
                        self._forget_slot(s_)

    # ------------------------------------------------------------------
    def _free_slot(self) -> int:
        fv = np.asarray(self.win.frame_valid)
        free = np.nonzero(~fv)[0]
        assert len(free) > 0, "window capacity exceeded"
        return int(free[0])

    def _flag_frames(self) -> np.ndarray:
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:59-145)."""
        s = self.settings
        F = self.win.F
        flagged = np.zeros(F, dtype=bool)
        if len(self.kf_slots) < 2:
            return flagged

        pt_status, pt_host, imm_valid, aff_all, exps = jax.device_get(
            (self.win.pt_status, self.win.pt_host, self.imm.valid,
             self.win.aff_g2l(), self.win.ab_exposure)
        )
        aff_all = np.asarray(aff_all, np.float64)
        exps = np.asarray(exps, np.float64)
        n_flagged = 0
        n_kfs = len(self.kf_slots)
        # affine gap is measured against the newest WINDOW keyframe
        # (frameHessians.back(), FullSystemMarginalize.cpp:83-88) — flagging
        # runs before the incoming KF joins the window
        back = self.kf_slots[-1]

        for s_ in self.kf_slots:
            n_in = int(((pt_status == W.PT_ACTIVE) & (pt_host == s_)).sum()) + int(
                imm_valid[s_].sum()
            )
            n_out = int(self.kf_out_count[s_])
            a_rel = (
                np.exp(aff_all[s_, 0] - aff_all[back, 0])
                * exps[s_]
                / max(exps[back], 1e-9)
            )
            if (
                n_in < s.min_points_remaining * (n_in + n_out)
                or abs(np.log(max(a_rel, 1e-12))) > s.max_log_aff_fac_in_window
            ) and (n_kfs - n_flagged > s.min_frames):
                flagged[s_] = True
                n_flagged += 1

        # distance-score marginalization when the window is (over)full
        # (note: the new KF is inserted after flagging, hence the +1)
        if n_kfs + 1 - n_flagged >= s.max_frames + 1:
            w2c = np.asarray(self.win.w2c(), dtype=np.float64)
            latest = self.kf_slots[-1]
            latest_id = self.slot_frame_id[latest]
            best_score = 1.0
            best_slot = None
            for s_ in self.kf_slots:
                fid = self.slot_frame_id[s_]
                if fid > latest_id - s.min_frame_age or fid == 0:
                    continue
                dist_score = 0.0
                for t_ in self.kf_slots:
                    tid = self.slot_frame_id[t_]
                    if tid > latest_id - s.min_frame_age + 1 or t_ == s_:
                        continue
                    d = np.linalg.norm(
                        (w2c[t_] @ np.linalg.inv(w2c[s_]))[:3, 3]
                    )
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(
                    (w2c[latest] @ np.linalg.inv(w2c[s_]))[:3, 3]
                )
                dist_score *= -np.sqrt(max(d_latest, 1e-12))
                if dist_score < best_score:
                    best_score = dist_score
                    best_slot = s_
            if best_slot is not None:
                flagged[best_slot] = True
        return flagged

    # ------------------------------------------------------------------
    def _activate_points(self, dI_stack, newest_slot):
        """activatePointsMT."""
        s = self.settings
        n_active = int(np.asarray(self.win.pt_status == W.PT_ACTIVE).sum())
        d = s.desired_point_density
        if n_active < d * 0.66:
            self.current_min_act_dist -= 0.8
        if n_active < d * 0.8:
            self.current_min_act_dist -= 0.5
        elif n_active < d * 0.9:
            self.current_min_act_dist -= 0.2
        elif n_active < d:
            self.current_min_act_dist -= 0.1
        if n_active > d * 1.5:
            self.current_min_act_dist += 0.8
        if n_active > d * 1.3:
            self.current_min_act_dist += 0.5
        if n_active > d * 1.15:
            self.current_min_act_dist += 0.2
        if n_active > d:
            self.current_min_act_dist += 0.1
        self.current_min_act_dist = float(
            np.clip(self.current_min_act_dist, 0.0, 4.0)
        )

        # fused candidate gate (projection + distance map + rules)
        import time as _t
        _t0 = _t.perf_counter()
        pre = W.precalc(self.win)
        h1, w1 = self.calib.h[1], self.calib.w[1]
        cand_flat, delete = IMM.activation_gate(
            self.win, self.imm, jnp.asarray(newest_slot),
            jnp.asarray(self.current_min_act_dist, jnp.float32),
            self.calib.c, settings=s, h1=h1, w1=w1,
        )
        PROF.tick("kf.act.gate", _t0, cand_flat); _t0 = _t.perf_counter()

        self.imm = self.imm.replace(valid=self.imm.valid & ~delete)

        act = IMM.optimize_immature(
            self.imm, cand_flat, pre["RTll"], pre["tTll"], pre["aff"],
            self.win.frame_valid, dI_stack, self.win.c_value, settings=s,
        )

        PROF.tick("kf.act.optimize", _t0, act); _t0=_t.perf_counter()
        # device-side fixed-shape insertion (compiles once)
        self.win, self.imm, n_ins = IMM.insert_activated(
            self.win, self.imm, act, settings=s
        )
        PROF.tick("kf.act.insert", _t0, self.win)

    # ------------------------------------------------------------------
    def _marginalize_frame(self, slot):
        """marginalizeFrame: drop residuals targeting the frame, drop its
        hosted points (already flagged via host_flagged), Schur-eliminate.
        (Single-slot path; the keyframe pass uses the fused masked program.)"""
        self.win = ba.drop_frame_refs(self.win, jnp.asarray(slot))
        self.win = ba.marginalize_frame(
            self.win, jnp.asarray(slot), settings=self.settings
        )
        self.imm = IMM.clear_slot(self.imm, slot)
        self._forget_slot(slot)

    def _forget_slot(self, slot):
        """Host bookkeeping of a marginalized window slot."""
        self.dI_slots[slot] = None
        self.right_slots[slot] = None
        self.kf_slots.remove(slot)
        self.kf_out_count[slot] = 0
        del self.slot_frame_id[slot]
        self.slot_meta.pop(slot, None)

    # ------------------------------------------------------------------
    def trajectory(self):
        """KITTI-convention trajectory: camToWorld per frame, composed through
        the final keyframe poses (printResult, FullSystem.cpp:236-285)."""
        out = []
        for shell in self.history:
            out.append(self._shell_T_cw(shell))
        return out

    def point_cloud(self):
        """World-space 3D positions of the window's active points — the data
        the reference's viewer renders per keyframe (PangolinDSOViewer's
        KeyFrameDisplay, KeyFrameDisplay.cpp:102-173). Returns a dict with
        'xyz' (N, 3), 'idepth' (N,), 'host_kf_id' (N,)."""
        return window_point_cloud(self.win, self.calib, self.slot_frame_id)


def window_point_cloud(win, calib, slot_frame_id):
    """World-space 3D positions of a window's active points (shared by the
    host FullSystem and the fused GraphSystem; reference capability:
    KeyFrameDisplay.cpp:102-173)."""
    from stereo_dso_g2o_tpu.config import SCALE_IDEPTH

    status = np.asarray(win.pt_status)
    sel = status == W.PT_ACTIVE
    if not sel.any():
        return {"xyz": np.zeros((0, 3)), "idepth": np.zeros(0),
                "host_kf_id": np.zeros(0, int)}
    u = np.asarray(win.pt_u, np.float64)[sel]
    v = np.asarray(win.pt_v, np.float64)[sel]
    idp = np.asarray(win.pt_idepth, np.float64)[sel] * SCALE_IDEPTH
    host = np.asarray(win.pt_host)[sel]
    ok = idp > 1e-6
    u, v, idp, host = u[ok], v[ok], idp[ok], host[ok]
    fx, fy, cx, cy = np.asarray(calib.c, np.float64)
    Xc = np.stack([(u - cx) / fx / idp, (v - cy) / fy / idp, 1.0 / idp], -1)
    w2c = np.asarray(win.w2c(), np.float64)
    c2w = np.array([np.linalg.inv(w2c[s_]) for s_ in range(win.F)])
    R = c2w[host][:, :3, :3]
    t = c2w[host][:, :3, 3]
    xyz = np.einsum("nij,nj->ni", R, Xc) + t
    kf_ids = np.array(
        [slot_frame_id.get(int(s_), -1) for s_ in host], int
    )
    return {"xyz": xyz, "idepth": idp, "host_kf_id": kf_ids}
