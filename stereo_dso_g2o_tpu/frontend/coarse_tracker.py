"""Coarse tracker: direct pyramid image alignment against the last keyframe.

JAX rebuild of CoarseTracker::setCoarseTrackingRef /
trackNewestCoarse (CoarseTracker.cpp:807-1069) with the legacy LM semantics
(the fork's g2o detour replaced by the batched kernels in ops/tracker_ops.py),
plus the retry-ladder pose initialization of FullSystem::trackNewCoarse
(FullSystem.cpp:288-530).

Host-side responsibilities (control-flow only): the level cascade with the
cutoff-repeat and abort rules, and the multi-hypothesis retry ladder. All
numeric work is jitted.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.config import Settings, default_settings
from stereo_dso_g2o_tpu.models.camera import Calib
from stereo_dso_g2o_tpu.ops import tracker_ops
from stereo_dso_g2o_tpu.utils import se3

# Legacy DSO per-level iteration caps (CoarseTracker.cpp:861 commented
# original); extended for deeper pyramids.
MAX_ITERATIONS = (10, 20, 50, 50, 50, 50)


def level_caps(calib: Calib) -> List[int]:
    """Fixed capacities for the compacted per-level reference point lists.

    The level-0 semi-dense map holds ~#active points x (1 + dilation) ~ 4-8K
    entries at preset-0 densities (makeCoarseDepthL0 splat + 1 dilation pass);
    capacities sized accordingly — oversizing directly multiplies the
    tracker's per-iteration warp cost."""
    caps = []
    for lvl in range(calib.n_levels):
        area = calib.w[lvl] * calib.h[lvl]
        caps.append(int(min(area, max(512, 8192 >> max(lvl - 2, 0)))))
    return caps


class TrackResult(NamedTuple):
    ok: bool
    T_ref_new: np.ndarray  # (4,4)
    aff: np.ndarray  # (2,)
    residuals: np.ndarray  # (L,) per-level sqrt(E/n); NaN where not evaluated
    flow: np.ndarray  # (3,) flow indicators (T, 0, RT) — KF decision input


class CoarseTracker:
    def __init__(self, calib: Calib, settings: Settings = default_settings()):
        self.calib = calib
        self.settings = settings
        self.caps = level_caps(calib)
        self.ref = None  # per-level compacted lists
        self.ref_aff = jnp.zeros(2, jnp.float32)
        self.ref_exposure = 1.0
        self.first_coarse_rmse = -1.0
        self.ref_frame_id = -1

    # -- reference construction ---------------------------------------------
    def set_reference(
        self,
        dI_ref_pyr,
        us,
        vs,
        idepths,
        weights,
        valid,
        ref_aff=None,
        ref_exposure: float = 1.0,
        ref_frame_id: int = -1,
    ):
        """Build the semi-dense tracking reference from splatted points
        (makeCoarseDepthL0 STEP2-5; STEP1's stereo re-verification happens in
        the FullSystem before calling this)."""
        n_levels = self.calib.n_levels
        id_maps, valid_maps, color_maps = tracker_ops.build_ref_maps(
            us, vs, idepths, weights, valid, n_levels=n_levels, dI_ref=dI_ref_pyr
        )
        self.ref = []
        for lvl in range(n_levels):
            self.ref.append(
                tracker_ops.compact_ref_level(
                    id_maps[lvl], valid_maps[lvl], color_maps[lvl], self.caps[lvl]
                )
            )
        self.ref_aff = (
            jnp.zeros(2, jnp.float32)
            if ref_aff is None
            else jnp.asarray(ref_aff, dtype=jnp.float32)
        )
        self.ref_exposure = float(ref_exposure)
        self.first_coarse_rmse = -1.0
        self.ref_frame_id = ref_frame_id

    # -- tracking ------------------------------------------------------------
    def track_newest_coarse(
        self,
        dI_new_pyr,
        T_init: np.ndarray,
        aff_init: np.ndarray,
        coarsest_lvl: int,
        min_res_for_abort: np.ndarray,
        new_exposure: float = 1.0,
    ) -> TrackResult:
        """Pyramid LM alignment (trackNewestCoarse, legacy semantics)."""
        s = self.settings
        n_levels = self.calib.n_levels
        assert coarsest_lvl < n_levels
        residuals = np.full(n_levels, np.nan, dtype=np.float64)
        flow = np.array([100.0, 0.0, 100.0])

        T = jnp.asarray(T_init, dtype=jnp.float32)
        aff = jnp.asarray(aff_init, dtype=jnp.float32)

        # the cutoff-repeat machinery (legacy :891-906, :1036-1041) runs
        # inside lm_level's graph — one dispatch per level
        have_repeated = False
        for lvl in range(coarsest_lvl, -1, -1):
            K_lvl = jnp.stack(
                [
                    self.calib.fx(lvl),
                    self.calib.fy(lvl),
                    self.calib.cx(lvl),
                    self.calib.cy(lvl),
                ]
            )
            pc_u, pc_v, pc_id, pc_color, pc_ok = self.ref[lvl]
            out = tracker_ops.lm_level(
                pc_u,
                pc_v,
                pc_id,
                pc_color,
                pc_ok,
                dI_new_pyr[lvl],
                K_lvl,
                T,
                aff,
                self.ref_aff,
                jnp.float32(self.ref_exposure),
                jnp.float32(new_exposure),
                jnp.asarray(have_repeated),
                settings=s,
                max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)],
            )
            have_repeated = have_repeated or bool(out.repeated)

            T_new, aff_new = out.T, out.aff
            res = float(out.res_per_point)
            residuals[lvl] = res
            if lvl == 0:
                flow = np.array([float(out.flow_t), 0.0, float(out.flow_rt)])

            if not np.isfinite(res):
                return TrackResult(False, np.asarray(T), np.asarray(aff), residuals, flow)
            if res > 1.5 * min_res_for_abort[lvl]:
                return TrackResult(False, np.asarray(T), np.asarray(aff), residuals, flow)
            # coverage guard (see frame_step.track_cascade): reject poses
            # that drop (nearly) every reference point out of view; fine
            # levels only — tiny top levels are legitimately empty no-ops
            if lvl <= 2:
                n_ref = int(np.asarray(pc_ok).sum())
                if int(out.num_terms) < max(10, int(0.25 * n_ref)):
                    return TrackResult(
                        False, np.asarray(T), np.asarray(aff), residuals, flow
                    )

            T, aff = T_new, aff_new

        aff_np = np.asarray(aff, dtype=np.float64)
        # affine sanity gates (:1075-1095)
        if (s.affine_opt_mode_a != 0 and abs(aff_np[0]) > 1.2) or (
            s.affine_opt_mode_b != 0 and abs(aff_np[1]) > 200
        ):
            return TrackResult(False, np.asarray(T), aff_np, residuals, flow)
        rel_a = (
            np.exp(aff_np[0] - float(self.ref_aff[0]))
            * new_exposure
            / self.ref_exposure
        )
        rel_b = aff_np[1] - rel_a * float(self.ref_aff[1])
        if (s.affine_opt_mode_a == 0 and abs(np.log(max(rel_a, 1e-12))) > 1.5) or (
            s.affine_opt_mode_b == 0 and abs(rel_b) > 200
        ):
            return TrackResult(False, np.asarray(T), aff_np, residuals, flow)
        if s.affine_opt_mode_a < 0:
            aff_np[0] = 0.0
        if s.affine_opt_mode_b < 0:
            aff_np[1] = 0.0

        return TrackResult(True, np.asarray(T, dtype=np.float64), aff_np, residuals, flow)


def rotation_ladder(n_levels_unused: int = 0) -> List[np.ndarray]:
    """The 26-rotation perturbation set used for frame-1 initialization
    (FullSystem.cpp:313-341), as 4x4 matrices from unnormalized quaternions
    (1, +-d, +-d, +-d) with d in {0.02, 0.04}."""
    out = []
    for d in (0.02, 0.04):
        combos = [
            (d, 0, 0), (0, d, 0), (0, 0, d), (-d, 0, 0), (0, -d, 0), (0, 0, -d),
            (d, d, 0), (0, d, d), (d, 0, d), (-d, d, 0), (0, -d, d), (-d, 0, d),
            (d, -d, 0), (0, d, -d), (d, 0, -d), (-d, -d, 0), (0, -d, -d),
            (-d, 0, -d), (-d, -d, -d), (-d, -d, d), (-d, d, -d), (-d, d, d),
            (d, -d, -d), (d, -d, d), (d, d, -d), (d, d, d),
        ]
        for (qx, qy, qz) in combos:
            q = np.array([1.0, qx, qy, qz])
            q = q / np.linalg.norm(q)
            w, x, y, z = q
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            T = np.eye(4)
            T[:3, :3] = R
            out.append(T)
    return out


def motion_model_tries(
    T_world_sprelast: Optional[np.ndarray],
    T_world_slast: Optional[np.ndarray],
    T_world_lastF: np.ndarray,
) -> List[np.ndarray]:
    """Pose hypotheses lastF->fh for an ordinary frame (FullSystem.cpp:349-377):
    constant motion, double, half, zero motion, zero from KF."""
    inv = np.linalg.inv
    if T_world_sprelast is None or T_world_slast is None:
        return [np.eye(4)]
    slast_2_sprelast = inv(T_world_sprelast) @ T_world_slast
    lastF_2_slast = inv(T_world_slast) @ T_world_lastF
    fh_2_slast = slast_2_sprelast  # constant-velocity assumption

    half = np.asarray(
        se3.se3_exp(0.5 * se3.se3_log(jnp.asarray(fh_2_slast))), dtype=np.float64
    )
    return [
        inv(fh_2_slast) @ lastF_2_slast,
        inv(fh_2_slast) @ inv(fh_2_slast) @ lastF_2_slast,
        inv(half) @ lastF_2_slast,
        lastF_2_slast,
        np.eye(4),
    ]
