"""MODE_STEREOMATCH: static-stereo inverse-depth map computation.

JAX rebuild of FullSystem::stereoMatch (FullSystem.cpp:549-630) — the
idepth-map-only workload (BASELINE config 3): select high-gradient pixels,
trace each one left->right along the horizontal epipolar line, verify by the
reverse right->left trace (|u - u_back| < 1, 0 < depth < 70), and emit
(idepth, idepth_min, idepth_max) per accepted point.

The per-point loop becomes two batched trace calls over the full fixed-
capacity point set; the L->R / R->L consistency gate is pure elementwise masking.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.config import Settings, default_settings
from stereo_dso_g2o_tpu.models.camera import Calib
from stereo_dso_g2o_tpu.ops import trace as trace_ops
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu.ops.selector import PixelSelector, map_to_points


class StereoMatchResult(NamedTuple):
    us: jax.Array  # (cap,) selected pixel x
    vs: jax.Array  # (cap,) selected pixel y
    idepth: jax.Array  # (cap,) matched inverse depth (0 where invalid)
    idepth_min: jax.Array  # (cap,)
    idepth_max: jax.Array  # (cap,)
    good: jax.Array  # (cap,) bool — passed the L/R consistency gate
    valid: jax.Array  # (cap,) bool — slot holds a selected pixel


@functools.partial(jax.jit, static_argnames=("settings",))
def stereo_match_points(
    us,
    vs,
    valid,
    dI_left,
    dI_right,
    K,
    baseline,
    settings: Settings = default_settings(),
) -> StereoMatchResult:
    """Batched L->R trace + R->L consistency check for given pixel locations."""
    f32 = jnp.float32
    us = us.astype(f32)
    vs = vs.astype(f32)
    n = us.shape[0]

    color, weights, gradH, energy_th = trace_ops.extract_point_data(
        dI_left, us, vs, settings
    )
    quality = jnp.full((n,), 10000.0, dtype=f32)
    status = jnp.full((n,), trace_ops.IPS_UNINITIALIZED, dtype=jnp.int32)
    zeros = jnp.zeros((n,), dtype=f32)
    nans = jnp.full((n,), jnp.nan, dtype=f32)

    res_lr, idepth_lr = trace_ops.trace_stereo(
        us, vs, zeros, nans, color, weights, gradH, energy_th, quality, status,
        K, baseline, dI_right, mode_right=True, settings=settings,
    )
    good_lr = valid & (res_lr.status == trace_ops.IPS_GOOD)

    # reverse check: fresh immature point at the matched right-image position
    ur = jnp.where(good_lr, res_lr.last_uv[:, 0], 8.0)
    vr = jnp.where(good_lr, res_lr.last_uv[:, 1], 8.0)
    color_r, weights_r, gradH_r, energy_th_r = trace_ops.extract_point_data(
        dI_right, ur, vr, settings
    )
    res_rl, _ = trace_ops.trace_stereo(
        ur, vr, zeros, nans, color_r, weights_r, gradH_r, energy_th_r,
        jnp.full((n,), 10000.0, dtype=f32),
        jnp.full((n,), trace_ops.IPS_UNINITIALIZED, dtype=jnp.int32),
        K, baseline, dI_left, mode_right=False, settings=settings,
    )

    u_delta = jnp.abs(us - res_rl.last_uv[:, 0])
    depth = 1.0 / jnp.where(idepth_lr != 0, idepth_lr, jnp.inf)
    good = (
        good_lr
        & (res_rl.status == trace_ops.IPS_GOOD)
        & (u_delta < settings.stereo_u_delta_max)
        & (depth > 0)
        & (depth < settings.nonkey_stereo_depth_max)
    )

    return StereoMatchResult(
        us=us,
        vs=vs,
        idepth=jnp.where(good, idepth_lr, 0.0),
        idepth_min=jnp.where(good, res_lr.idepth_min, 0.0),
        idepth_max=jnp.where(good, res_lr.idepth_max, 0.0),
        good=good,
        valid=valid,
    )


def stereo_match(
    left_img,
    right_img,
    calib: Calib,
    selector: PixelSelector | None = None,
    settings: Settings = default_settings(),
):
    """Full MODE_STEREOMATCH on one stereo pair.

    left_img/right_img: (H, W) float32. Returns (StereoMatchResult,
    idepth_map (H, W, 3)) like the reference's CV_32FC3 output.
    """
    if selector is None:
        selector = PixelSelector(settings)
    n_lvl = calib.n_levels
    dIpL, asgL = build_pyramid(jnp.asarray(left_img), n_lvl)
    dIpR, _ = build_pyramid(jnp.asarray(right_img), n_lvl)

    status_map, _ = selector.make_maps(
        dIpL[0], asgL[0], asgL[1], asgL[2], settings.desired_immature_density
    )
    us, vs, types, valid = map_to_points(status_map, settings.immature_cap)

    result = stereo_match_points(
        us, vs, valid, dIpL[0], dIpR[0], calib.K(0), calib.baseline,
        settings=settings,
    )

    H, W = left_img.shape
    imap = jnp.zeros((H, W, 3), dtype=jnp.float32)
    iu = result.us.astype(jnp.int32)
    iv = result.vs.astype(jnp.int32)
    vals = jnp.stack([result.idepth, result.idepth_min, result.idepth_max], -1)
    imap = imap.at[iv, iu].set(jnp.where(result.good[:, None], vals, 0.0))
    return result, imap
