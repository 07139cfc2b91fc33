"""Distributed windowed bundle adjustment (BASELINE config 5).

The reference's window Hessian assembly is a sum over independent
(host, target) pair blocks (AccumulatedTopHessian::stitchDouble,
AccumulatedTopHessian.cpp:201-229) — exactly an all-reduce. Here the point
axis (and with it the residual cube and all Jacobian tensors) is sharded over
a device mesh with `shard_map`; each device linearizes its local points and
builds partial pair-block sums, the reduced (CPARS+8F)^2 camera system is
`psum`-ed across devices, the tiny dense solve is replicated, and the idepth
back-substitution is purely local again. Keyframe state, images and the
marginal prior stay replicated.

This lets the window (points per keyframe, and with a larger F the keyframe
count itself) scale past one device while the per-iteration
collective is a single (68x68 + 68) float32 all-reduce.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from stereo_dso_g2o_tpu.backend import ba
from stereo_dso_g2o_tpu.backend import window as W
from stereo_dso_g2o_tpu.config import Settings, default_settings

AXIS = "pt"

# Window fields sharded along the point axis; everything else replicated.
_POINT_FIELDS = {
    "pt_status", "pt_host", "pt_u", "pt_v", "pt_idepth", "pt_idepth_zero",
    "pt_color", "pt_weights", "pt_has_prior", "pt_energy_th",
    "pt_num_good_res", "pt_max_rel_baseline", "pt_idepth_hessian",
    "res_exists", "res_state", "res_energy", "res_linearized", "res_to_zero",
    "res_new_state", "res_new_energy_wo", "res_center",
    "J_resF", "J_pdxi", "J_pdc", "J_pdd", "J_Idx", "J_abF",
}


def window_specs(win: W.Window) -> W.Window:
    """A Window-shaped pytree of PartitionSpecs."""
    import dataclasses

    specs = {}
    for f in dataclasses.fields(win):
        name = f.name
        val = getattr(win, name)
        nd = jnp.ndim(val)
        if name in _POINT_FIELDS:
            specs[name] = P(AXIS, *([None] * (nd - 1)))
        else:
            specs[name] = P(*([None] * nd))
    return W.Window(**specs)


def sharded_ba_step(mesh: Mesh, win_template: W.Window,
                    settings: Settings = default_settings()):
    """Build a jitted distributed BA iteration over `mesh`.

    Returns step(win, dI_stack, iteration) -> (win, energy, converged, nres)
    with `win` sharded per `window_specs`.
    """
    spec = window_specs(win_template)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, P(*([None] * 4)), P()),
        out_specs=(spec, P(), P(), P()),
    )
    def step(win, dI_stack, iteration):
        return ba.ba_iteration(
            win, dI_stack, iteration, settings=settings, axis_name=AXIS
        )

    return jax.jit(step)


def sharded_optimize_fused(mesh: Mesh, win_template: W.Window,
                           settings: Settings = default_settings(),
                           max_its: int = 6):
    """The WHOLE GN loop (ba.optimize_fused) as one distributed program:
    the lax.while_loop runs inside shard_map, each iteration psum-reduces
    the camera system over the mesh, and every shard steps the replicated
    keyframe state identically (so the convergence flag needs no extra
    collective — it is a pure function of the psum-ed system).

    Returns run(win_sharded, dI_stack) -> (win_sharded, energy, nres).
    """
    spec = window_specs(win_template)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, P(*([None] * 4))),
        out_specs=(spec, P(), P()),
    )
    def run(win, dI_stack):
        def cond(carry):
            _, _, _, done, it = carry
            return (it < max_its) & ~done

        def body(carry):
            win_c, _, _, done, it = carry
            win_n, e, conv, nr = ba.ba_iteration(
                win_c, dI_stack, it, settings=settings, axis_name=AXIS
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
        win_out, energy, nres, _, _ = jax.lax.while_loop(cond, body, init)
        return win_out, energy, nres

    return jax.jit(run)


def shard_window(mesh: Mesh, win: W.Window) -> W.Window:
    """Place a window onto the mesh with point arrays sharded."""
    import dataclasses

    from jax.sharding import NamedSharding

    spec = window_specs(win)
    out = {}
    for f in dataclasses.fields(win):
        v = getattr(win, f.name)
        out[f.name] = jax.device_put(v, NamedSharding(mesh, getattr(spec, f.name)))
    return W.Window(**out)
