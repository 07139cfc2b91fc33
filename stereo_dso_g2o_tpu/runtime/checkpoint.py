"""Mid-run checkpoint / resume.

The reference has NO state persistence — its only artifact is the final
trajectory file (SURVEY.md par. 5: "JAX build: jittable state pytree makes
checkpointing nearly free — worth adding"). Because all device state is two
fixed-capacity pytrees (Window + ImmatureSet) plus small host metadata, a
checkpoint is a single npz + a pickle, and resume is exact: the restored
system continues producing the same trajectory.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem


def _pytree_to_dict(obj, prefix):
    out = {}
    for f in dataclasses.fields(obj):
        out[prefix + f.name] = np.asarray(getattr(obj, f.name))
    return out


def _dict_to_pytree(cls, d, prefix):
    import jax.numpy as jnp

    kwargs = {}
    for f in dataclasses.fields(cls):
        kwargs[f.name] = jnp.asarray(d[prefix + f.name])
    return cls(**kwargs)


def save(fs: "FullSystem", path: str):
    """Write <path>.npz (device state) and <path>.meta (host state)."""
    arrays = {}
    arrays.update(_pytree_to_dict(fs.win, "win."))
    arrays.update(_pytree_to_dict(fs.imm, "imm."))
    for slot, pyr in enumerate(fs.dI_slots):
        if pyr is not None:
            for lvl, p in enumerate(pyr):
                arrays[f"dI.{slot}.{lvl}"] = np.asarray(p)
    for slot, r in enumerate(fs.right_slots):
        if r is not None:
            arrays[f"right.{slot}"] = np.asarray(r)
    if fs.tracker.ref is not None:
        for lvl, tup in enumerate(fs.tracker.ref):
            for j, a in enumerate(tup):
                arrays[f"ref.{lvl}.{j}"] = np.asarray(a)
    np.savez_compressed(path + ".npz", **arrays)

    meta = dict(
        history=fs.history,
        kf_shells=fs.kf_shells,
        kf_slots=fs.kf_slots,
        slot_frame_id=fs.slot_frame_id,
        slot_meta=fs.slot_meta,
        kf_out_count=fs.kf_out_count,
        current_min_act_dist=fs.current_min_act_dist,
        last_coarse_rmse=fs.last_coarse_rmse,
        next_kf_id=fs.next_kf_id,
        stats_n_frames=fs.stats_n_frames,
        initialized=fs.initialized,
        is_lost=fs.is_lost,
        tracker=dict(
            ref_aff=np.asarray(fs.tracker.ref_aff),
            ref_exposure=fs.tracker.ref_exposure,
            ref_frame_id=fs.tracker.ref_frame_id,
            first_coarse_rmse=fs.tracker.first_coarse_rmse,
            n_ref_levels=len(fs.tracker.ref) if fs.tracker.ref else 0,
        ),
        selector_pot=fs.selector.current_potential,
        selector_seed=fs.selector._seed,
        selector_calls=fs.selector._calls,
        settings=fs.settings,
    )
    with open(path + ".meta", "wb") as f:
        pickle.dump(meta, f)


def load(path: str, calib) -> "FullSystem":
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.backend import window as W
    from stereo_dso_g2o_tpu.frontend import immature as IMM
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem

    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)
    data = np.load(path + ".npz")

    fs = FullSystem(calib, meta["settings"])
    fs.win = _dict_to_pytree(W.Window, data, "win.")
    fs.imm = _dict_to_pytree(IMM.ImmatureSet, data, "imm.")
    fs.history = meta["history"]
    fs.kf_shells = meta["kf_shells"]
    fs.kf_slots = meta["kf_slots"]
    fs.slot_frame_id = meta["slot_frame_id"]
    fs.slot_meta = meta["slot_meta"]
    fs.kf_out_count = meta["kf_out_count"]
    fs.current_min_act_dist = meta["current_min_act_dist"]
    fs.last_coarse_rmse = meta["last_coarse_rmse"]
    fs.next_kf_id = meta["next_kf_id"]
    fs.stats_n_frames = meta["stats_n_frames"]
    fs.initialized = meta["initialized"]
    fs.is_lost = meta["is_lost"]

    n_lvl = calib.n_levels
    for slot in range(fs.win.F):
        if f"dI.{slot}.0" in data:
            fs.dI_slots[slot] = tuple(
                jnp.asarray(data[f"dI.{slot}.{lvl}"]) for lvl in range(n_lvl)
            )
        if f"right.{slot}" in data:
            fs.right_slots[slot] = jnp.asarray(data[f"right.{slot}"])

    tm = meta["tracker"]
    if tm["n_ref_levels"]:
        fs.tracker.ref = [
            tuple(
                jnp.asarray(data[f"ref.{lvl}.{j}"]) for j in range(5)
            )
            for lvl in range(tm["n_ref_levels"])
        ]
    fs.tracker.ref_aff = jnp.asarray(tm["ref_aff"], jnp.float32)
    fs.tracker.ref_exposure = tm["ref_exposure"]
    fs.tracker.ref_frame_id = tm["ref_frame_id"]
    fs.tracker.first_coarse_rmse = tm["first_coarse_rmse"]
    fs.selector.current_potential = meta["selector_pot"]
    # the selection salt counter must survive or the resumed run seeds
    # different immature points than the uninterrupted one
    fs.selector._seed = meta.get("selector_seed", fs.selector._seed)
    fs.selector._calls = meta.get("selector_calls", 0)
    return fs
