"""Data-parallel multi-sequence execution over a device mesh.

The reference is a single-process CPU program (SURVEY.md par. 2 parallelism
inventory); its scale-out axis #1 (BASELINE config 4) is trivial
data parallelism: many KITTI sequences tracked simultaneously, one (or more)
per chip. Because all engine state is fixed-capacity pytrees, this is plain
`shard_map` over a leading sequence axis with no cross-device communication in
the steady state; only diagnostics are psum-reduced.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_dso_g2o_tpu.config import Settings, default_settings
from stereo_dso_g2o_tpu.frontend.stereo_match import stereo_match_points


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def sharded_stereo_match(mesh: Mesh, settings: Settings = default_settings()):
    """Build a jitted, sequence-sharded stereo-match step.

    Input arrays carry a leading sequence axis sharded over the mesh:
      us, vs: (S, N); valid: (S, N); dI_left/right: (S, H, W, 3);
      K: (3, 3) replicated; baseline: () replicated.
    Returns (result pytree sharded over S, total_good scalar via psum).
    """
    axis = mesh.axis_names[0]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P()),
    )
    def step(us, vs, valid, dI_l, dI_r, K, baseline):
        def one(u, v, m, l, r):
            return stereo_match_points(u, v, m, l, r, K, baseline, settings=settings)

        res = jax.vmap(one)(us, vs, valid, dI_l, dI_r)
        total_good = jax.lax.psum(jnp.sum(res.good), axis)
        return res, total_good

    return jax.jit(step)


class MultiSequenceRunner:
    """BASELINE config 4: track many sequences in parallel, one per device.

    Each sequence owns a FullSystem whose arrays live on its own device
    (jax.default_device placement); per-frame programs dispatch asynchronously,
    so sequences pipeline against each other — the host only serializes the
    cheap control flow. On a single device this still interleaves compute
    with host-side bookkeeping of the other sequences.
    """

    def __init__(self, calibs, settings: Settings = default_settings(),
                 devices=None):
        from stereo_dso_g2o_tpu.frontend.full_system import FullSystem

        if devices is None:
            devices = jax.devices()
        self.devices = [devices[i % len(devices)] for i in range(len(calibs))]
        self.systems = []
        for calib, dev in zip(calibs, self.devices):
            with jax.default_device(dev):
                self.systems.append(FullSystem(calib, settings))

    def add_frames(self, frames, frame_id: int, timestamp: float = 0.0):
        """frames: list of (left, right) per sequence (None to skip one)."""
        for fs, dev, pair in zip(self.systems, self.devices, frames):
            if pair is None:
                continue
            with jax.default_device(dev):
                fs.add_frame(pair[0], pair[1], frame_id, timestamp=timestamp)

    def trajectories(self):
        return [fs.trajectory() for fs in self.systems]
