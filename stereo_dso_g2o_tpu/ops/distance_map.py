"""Coarse distance map for spatially-uniform point activation.

JAX rebuild of CoarseDistanceMap (CoarseTracker.cpp:1191-1380): all
active window points are projected into the newest keyframe at pyramid level
1; the BFS distance transform (40 alternating 4-/8-neighbourhood sweeps,
growDistBFS:1260) becomes an iterated masked min-pool — identical chamfer
metric, fully parallel.

The reference's greedy `addIntoDistFinal` (activation inserts each accepted
point into the map before testing the next) is inherently sequential; the
batched equivalent applies the distance gate against the initial map and then
suppresses same-cell duplicates among the accepted candidates (one winner per
level-1 grid cell), which reproduces the spatial-uniformity objective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("h1", "w1", "iters"))
def distance_map(us1, vs1, valid, h1: int, w1: int, iters: int = 40):
    """us1, vs1: (N,) level-1 integer pixel coords of projected active points.

    Returns (h1, w1) float32 chamfer distances (seeds at 0, growth capped at
    `iters`, unreached = 1000 like the reference's init).
    """
    iu = jnp.clip(us1.astype(jnp.int32), 0, w1 - 1)
    iv = jnp.clip(vs1.astype(jnp.int32), 0, h1 - 1)
    big = 1000.0
    d = jnp.full((h1, w1), big, jnp.float32)
    d = d.at[iv, iu].min(jnp.where(valid, 0.0, big))

    def roll2(x, dy, dx):
        y = jnp.roll(x, (dy, dx), axis=(0, 1))
        # out-of-image neighbours must not wrap: mask rolled-in borders
        if dy == 1:
            y = y.at[0, :].set(big)
        if dy == -1:
            y = y.at[-1, :].set(big)
        if dx == 1:
            y = y.at[:, 0].set(big)
        if dx == -1:
            y = y.at[:, -1].set(big)
        return y

    def step4(d, k):
        n = jnp.minimum(
            jnp.minimum(roll2(d, 0, 1), roll2(d, 0, -1)),
            jnp.minimum(roll2(d, 1, 0), roll2(d, -1, 0)),
        )
        return jnp.minimum(d, jnp.where(n < k, k, big))

    def step8(d, k):
        n4 = jnp.minimum(
            jnp.minimum(roll2(d, 0, 1), roll2(d, 0, -1)),
            jnp.minimum(roll2(d, 1, 0), roll2(d, -1, 0)),
        )
        nd = jnp.minimum(
            jnp.minimum(roll2(d, 1, 1), roll2(d, 1, -1)),
            jnp.minimum(roll2(d, -1, 1), roll2(d, -1, -1)),
        )
        n = jnp.minimum(n4, nd)
        return jnp.minimum(d, jnp.where(n < k, k, big))

    # growDistBFS: distance value = sweep index k; even sweeps use the
    # 4-neighbourhood, odd ones add diagonals (CoarseTracker.cpp:1264-1360)
    for k in range(1, iters):
        d = step4(d, float(k)) if k % 2 == 0 else step8(d, float(k))
    return d


@functools.partial(jax.jit, static_argnames=("cell",))
def suppress_same_cell(us1, vs1, accept, cell: int = 2):
    """Keep at most one accepted candidate per (cell x cell) level-1 grid cell
    (batched stand-in for the greedy addIntoDistFinal re-insertion)."""
    key = (vs1.astype(jnp.int32) // cell) * 100000 + (us1.astype(jnp.int32) // cell)
    key = jnp.where(accept, key, -jnp.arange(1, key.shape[0] + 1))
    # winner per cell = lowest original index with that key (stable sort)
    sort_idx = jnp.argsort(key, stable=True)
    sorted_key = key[sort_idx]
    first = jnp.concatenate(
        [jnp.ones(1, bool), sorted_key[1:] != sorted_key[:-1]]
    )
    win = jnp.zeros_like(accept).at[sort_idx].set(first)
    return accept & win
