"""Gradient-histogram pixel selection.

JAX rebuild of PixelSelector2 (FullSystem/PixelSelector2.{h,cpp}):

- per-32x32-block gradient histograms -> `below`-quantile threshold + additive
  offset, 3x3 smoothed and squared (makeHists, PixelSelector2.cpp:84-178)
- 3-scale potential-grid selection (select, :340-500): within every pot-sized
  cell pick the strongest direction-projected gradient above the level-0
  threshold; cells with no level-0 winner fall back to level-1 (2pot cells,
  0.75x threshold), then level-2 (4pot cells, 0.75^3 x threshold)
- recursive density adjustment + random subsampling (makeMaps, :192-330)

The reference's sequential quad-nested argmax loops become per-cell
block argmax reductions (reshape to (h/pot, pot, w/pot, pot) + argmax with
raster tie-break — the same winner as the reference's scan order). `pot`
stays a TRACED scalar so density adaptation never recompiles the fused
frame program: the traced pot selects one of a small static set of
compiled branches via `lax.switch` (each branch is the reshape argmax at
one static pot). A pure scatter-max formulation was tried first and cost
88 ms/call at KITTI resolution (five full-image scatters); the switch
runs the single taken branch at ~2 ms. The randomPattern direction table
is kept, indexed by a per-cell integer hash instead of a global rand()
stream (behaviourally equivalent: a fixed pseudo-random direction per cell).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.config import Settings, default_settings

# The 16 unit direction vectors (PixelSelector2.cpp:368-384).
_DIRECTIONS = np.array(
    [
        [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
        [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
        [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
        [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
    ],
    dtype=np.float32,
)


def _cell_hash(bx, by, salt):
    """Deterministic per-cell pseudo-random direction index in [0, 16)."""
    h = bx * jnp.uint32(2654435761) ^ by * jnp.uint32(40503) ^ jnp.uint32(salt)
    h = (h ^ (h >> 13)) * jnp.uint32(0x5BD1E995)
    return (h >> 4) & jnp.uint32(0xF)


@functools.partial(jax.jit, static_argnames=("settings",))
def block_thresholds(asg0: jax.Array, settings: Settings = default_settings()):
    """Per-32x32-block smoothed squared gradient thresholds (makeHists).

    asg0: (H, W) level-0 squared gradients. Returns (H//32, W//32) float32
    thsSmoothed. H, W need not be multiples of 32 in the reference; here the
    ragged edge is handled by masking pixels outside full blocks.
    """
    H, W = asg0.shape
    h32, w32 = H // 32, W // 32
    g = jnp.minimum(jnp.sqrt(asg0).astype(jnp.int32), 48)

    # validity: interior pixels only (PixelSelector2.cpp:115: 1 <= x <= w-2)
    xs = jnp.arange(W)
    ys = jnp.arange(H)
    valid = (
        (xs[None, :] >= 1) & (xs[None, :] <= W - 2)
        & (ys[:, None] >= 1) & (ys[:, None] <= H - 2)
    )

    gb = g[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    vb = valid[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)

    # quantile via cumulative counts over the 49 possible values
    bins = jnp.arange(49)
    # counts[b, y, x] = number of valid pixels with g <= b
    le = (gb[..., None] <= bins) & vb[..., None]  # (h32,32,w32,32,49)
    cum = jnp.sum(le, axis=(1, 3))  # (h32, w32, 49)
    total = jnp.sum(vb, axis=(1, 3))  # (h32, w32)
    # computeHistQuantil (:67-81): smallest i with cum[i] > total*below - 0.5
    th_count = (total * settings.min_grad_hist_cut + 0.5).astype(jnp.int32)
    meets = cum >= th_count[..., None] + 1  # th becomes negative after i
    # argmax finds the first True; if none, reference returns 90
    first = jnp.argmax(meets, axis=-1)
    any_meets = jnp.any(meets, axis=-1)
    quant = jnp.where(any_meets, first, 90)
    ths = quant.astype(jnp.float32) + settings.min_grad_hist_add

    # 3x3 box smoothing with edge renormalization (:138-177), then square.
    # Shift-based (no convolution) so it works for arbitrarily small grids.
    def box(x):
        total = jnp.zeros_like(x)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                y = jnp.roll(x, (dy, dx), axis=(0, 1))
                if dy == 1:
                    y = y.at[0, :].set(0.0)
                if dy == -1:
                    y = y.at[-1, :].set(0.0)
                if dx == 1:
                    y = y.at[:, 0].set(0.0)
                if dx == -1:
                    y = y.at[:, -1].set(0.0)
                total = total + y
        return total

    ones = jnp.ones_like(ths)
    sm = box(ths) / box(ones)
    return sm * sm


class Selection(NamedTuple):
    status_map: jax.Array  # (H, W) int32 in {0,1,2,4}
    counts: jax.Array  # (3,) int32 — per-level selection counts


# Static potentials compiled as lax.switch branches. The host density
# controller snaps its adapted potential to this set (snap_pot), so the
# traced-pot dispatch always lands exactly on one branch.
SUPPORTED_POTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)


def snap_pot(pot: int) -> int:
    """Nearest supported potential (ties -> smaller = denser)."""
    return min(SUPPORTED_POTS, key=lambda p: (abs(p - pot), p))


def _select_at_pot(v0, v1, v2, pot: int, H: int, W: int):
    """3-scale cell-winner selection at one STATIC potential.

    v0/v1/v2: (H, W) candidate scores (dirNorm, -1 where not a candidate).
    Returns (status (H,W) int32, counts (3,)). Winner per cell = first
    maximal score in raster order, matching the reference's scan
    (PixelSelector2.cpp:340-500 keeps strictly-greater while scanning)."""
    NEG = jnp.float32(-1.0)
    B = 4 * pot
    Hp = ((H + B - 1) // B) * B
    Wp = ((W + B - 1) // B) * B

    def pad(x):
        return jnp.pad(x, ((0, Hp - H), (0, Wp - W)), constant_values=NEG)

    v0p, v1p, v2p = pad(v0), pad(v1), pad(v2)

    def block_argmax(v, b):
        """Per bxb block: (max value, image coords of raster-first argmax)."""
        hb, wb = Hp // b, Wp // b
        vb = v.reshape(hb, b, wb, b).transpose(0, 2, 1, 3).reshape(hb, wb, b * b)
        best = jnp.max(vb, axis=-1)
        arg = jnp.argmax(vb, axis=-1)
        iy = arg // b + jnp.arange(hb)[:, None] * b
        ix = arg % b + jnp.arange(wb)[None, :] * b
        return best, iy, ix

    # level 0: one winner per pot cell (dirNorm must be > 0: bestVal2
    # starts at 0, PixelSelector2.cpp:446)
    b0v, b0y, b0x = block_argmax(v0p, pot)
    sel0 = b0v > 0

    # level 1: one winner per 2pot cell, only if no level-0 winner inside
    b1v, b1y, b1x = block_argmax(v1p, 2 * pot)
    h1, w1 = b1v.shape
    sel0_any = (
        sel0.reshape(h1, 2, w1, 2).transpose(0, 2, 1, 3).reshape(h1, w1, 4).any(-1)
    )
    sel1 = (~sel0_any) & (b1v > 0)

    # level 2: one winner per 4pot cell, only if nothing selected inside
    b2v, b2y, b2x = block_argmax(v2p, 4 * pot)
    h2, w2 = b2v.shape
    sel1_any = (
        sel1.reshape(h2, 2, w2, 2).transpose(0, 2, 1, 3).reshape(h2, w2, 4).any(-1)
    )
    sel0_any2 = (
        sel0_any.reshape(h2, 2, w2, 2).transpose(0, 2, 1, 3).reshape(h2, w2, 4).any(-1)
    )
    sel2 = (~sel0_any2) & (~sel1_any) & (b2v > 0)

    status = jnp.zeros((Hp, Wp), dtype=jnp.int32)
    status = status.at[b0y.ravel(), b0x.ravel()].max(
        jnp.where(sel0, 1, 0).ravel().astype(jnp.int32)
    )
    status = status.at[b1y.ravel(), b1x.ravel()].max(
        jnp.where(sel1, 2, 0).ravel().astype(jnp.int32)
    )
    status = status.at[b2y.ravel(), b2x.ravel()].max(
        jnp.where(sel2, 4, 0).ravel().astype(jnp.int32)
    )
    status = status[:H, :W]

    counts = jnp.stack(
        [jnp.sum(sel0), jnp.sum(sel1), jnp.sum(sel2)]
    ).astype(jnp.int32)
    return status, counts


@functools.partial(jax.jit, static_argnames=("settings",))
def select(
    dI0: jax.Array,
    asg0: jax.Array,
    asg1: jax.Array,
    asg2: jax.Array,
    ths_smoothed: jax.Array,
    pot,
    th_factor: float = 1.0,
    salt: int = 0,
    settings: Settings = default_settings(),
) -> Selection:
    """One selection pass at potential `pot` (PixelSelector2::select).

    `pot` is traced (dynamic): the per-cell winner is computed with
    scatter-max over cell ids rather than a pot-strided reshape, so density
    adaptation does not trigger recompilation of callers."""
    H, W = asg0.shape
    dirs = jnp.asarray(_DIRECTIONS)
    # snap the traced pot to the nearest supported static branch
    pots = jnp.asarray(SUPPORTED_POTS, jnp.int32)
    branch = jnp.argmin(jnp.abs(pots - jnp.asarray(pot, jnp.int32)))
    pot = pots[branch]

    xs = jnp.arange(W)
    ys = jnp.arange(H)
    # border gate (:465: xf<4 || xf>=w-5 || yf<4 || yf>h-4 -> skip)
    border = (
        (xs[None, :] >= 4) & (xs[None, :] < W - 5)
        & (ys[:, None] >= 4) & (ys[:, None] <= H - 4)
    )

    # per-pixel thresholds from the 32-grid (:472-475)
    th0 = ths_smoothed[
        jnp.minimum(ys[:, None] >> 5, ths_smoothed.shape[0] - 1),
        jnp.minimum(xs[None, :] >> 5, ths_smoothed.shape[1] - 1),
    ]
    dw1 = settings.grad_downweight_per_level
    dw2 = dw1 * dw1
    th1 = th0 * dw1
    th2 = th1 * dw2

    gx = dI0[..., 1]
    gy = dI0[..., 2]

    # pyramid-level gradient lookups (:494, :510: nearest with +0.25/+0.125)
    x1 = (xs.astype(jnp.float32) * 0.5 + 0.25).astype(jnp.int32)
    y1 = (ys.astype(jnp.float32) * 0.5 + 0.25).astype(jnp.int32)
    ag1 = asg1[
        jnp.minimum(y1[:, None], asg1.shape[0] - 1),
        jnp.minimum(x1[None, :], asg1.shape[1] - 1),
    ]
    x2 = (xs.astype(jnp.float32) * 0.25 + 0.125).astype(jnp.int32)
    y2 = (ys.astype(jnp.float32) * 0.25 + 0.125).astype(jnp.int32)
    ag2 = asg2[
        jnp.minimum(y2[:, None], asg2.shape[0] - 1),
        jnp.minimum(x2[None, :], asg2.shape[1] - 1),
    ]

    pass0 = border & (asg0 > th0 * th_factor)
    pass1 = border & (ag1 > th1 * th_factor)
    pass2 = border & (ag2 > th2 * th_factor)

    # per-cell random directions (dir2/dir3/dir4, :447/:437/:428)
    bx0 = (xs // pot).astype(jnp.uint32)
    by0 = (ys // pot).astype(jnp.uint32)
    bx1 = (xs // (2 * pot)).astype(jnp.uint32)
    by1 = (ys // (2 * pot)).astype(jnp.uint32)
    bx2 = (xs // (4 * pot)).astype(jnp.uint32)
    by2 = (ys // (4 * pot)).astype(jnp.uint32)

    def dir_field(bx, by, s):
        idx = _cell_hash(by[:, None], bx[None, :], s)
        return dirs[idx]  # (H, W, 2)

    d0 = dir_field(bx0, by0, salt * 3 + 0)
    d1 = dir_field(bx1, by1, salt * 3 + 1)
    d2f = dir_field(bx2, by2, salt * 3 + 2)

    if settings.select_direction_distribution:
        dn0 = jnp.abs(gx * d0[..., 0] + gy * d0[..., 1])
        dn1 = jnp.abs(gx * d1[..., 0] + gy * d1[..., 1])
        dn2 = jnp.abs(gx * d2f[..., 0] + gy * d2f[..., 1])
    else:
        dn0, dn1, dn2 = asg0, ag1, ag2

    NEG = jnp.float32(-1.0)  # dirNorm >= 0, so -1 marks "not a candidate"
    v0 = jnp.where(pass0, dn0, NEG)
    v1 = jnp.where(pass1, dn1, NEG)
    v2 = jnp.where(pass2, dn2, NEG)

    # dispatch to the static-pot branch (only the taken branch executes)
    branches = [
        functools.partial(_select_at_pot, pot=p, H=H, W=W)
        for p in SUPPORTED_POTS
    ]
    status, counts = jax.lax.switch(branch, branches, v0, v1, v2)
    return Selection(status_map=status, counts=counts)


class PixelSelector:
    """Host-side density controller (PixelSelector2::makeMaps, :192-330).

    Holds the adaptive `currentPotential` between frames and re-runs the
    jitted `select` with adjusted pot until the yield is within [0.25, 1.25]x
    of the requested density; overshoot is randomly thinned.
    """

    def __init__(self, settings: Settings = default_settings(), seed: int = 0):
        self.settings = settings
        self.current_potential = 3
        self._seed = seed
        self._calls = 0

    def make_maps(self, dI0, asg0, asg1, asg2, density: float, th_factor: float = 1.0):
        """Returns (status_map (H,W) int32 in {0,1,2,4}, num_selected)."""
        ths = block_thresholds(asg0, self.settings)
        self._calls += 1
        salt = self._seed * 1000003 + self._calls
        pot = self.current_potential
        for recursion in range(2, -1, -1):
            selm = select(
                dI0, asg0, asg1, asg2, ths, pot, th_factor, salt, self.settings
            )
            num_have = float(jnp.sum(selm.counts))
            quotia = density / max(num_have, 1.0)
            K = num_have * (pot + 1) * (pot + 1)
            ideal_pot = max(int(np.sqrt(K / density) - 1), 1)
            if recursion > 0 and quotia > 1.25 and pot > 1:
                pot = snap_pot(min(ideal_pot, pot - 1))
                continue
            if recursion > 0 and quotia < 0.25:
                pot = snap_pot(max(ideal_pot, pot + 1))
                continue
            break
        self.current_potential = snap_pot(max(ideal_pot, 1))

        status = selm.status_map
        if quotia < 0.95:
            key = jax.random.PRNGKey(salt & 0x7FFFFFFF)
            keep = jax.random.uniform(key, status.shape) < quotia
            status = jnp.where(keep, status, 0)
            num_have = float(jnp.sum(status > 0))
        return status, int(num_have)


@functools.partial(jax.jit, static_argnames=("cap",))
def map_to_points(status_map: jax.Array, cap: int):
    """Compact a selection map into fixed-capacity point arrays.

    Returns (us, vs, types, valid): (cap,) each, raster-scan order, zero-padded.
    """
    H, W = status_map.shape
    flat = status_map.ravel()
    idx = jnp.nonzero(flat > 0, size=cap, fill_value=-1)[0]
    valid = idx >= 0
    safe = jnp.maximum(idx, 0)
    us = (safe % W).astype(jnp.float32)
    vs = (safe // W).astype(jnp.float32)
    types = jnp.where(valid, flat[safe], 0)
    return us, vs, types, valid
