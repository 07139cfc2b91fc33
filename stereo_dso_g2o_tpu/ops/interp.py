"""Batched bilinear image sampling.

JAX replacement for the reference's scalar interpolation family
(util/globalFuncs.h:39-130: getInterpolatedElement31/33). The reference formula
uses floor-anchored bilinear weights:

    res = dxdy*I[y+1,x+1] + (dy-dxdy)*I[y+1,x] + (dx-dxdy)*I[y,x+1]
        + (1-dx-dy+dxdy)*I[y,x]

Here the same math runs as one gather-heavy vectorized op over an arbitrary
batch of sample coordinates. Out-of-range coordinates are clamped; callers are
responsible for masking OOB samples (the reference guarantees in-bounds access
by its border gates, e.g. ResidualProjections.h:57).
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear(img, x, y):
    """Sample img at float coords.

    img: (H, W) or (H, W, C); x, y: any matching shape (...,).
    Returns (...,) or (..., C).

    The 2x2 neighbourhood is fetched as ONE XLA gather (advanced indexing
    with broadcast offsets), not a vmapped dynamic_slice or four separate
    corner gathers.
    """
    H, W = img.shape[0], img.shape[1]
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    dx = x - ix
    dy = y - iy
    d2 = jnp.arange(2, dtype=jnp.int32)
    p = img[
        iy[..., None, None] + d2[:, None], ix[..., None, None] + d2[None, :]
    ]  # (..., 2, 2[, C])
    i00 = p[..., 0, 0] if img.ndim == 2 else p[..., 0, 0, :]
    i01 = p[..., 0, 1] if img.ndim == 2 else p[..., 0, 1, :]
    i10 = p[..., 1, 0] if img.ndim == 2 else p[..., 1, 0, :]
    i11 = p[..., 1, 1] if img.ndim == 2 else p[..., 1, 1, :]

    if img.ndim == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )


def bilinear_flat(img_flat, w, x, y):
    """Same as bilinear but for a flat (H*W,) or (H*W, C) buffer with width w.

    Mirrors the pointer arithmetic form of getInterpolatedElement33; used where
    a flattened layout avoids a reshape.
    """
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    dx = x - ix
    dy = y - iy
    base = ix + iy * w
    i00 = img_flat[base]
    i01 = img_flat[base + 1]
    i10 = img_flat[base + w]
    i11 = img_flat[base + w + 1]
    if img_flat.ndim == 2:
        dx = dx[..., None]
        dy = dy[..., None]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )
