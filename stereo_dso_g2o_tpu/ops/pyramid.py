"""Image pyramid + gradient construction (the first per-frame kernel).

JAX rebuild of FrameHessian::makeImages (HessianBlocks.cpp:141-203):
  - level l>0 intensity = 0.25 * (2x2 box sum of level l-1)
  - gradients = central differences: dx = 0.5*(I[x+1]-I[x-1]),
    dy = 0.5*(I[y+1]-I[y-1]); zero on the image border
  - absSquaredGrad = dx^2 + dy^2, optionally scaled by the squared gamma
    response gradient (HessianBlocks.cpp:195-199)

Output per level: a (H, W, 3) array stacking (intensity, dx, dy) — the same
layout as the reference's dIp — plus the (H, W) squared-gradient map.

Everything is shape-static per level, so one jit covers a whole sequence.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp


def _downsample2(img):
    """0.25 * 2x2 box sum (exact reference formula, HessianBlocks.cpp:159-170)."""
    H, W = img.shape
    return 0.25 * (
        img[0 : H - 1 : 2, 0 : W - 1 : 2]
        + img[0 : H - 1 : 2, 1:W:2]
        + img[1:H:2, 0 : W - 1 : 2]
        + img[1:H:2, 1:W:2]
    )


def _gradients(img):
    """Central differences with zero border (interior matches reference)."""
    dx = jnp.zeros_like(img)
    dy = jnp.zeros_like(img)
    dx = dx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    dy = dy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    return dx, dy


@functools.partial(jax.jit, static_argnames=("n_levels",))
def build_pyramid(img: jax.Array, n_levels: int = 6):
    """img: (H, W) float32 intensity (already photometrically corrected).

    Returns (dIp, abs_sq_grad):
      dIp: tuple of n_levels arrays (H_l, W_l, 3) = (I, dx, dy)
      abs_sq_grad: tuple of n_levels arrays (H_l, W_l) = dx^2 + dy^2
    """
    dIp = []
    asg = []
    cur = img
    for lvl in range(n_levels):
        if lvl > 0:
            cur = _downsample2(cur)
        dx, dy = _gradients(cur)
        dIp.append(jnp.stack([cur, dx, dy], axis=-1))
        asg.append(dx * dx + dy * dy)
    return tuple(dIp), tuple(asg)


@functools.partial(jax.jit, static_argnames=("n_levels",))
def build_pyramid_gamma(img: jax.Array, gamma_grad_lut: jax.Array, n_levels: int = 6):
    """build_pyramid with gamma-response gradient weighting of absSquaredGrad.

    gamma_grad_lut: (256,) table of B'(I) values; the squared-gradient map is
    multiplied by B'(I)^2 (HessianBlocks.cpp:195-199, getBGradOnly).
    """
    dIp, asg = build_pyramid(img, n_levels)
    out_asg = []
    for lvl in range(n_levels):
        inten = dIp[lvl][..., 0]
        idx = jnp.clip(inten, 0.0, 254.999).astype(jnp.int32)
        gw = gamma_grad_lut[idx]
        out_asg.append(asg[lvl] * gw * gw)
    return dIp, tuple(out_asg)
