"""Camera calibration state: the global per-level intrinsics pyramid + baseline.

Equivalent of util/globalCalib.{h,cpp} (wG/hG/KG/KiG pyramid,
baseline:46) and the intrinsic part of CalibHessian (HessianBlocks.h:272-371).
Per-level downscaling follows globalCalib.cpp:90-99:
    fx_l = fx_{l-1} * 0.5 ; cx_l = (cx_0 + 0.5) / 2^l - 0.5

`Calib` is a pytree whose leaf arrays can be state in jitted programs; the
image sizes are static aux data. Intrinsics are *optimizable* in windowed BA
(the CPARS=4 global camera block), so fx/fy/cx/cy live as a (4,) value vector
from which per-level values are derived inside jit.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereo_dso_g2o_tpu.utils.pytree import dataclass, static_field


@dataclass
class Calib:
    # value state (optimizable): fx, fy, cx, cy at level 0
    c: jax.Array  # (4,) float32
    baseline: jax.Array  # () float32 — stereo baseline [m] (globalCalib.h:46)
    # static geometry
    w: Tuple[int, ...] = static_field()  # per-level widths
    h: Tuple[int, ...] = static_field()  # per-level heights

    @property
    def n_levels(self) -> int:
        return len(self.w)

    def fx(self, lvl: int):
        return self.c[0] * (0.5**lvl)

    def fy(self, lvl: int):
        return self.c[1] * (0.5**lvl)

    def cx(self, lvl: int):
        return (self.c[2] + 0.5) / (1 << lvl) - 0.5

    def cy(self, lvl: int):
        return (self.c[3] + 0.5) / (1 << lvl) - 0.5

    def K(self, lvl: int):
        fx, fy, cx, cy = self.fx(lvl), self.fy(lvl), self.cx(lvl), self.cy(lvl)
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack(
            [
                jnp.stack([fx, z, cx]),
                jnp.stack([z, fy, cy]),
                jnp.stack([z, z, o]),
            ]
        )

    def Ki(self, lvl: int):
        fx, fy, cx, cy = self.fx(lvl), self.fy(lvl), self.cx(lvl), self.cy(lvl)
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack(
            [
                jnp.stack([1.0 / fx, z, -cx / fx]),
                jnp.stack([z, 1.0 / fy, -cy / fy]),
                jnp.stack([z, z, o]),
            ]
        )

    def bf(self):
        """baseline * fx — disparity-to-inverse-depth factor
        (ImmaturePoint.cpp:117: bf = -K(0,0)*bl[0] with bl=(-baseline,0,0))."""
        return self.baseline * self.c[0]


def make_calib(fx, fy, cx, cy, baseline, w: int, h: int, n_levels: int = 6) -> Calib:
    ws = tuple(w >> lvl for lvl in range(n_levels))
    hs = tuple(h >> lvl for lvl in range(n_levels))
    for lvl in range(1, n_levels):
        if ws[lvl] * 2 != ws[lvl - 1] or hs[lvl] * 2 != hs[lvl - 1]:
            raise ValueError(
                f"image size {w}x{h} not divisible by 2^{n_levels - 1}; "
                f"crop/resize first (cf. globalCalib.cpp:55-60 warning)"
            )
    return Calib(
        c=jnp.array([fx, fy, cx, cy], dtype=jnp.float32),
        baseline=jnp.asarray(baseline, dtype=jnp.float32),
        w=ws,
        h=hs,
    )
