"""Small fixed-size linear algebra, unrolled.

`jnp.linalg.solve` on an 8x8 lowers to a general LU path: a factorization
kernel per call, serialized inside the tracker's LM while_loop
(CoarseTracker.cpp:966: the reference just calls Eigen's ldlt on the stack).
Whether that still costs more than the unrolled form on the GPU is not
measured yet.
These unrolled Cholesky routines compile to one fused elementwise chain
instead: no factorization kernel, no pivoting, ~n^3/3 scalar FMAs.

Intended for the n <= 8 normal-equation solves of the tracker and the
immature-point optimizer; inputs must be (damped) symmetric positive
semi-definite, which GN/LM normal matrices are by construction.
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_solve_small(A, b):
    """Solve A x = b for symmetric PSD A of small static size.

    A: (..., n, n), b: (..., n) with n <= ~10 (fully unrolled). Singular
    diagonals are clamped so an all-zero system returns x = 0 instead of NaN
    (callers keep their own finite-step guards).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
