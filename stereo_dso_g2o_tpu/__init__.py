"""Stereo direct-SLAM engine in JAX (stereo-DSO capability set, built from scratch).

A brand-new JAX/XLA implementation of the full stereo-dso-g2o pipeline
(see SURVEY.md for the reference structural analysis):

- coarse-to-fine photometric pose tracking over 6-level image pyramids
- static-stereo + temporal epipolar depth tracing for immature points
- gradient-histogram pixel selection
- point activation and sliding-window photometric bundle adjustment with
  first-estimate-Jacobian marginalization (Schur complement over inverse depths)
- data-parallel multi-sequence tracking and sharded windowed BA over device meshes

Design stance (not a port): fixed-capacity structure-of-arrays state pytrees +
masks, one jitted program per pipeline stage, batched pattern-residual kernels
instead of per-point scalar loops, and XLA collectives instead of threads.
"""

__version__ = "0.1.0"

import jax as _jax

# The windowed-BA Hessian stitching and the small dense solves need f32
# matmuls: reduced-precision matmul inputs destroy the solver (full
# divergence on long runs). On the H100 "highest" rules out TF32 for every
# matmul, not only the solver's. Set the global default only if the user
# hasn't chosen one explicitly.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

from stereo_dso_g2o_tpu.config import Settings, default_settings  # noqa: F401
