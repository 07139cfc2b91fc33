"""JAX's persistent compilation cache, kept in one place per checkout.

`enable()` is called once by every entry point (bench.py, chip_smoke.py,
run_odometry.py, tools/) before the first compile:

- `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself; nothing is set here.
- unset, on an accelerator: the cache goes to `<checkout>/.cache/jax`. The
  path comes from this file's location, so every run from one checkout hits
  the same cache.
- on the CPU backend the cache stays off: the XLA CPU compiler in the
  pinned jaxlib intermittently segfaults on the cache-write path. A process
  that compiles for both the GPU and the host CPU (chip_smoke.py's parity
  phase) compiles its CPU programs inside `no_writes()`.
"""

from __future__ import annotations

import contextlib
import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".cache", "jax")
ENV = "JAX_COMPILATION_CACHE_DIR"
_MIN_SECS = "jax_persistent_cache_min_compile_time_secs"


def enable(platform: str | None = None) -> str | None:
    """Turn the cache on for `platform` (default: JAX's default backend).

    Returns the cache directory in use, or None when the cache is off.
    """
    import jax

    if os.environ.get(ENV):
        return os.environ[ENV]
    if (platform or jax.default_backend()) == "cpu":
        return None
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update(_MIN_SECS, 0.5)
    return DEFAULT_DIR


@contextlib.contextmanager
def no_writes():
    """Programs compiled inside write nothing to the persistent cache.

    JAX decides once per process whether the cache is in use, for every
    backend alike; only the minimum compile time for a write is read at
    each write, so raising it to infinity is the per-compile switch.
    """
    import jax

    old = getattr(jax.config, _MIN_SECS)
    jax.config.update(_MIN_SECS, float("inf"))
    try:
        yield
    finally:
        jax.config.update(_MIN_SECS, old)
