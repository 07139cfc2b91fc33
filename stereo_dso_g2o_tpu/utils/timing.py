"""Lightweight wall-clock profiler (the reference's timing observability).

The reference self-reports per-run fps/ms and per-stage ms deques
(main_dso_pangolin.cpp:523-555, PangolinDSOViewer.h:130-136, SURVEY.md par.5
tracing). This module provides the same per-stage breakdown for the
device pipeline: named sections accumulate wall time; sections can force a device
sync on a result pytree so async dispatch doesn't hide where time goes.

Enable with SDSO_PROFILE=1 (sections then sync + accumulate) or use
explicitly. `report()` prints a sorted table.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class Profiler:
    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("SDSO_PROFILE", "0") == "1"
        )
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a block. `sync`: a callable returning the pytree to block on
        (called at section end when profiling, to charge async work here)."""
        if not self.enabled:
            yield
            return
        import jax

        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync())
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def tick(self, name: str, t0: float, sync_obj=None):
        if not self.enabled:
            return
        if sync_obj is not None:
            import jax

            jax.block_until_ready(sync_obj)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self, min_ms: float = 0.1) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{'section':<38}{'total_s':>9}{'count':>7}{'ms/call':>9}"]
        for name, tot in rows:
            n = self.counts[name]
            if tot * 1000 < min_ms:
                continue
            lines.append(f"{name:<38}{tot:>9.2f}{n:>7}{1000 * tot / n:>9.1f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


PROF = Profiler()
