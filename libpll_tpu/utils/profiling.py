"""Tracing / profiling helpers (SURVEY §5.1).

The reference's only measurement tooling is the 20-replicate wall-clock mode
of its test runner (`test/runtest.py:137-263`); the rebuild exposes
`jax.profiler` trace capture plus a wall-clock timer for jitted functions.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `jax.profiler` trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(f: Callable, *args, reps: int = 10) -> float:
    """Median seconds per call of ``f(*args)``, each call ending in
    ``block_until_ready``, after one warm-up call (compilation is not
    counted)."""
    jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class KernelTimer:
    """Accumulate named wall-clock measurements (host-side, coarse)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name}: {self.totals[name]*1e3:.2f} ms "
                 f"({self.counts[name]}x)"
                 for name in sorted(self.totals)]
        return "\n".join(lines)
