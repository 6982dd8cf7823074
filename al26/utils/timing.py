"""Structured run instrumentation.

The reference scatters manual time.time() brackets through its step and
prints them under --verbose (al26_nbody.py:764-1109). Here timing is a
small structured collector the driver wraps around each phase, plus an
optional jax.profiler trace hook for device profiling
(JAX_AL26_TRACE_DIR=/path enables it, or call start_trace/stop_trace;
utils.trace reduces a trace to per-op device times).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    """Accumulates wall-clock per named phase; cheap enough to always run.

    CAVEAT: jax dispatch is asynchronous — a phase that only ENQUEUES device
    work (e.g. the driver's "physics" phase) appears near-free, and the wait
    lands in whichever later phase first touches the results (the
    "checkpoint" phase's device_get). Interpret driver timings as
    physics ~= checkpoint unless a phase does real host work."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:<18s} total {total:8.3f} s   "
                f"x{n:<6d} avg {total / n * 1e3:8.2f} ms"
            )
        return "\n".join(lines)


_TRACE_ACTIVE = False


def maybe_start_trace() -> bool:
    """Start a jax.profiler trace if JAX_AL26_TRACE_DIR is set."""
    global _TRACE_ACTIVE
    trace_dir = os.environ.get("JAX_AL26_TRACE_DIR")
    if trace_dir and not _TRACE_ACTIVE:
        import jax

        jax.profiler.start_trace(trace_dir)
        _TRACE_ACTIVE = True
        return True
    return False


def maybe_stop_trace() -> None:
    global _TRACE_ACTIVE
    if _TRACE_ACTIVE:
        import jax

        jax.profiler.stop_trace()
        _TRACE_ACTIVE = False
