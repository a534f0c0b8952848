"""Phase timers and profiling hooks.

Analog of the reference's PTimer usage (SURVEY.md §5: tic!/toc! with
barriers around phases, timer data merged into benchmark output,
joss_paper/scalability/src/stokes_gmg.jl:2-36):

- fences wait for every leaf with jax.block_until_ready;
- `trace` wraps a region with jax.profiler for TensorBoard-compatible
  traces of the XLA execution.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


def fence(x) -> None:
    """Completion barrier: waits until every leaf of x is computed."""
    jax.block_until_ready(x)


class PTimer:
    """Named phase wall timers (reference PTimer: tic!/toc!)."""

    def __init__(self):
        self.data: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def tic(self, name: str, barrier=None):
        if barrier is not None:
            fence(barrier)
        self._t0[name] = time.perf_counter()

    def toc(self, name: str, barrier=None):
        if barrier is not None:
            fence(barrier)
        self.data[name] = self.data.get(name, 0.0) + (
            time.perf_counter() - self._t0.pop(name)
        )

    @contextlib.contextmanager
    def phase(self, name: str, barrier=None):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name, barrier=barrier)

    def report(self) -> str:
        lines = [f"{k:30s} {v:10.4f}s" for k, v in sorted(self.data.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace of the enclosed region (view in TensorBoard /
    xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
