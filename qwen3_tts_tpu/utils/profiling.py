"""Per-stage wall-clock timing + RTF reporting.

Counterpart of the reference's printf timing (SURVEY §5): the same
simple per-stage counters, plus an optional jax.profiler trace hook for
Perfetto when deep profiling is needed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class StageTimer:
    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self, audio_seconds: Optional[float] = None) -> str:
        parts = [f"{k}={v * 1000:.1f}ms" for k, v in self.stages.items()]
        total = self.total()
        out = f"stages: {', '.join(parts)} | total={total:.3f}s"
        if audio_seconds and audio_seconds > 0:
            out += f" | audio={audio_seconds:.2f}s | RTF={total / audio_seconds:.3f}x"
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace wrapper (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
