"""Profiling & throughput metrics (SURVEY §5.1).

The reference has only ``kaldi::Timer`` + per-job logs (``base/timer.h``);
this build makes tracing and audio-throughput first-class:

* ``trace(logdir)`` — context manager around ``jax.profiler.trace`` so any
  pipeline stage can be captured for TensorBoard/Perfetto.
* ``StageTimer`` — wall-clock per stage with audio-seconds accounting,
  reported as audio-s/s (the framework's headline metric).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from .logging import get_logger

log = get_logger()


@contextlib.contextmanager
def trace(logdir: str | Path | None):
    """JAX profiler trace of the enclosed block (no-op when logdir=None)."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(logdir)):
        yield


@dataclass
class StageTimer:
    """Accumulates per-stage wall time and processed audio seconds.

    Usage::

        timer = StageTimer()
        with timer.stage("mfcc", audio_s=total_audio):
            ...
        timer.report()   # logs audio-s/s per stage + totals
    """

    stages: dict = field(default_factory=dict)  # name -> [wall_s, audio_s, n]

    @contextlib.contextmanager
    def stage(self, name: str, audio_s: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            w, a, n = self.stages.get(name, (0.0, 0.0, 0))
            self.stages[name] = (w + wall, a + audio_s, n + 1)

    def throughput(self, name: str) -> float:
        """audio-s/s for one stage (0 when no audio accounted)."""
        w, a, _ = self.stages.get(name, (0.0, 0.0, 0))
        return a / w if w > 0 else 0.0

    def report(self) -> dict:
        out = {}
        for name, (w, a, n) in self.stages.items():
            entry = {"wall_s": round(w, 3), "calls": n}
            if a:
                entry["audio_s"] = round(a, 2)
                entry["audio_s_per_s"] = round(a / w, 2) if w else 0.0
            out[name] = entry
            log.info("stage %-16s wall=%7.2fs calls=%d%s", name, w, n,
                     f" audio-s/s={entry.get('audio_s_per_s')}" if a else "")
        return out

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=1))
