"""Failure detection & recovery helpers (SURVEY §5.3).

The reference's error model is int return codes checked and propagated with
logged context, exceptions caught at job boundaries
(``train_gmm_mono.cpp:919-927``), and recovery by re-run (mtime phase skip +
``stage`` resume).  This build adds what the reference lacks:

* :func:`check_finite` — numerical-divergence detection on EM sufficient
  statistics and model updates (NaN/Inf propagating through a jitted program
  is otherwise silent until WER collapses).
* :class:`FailureTracker` — per-utterance failure accounting with a bounded
  tolerated fraction: stages skip and log bad utterances (corrupt wav,
  unalignable transcript) like the reference's per-job error paths, but a
  systemic failure (most utterances failing) aborts loudly instead of
  training on near-empty statistics.
* Preemption recovery is checkpoint-based (``utils/checkpoint.py``), tested
  by killing a training subprocess mid-run (tests/test_failure.py) — the
  elastic story for single-host training.
"""

from __future__ import annotations

import numpy as np

from .logging import get_logger

log = get_logger()

# scores below this are the decoder's -inf sentinel, not a numerical fault
_SENTINEL = -1.0e29


class NumericalDivergence(RuntimeError):
    """EM statistics or model parameters contain NaN/Inf."""


class TooManyFailures(RuntimeError):
    """A stage failed on more than ``max_fail_frac`` of its utterances."""


def check_finite(stage: str, **arrays) -> None:
    """Raise :class:`NumericalDivergence` when any named array holds NaN or
    +/-Inf (values at or below the decoder's -inf sentinel are allowed)."""
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.size == 0:
            continue
        bad = ~np.isfinite(a)
        if a.dtype.kind == "f":
            bad &= ~(a <= _SENTINEL)
        if bad.any():
            idx = np.argwhere(bad)[0]
            raise NumericalDivergence(
                f"{stage}: non-finite value in '{name}' at {tuple(idx)} "
                f"(shape {a.shape}, first bad={a[tuple(idx)]!r})")


class FailureTracker:
    """Counts per-utterance failures for one stage and enforces a bound.

    Usage::

        ft = FailureTracker("align", total=len(utts))
        ...
        ft.record(utt, "no path through training graph")
        ...
        ft.finish(max_fail_frac=0.5)   # logs summary; raises if excessive
    """

    def __init__(self, stage: str, total: int):
        self.stage = stage
        self.total = total
        self.failed: dict[str, str] = {}

    def record(self, utt: str, reason: str) -> None:
        self.failed[utt] = reason
        log.warning("%s: failed for %s: %s", self.stage, utt, reason)

    @property
    def num_failed(self) -> int:
        return len(self.failed)

    def finish(self, max_fail_frac: float = 0.5) -> None:
        n = self.num_failed
        if n == 0:
            return
        frac = n / max(self.total, 1)
        log.warning("%s: %d/%d utterances failed (%.1f%%)", self.stage, n,
                    self.total, 100.0 * frac)
        if frac > max_fail_frac or n == self.total:
            examples = "; ".join(f"{u}: {r}" for u, r in
                                 list(self.failed.items())[:5])
            raise TooManyFailures(
                f"{self.stage}: {n}/{self.total} utterances failed "
                f"(> {max_fail_frac:.0%} tolerated). First failures: "
                f"{examples}")
