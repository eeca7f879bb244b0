"""Metrics: WER/TER, throughput meters, and pluggable tracking sinks.

Own copy of ``statecatcher_tpu/metrics.py`` (framework-free).

Replaces the reference's jiwer dependency (reference train.py:19,250) with a
small host-side Levenshtein, and the reference's Aim calls
(train.py:44-48,542-560) with a sink interface (stdout/JSONL).  The
per-parameter grad-norm host sync the reference does every update
(train.py:555-560, a throughput hazard) is replaced by a single device-side
global-norm scalar fetched asynchronously.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


# --------------------------------------------------------------------------- #
# WER (word error rate) — jiwer-equivalent Levenshtein on whitespace tokens
# --------------------------------------------------------------------------- #
def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def wer(refs: list[str], hyps: list[str]) -> float:
    """Corpus WER: total edits / total reference words (jiwer semantics)."""
    total_edits = 0
    total_words = 0
    for ref, hyp in zip(refs, hyps):
        r = ref.split()
        h = hyp.split()
        total_edits += edit_distance(r, h)
        total_words += len(r)
    if total_words == 0:
        return 0.0 if total_edits == 0 else float("inf")
    return total_edits / total_words


def cer(refs: list[str], hyps: list[str]) -> float:
    total_edits = sum(edit_distance(list(r), list(h)) for r, h in zip(refs, hyps))
    total_chars = sum(len(r) for r in refs)
    if total_chars == 0:
        return 0.0 if total_edits == 0 else float("inf")
    return total_edits / total_chars


# --------------------------------------------------------------------------- #
# Tracking sinks
# --------------------------------------------------------------------------- #
class MetricsSink:
    def track(self, value: float, name: str, step: int):  # pragma: no cover
        raise NotImplementedError

    def set_params(self, params: dict):
        pass

    def close(self):
        pass


class LoggingSink(MetricsSink):
    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("statecatcher.metrics")

    def track(self, value, name, step):
        self.logger.info("[step %d] %s = %.6g", step, name, value)

    def set_params(self, params):
        self.logger.info("hparams: %s", params)


class JsonlSink(MetricsSink):
    """Append-only JSONL metrics file — cheap, greppable, plottable."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def track(self, value, name, step):
        self._f.write(json.dumps({"t": time.time(), "step": step, name: float(value)}) + "\n")
        self._f.flush()

    def set_params(self, params):
        self._f.write(json.dumps({"t": time.time(), "hparams": params}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def make_sinks(logger, run_dir: str) -> "MultiSink":
    """Default sink stack: log + JSONL (the JAX package's Aim sink is not
    ported)."""
    import os

    return MultiSink([LoggingSink(logger), JsonlSink(os.path.join(run_dir, "metrics.jsonl"))])


class MultiSink(MetricsSink):
    def __init__(self, sinks: list[MetricsSink]):
        self.sinks = sinks

    def track(self, value, name, step):
        for s in self.sinks:
            s.track(value, name, step)

    def set_params(self, params):
        for s in self.sinks:
            s.set_params(params)

    def close(self):
        for s in self.sinks:
            s.close()


# --------------------------------------------------------------------------- #
# Throughput meter — the north-star metric is audio-seconds/s/chip
# --------------------------------------------------------------------------- #
@dataclass
class ThroughputMeter:
    """Tracks wall-clock and audio-seconds processed over a sliding window."""

    window: int = 50
    _events: list = field(default_factory=list)

    def step(self, audio_seconds: float):
        self._events.append((time.perf_counter(), audio_seconds))
        if len(self._events) > self.window + 1:
            self._events.pop(0)

    @property
    def audio_seconds_per_second(self) -> float:
        if len(self._events) < 2:
            return 0.0
        t0, _ = self._events[0]
        t1, _ = self._events[-1]
        total_audio = sum(a for _, a in self._events[1:])
        dt = t1 - t0
        return total_audio / dt if dt > 0 else 0.0


@dataclass
class StageTimer:
    """Cheap always-on per-stage wall clock (reference train.py debug timers)."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1

        return _Ctx()

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "mean_s": v / max(1, self.counts[k]), "n": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }


class LossOutlierDetector:
    """Robust per-utterance loss outlier detector (hallucination filter).

    The last reference roadmap item (reference README.md:30: "on-the-fly
    hallucination detection and filtering of bad automatic transcripts"):
    mis-aligned VTTs are endemic in podcast data, and a garbage transcript
    shows up as a per-utterance loss far above its peers.  This keeps a
    rolling window of recent per-utterance losses and flags values whose
    robust z-score — (x − median) / (1.4826·MAD) — exceeds ``zscore``.
    Median/MAD (not mean/std) so the outliers being hunted cannot poison
    the statistics; flagged values are NOT added to the window.
    """

    def __init__(self, zscore: float = 6.0, window: int = 512,
                 min_window: int = 64, min_rel: float = 0.05):
        from collections import deque

        self.zscore = float(zscore)
        self.min_window = int(min_window)
        # Relative-excess floor: when a batch's losses are nearly identical
        # (homogeneous data), MAD collapses and harmless ~1 % deviations
        # produce huge z-scores — measured as mass false quarantines on a
        # uniform synthetic corpus (tools/profile_e2e_flagship.py).  A flag
        # additionally requires the value to exceed ``min_rel`` of the
        # caller-provided scale (the group median loss); a genuinely
        # mis-aligned transcript measures >10 % excess (test fixture: 12.7 %).
        self.min_rel = float(min_rel)
        self._win = deque(maxlen=int(window))
        self.flagged = 0

    def _z(self, x: float) -> float:
        vals = np.fromiter(self._win, dtype=np.float64)
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med)))
        return (x - med) / (1.4826 * mad + 1e-9)

    def update(self, x: float, scale: float | None = None) -> bool:
        """Observe one per-utterance loss (residual); True = outlier.

        ``scale``: magnitude reference for the relative-excess floor
        (callers pass the group median loss; None disables the floor)."""
        import math

        if not math.isfinite(x):
            return False          # non-finite is the bad-segment filter's job
        big_enough = (
            scale is None or x > self.min_rel * max(abs(scale), 1e-9)
        )
        n = len(self._win)
        if n >= self.min_window:
            if big_enough and self._z(x) > self.zscore:
                self.flagged += 1
                return True
        elif n >= max(4, self.min_window // 8) and self._z(x) > self.zscore:
            # warm-up absorption guard: flagging isn't allowed yet, but an
            # extreme value is still WITHHELD from the window — a bad
            # recording present from step 0 must not poison the bootstrap
            # statistics it will later be judged against
            return False
        self._win.append(float(x))
        return False
