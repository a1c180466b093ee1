"""Tracing / profiling hooks — the port's copy of ``torchft_tpu/profiling.py``.

``timed`` logs a block's wall clock; ``profile`` wraps ``torch.profiler``
with CPU and CUDA activities around a block and writes a Chrome trace
(where the JAX package wraps ``jax.profiler``); ``StepTimer`` keeps a
rolling steps/sec with quorum/heal steps marked as outliers, feeding the
``tft_step_duration_seconds`` histogram in :mod:`torchft_tpu_torch.telemetry`.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from collections import deque
from typing import Deque, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = ["timed", "profile", "StepTimer"]


@contextlib.contextmanager
def timed(what: str, log: logging.Logger = logger) -> Iterator[None]:
    """Log the wall-clock duration of a block (the reference's ``_time``).

    Prefer a :class:`~torchft_tpu_torch.telemetry.registry.Histogram` ``.time()``
    for recurring spans — this context manager only logs; it records
    nothing scrapable."""
    t0 = time.perf_counter()
    yield
    log.info("%s took %.3fs", what, time.perf_counter() - t0)


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace (CPU and, where the card is there, CUDA
    activities) around a block, written as a Chrome trace to
    ``<log_dir>/trace_<pid>_<n>.json``; no-op if log_dir is None.

    Open it in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:
    host ops, the kernels on the card's streams (those inside a CUDA graph
    replay too) and the ``record_function`` ranges."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_PROFILE_SEQ)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("profile written to %s", path)


_PROFILE_SEQ = itertools.count(1)


class StepTimer:
    """Rolling training-step telemetry with quorum/heal outlier marking.

    Steps that absorbed an FT lifecycle event (a quorum reconfigure, a
    heal) are *outliers*: their duration is real recovery cost, not
    steady-state throughput, so they are excluded from the headline
    rolling rate and reported separately. Mark them either up front
    (:meth:`mark_quorum` / :meth:`mark_heal` any time before the boundary)
    or at the boundary (``tick(quorum=..., heal=...)``).

    Every step duration is also observed into the process-wide
    ``tft_step_duration_seconds{kind=...}`` histogram (kind ``steady``,
    ``quorum`` or ``heal`` — heal wins when both apply, since it
    dominates the cost), so the recovery envelope is readable from
    recorded telemetry: the outlier durations ARE the per-step recovery
    cost the paper's "at most one step" claim bounds.
    """

    def __init__(self, window: int = 50, record_metrics: bool = True) -> None:
        self._window: Deque[float] = deque(maxlen=window)  # steady only
        self._all_window: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None
        self._pending: set = set()
        self._outliers: Deque[Tuple[int, float, Tuple[str, ...]]] = deque(
            maxlen=window
        )
        self._record_metrics = record_metrics
        self.steps = 0
        self.outlier_steps = 0
        self.last_tags: Tuple[str, ...] = ()

    def mark_quorum(self) -> None:
        """Flag the in-flight step as having absorbed a quorum reconfigure."""
        self._pending.add("quorum")

    def mark_heal(self) -> None:
        """Flag the in-flight step as having absorbed a heal."""
        self._pending.add("heal")

    def tick(self, quorum: bool = False, heal: bool = False) -> Optional[float]:
        """Mark a step boundary; returns this step's duration (None on the
        first call)."""
        if quorum:
            self._pending.add("quorum")
        if heal:
            self._pending.add("heal")
        now = time.perf_counter()
        if self._last is None:
            # no previous boundary to measure from — HOLD the pending
            # marks instead of discarding them: a rejoiner heals before
            # its first boundary, and the heal must tag its first
            # measurable step or the recovery never shows as an outlier
            self._last = now
            self.steps += 1
            self.last_tags = ()
            return None
        tags = tuple(sorted(self._pending))
        self._pending.clear()
        self.last_tags = tags
        dur = now - self._last
        self._all_window.append(dur)
        if tags:
            self.outlier_steps += 1
            self._outliers.append((self.steps, dur, tags))
        else:
            self._window.append(dur)
        if self._record_metrics:
            kind = "heal" if "heal" in tags else (
                "quorum" if "quorum" in tags else "steady"
            )
            from torchft_tpu_torch import telemetry

            telemetry.STEP_DURATION.labels(kind=kind).observe(dur)
        self._last = now
        self.steps += 1
        return dur

    def steps_per_sec(self) -> Optional[float]:
        """Headline rolling rate over STEADY steps only (quorum/heal
        outliers excluded, so one recovery doesn't crater the number)."""
        if not self._window:
            return None
        return len(self._window) / sum(self._window)

    def steps_per_sec_all(self) -> Optional[float]:
        """Rolling rate over every step, outliers included — the rate a
        wall clock actually observed."""
        if not self._all_window:
            return None
        return len(self._all_window) / sum(self._all_window)

    def outliers(self) -> List[Tuple[int, float, Tuple[str, ...]]]:
        """Recent outlier steps as (step_index, duration_s, tags) — the
        recorded recovery cost per FT event."""
        return list(self._outliers)

    def outlier_digest(self) -> List[dict]:
        """JSON-safe form of :meth:`outliers` — exported through the
        step-anatomy summaries and the flight-recorder/SIGUSR2 dumps
        (``telemetry.anatomy.LEDGER.attach_timer``), so the tagged
        recovery costs finally leave the process instead of living and
        dying in this deque."""
        return [
            {"step": s, "duration_s": round(d, 4), "tags": list(tags)}
            for s, d, tags in self._outliers
        ]
