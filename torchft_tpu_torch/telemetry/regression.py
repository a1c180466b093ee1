"""The perf-regression sentinel: Page-Hinkley level-shift detection over
the lighthouse's time series — the port's copy of
``torchft_tpu/telemetry/regression.py``.

It covers what the other detectors cannot see: the SLO needs an absolute
threshold, the straggler detector compares groups with each other (a
fleet that slows down together moves its own baseline), and the watchdog
only fires on stalls. For each watched ``(replica, series)`` stream it
runs a one-sided (slower is bad) Page-Hinkley test,
``m_t = sum(x_i - loc_i - delta)``, latching when ``m_t - min(m_t) >
lambda``, with ``loc`` a running median and delta and lambda relative to
it, so one setting covers a 50 ms phase and a 2 s step. A latch emits one
``perf_regression`` event naming the ``(replica, series)`` (for
``phase.*`` series: which replica's which phase) and counts in
``tft_perf_regression_total{replica,series}``; K samples back at the
pre-shift baseline clear it (``perf_regression_cleared``).

``TORCHFT_REGRESSION_MONITOR=1`` makes a rank-0 Manager host a
:class:`RegressionMonitor` beside the critical-path monitor, polling
every ``TORCHFT_REGRESSION_POLL_S`` (2 s). The test's settings
(:data:`DELTA`, :data:`LAMBDA`, :data:`MIN_N`, :data:`K`,
:data:`FLOOR_S`) and the watched series prefixes (:data:`SERIES`; the
barrier phases are left out unless listed by exact name: they measure a
peer's slowness, not this replica's) are module constants that tests
patch.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "PageHinkley",
    "RegressionDetector",
    "RegressionMonitor",
]


DELTA = 0.05  # drift allowance, a fraction of the running median
LAMBDA = 3.0  # latch threshold, a multiple of the running median
MIN_N = 8  # samples before the statistic arms
K = 5  # consecutive samples back at the baseline to clear a latch
FLOOR_S = 0.02  # the test stays disarmed while the stream's median is below this
SERIES: Tuple[str, ...] = ("local_s", "phase.")  # watched series-name prefixes


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class PageHinkley:
    """One-sided Page-Hinkley test for an UPWARD level shift (durations:
    up = slower = bad), with relative δ/λ, a ROBUST location estimate
    and latch/clear hysteresis.

    Two robustness choices:

    * the location estimate is a running **median** over a bounded
      window, not a mean — a trainer's first steps are many times the
      steady state (compile, capture), and a mean poisoned by two
      warm-up samples can sit above the shifted level for the whole run;
    * positive deviations are **winsorized** at 2× the location — one
      10× spike (a recapture, a GC pause) must contribute a bounded step to
      the statistic, not an instant latch; a real level shift persists
      and accumulates past λ anyway.

    States: warming (n < min_n, or location under the floor) → armed →
    latched. While latched the pre-shift baseline is frozen (an adapting
    location would chase the shift and declare the new level normal);
    K consecutive samples back under ``baseline × (1 + δ)`` clear the
    latch and re-arm fresh."""

    WINDOW = 256  # samples kept for the running median
    CLIP = 2.0    # positive-deviation winsor, multiples of the location

    def __init__(
        self,
        delta: Optional[float] = None,
        lam: Optional[float] = None,
        min_n: Optional[int] = None,
        k: Optional[int] = None,
        floor: Optional[float] = None,
    ) -> None:
        self.delta = delta if delta is not None else DELTA
        self.lam = lam if lam is not None else LAMBDA
        self.min_n = int(min_n if min_n is not None else MIN_N)
        self.k = int(k if k is not None else K)
        self.floor = floor if floor is not None else FLOOR_S
        from collections import deque

        self._window: Any = deque(maxlen=self.WINDOW)
        self.n = 0
        self.location = 0.0  # running median of the window
        self._mh = 0.0
        self._mh_min = 0.0
        self.latched = False
        self.latches = 0
        self.baseline = 0.0  # frozen pre-shift location while latched
        self._under = 0

    def observe(self, x: float) -> Optional[str]:
        """Feed one sample; returns ``"latched"`` / ``"cleared"`` on a
        transition, else None."""
        from statistics import median

        if self.latched:
            # frozen baseline: recovery means returning to where the
            # stream WAS, not to wherever the shift dragged the location
            if x <= self.baseline * (1.0 + self.delta):
                self._under += 1
                if self._under >= self.k:
                    self.latched = False
                    self._under = 0
                    # re-arm fresh: the episode is over
                    self._window.clear()
                    self._window.append(x)
                    self.n = 1
                    self.location = x
                    self._mh = 0.0
                    self._mh_min = 0.0
                    return "cleared"
            else:
                self._under = 0
            return None
        self.n += 1
        self._window.append(x)
        self.location = median(self._window)
        if self.n < self.min_n:
            return None  # baseline warm-up: nothing to deviate from yet
        scale = abs(self.location)
        if scale < self.floor:
            # a relative test on a millisecond-scale stream measures
            # scheduler noise, not performance: stay disarmed
            self._mh = 0.0
            self._mh_min = 0.0
            return None
        dev = x - self.location - self.delta * scale
        if dev > self.CLIP * scale:
            dev = self.CLIP * scale  # winsorize: one spike, bounded step
        self._mh += dev
        self._mh_min = min(self._mh_min, self._mh)
        if (self._mh - self._mh_min) > self.lam * scale:
            self.latched = True
            self.latches += 1
            self.baseline = self.location
            self._under = 0
            return "latched"
        return None


# Peer-wait phases are the SYMPTOM side of a slowdown (a slow peer
# inflates everyone else's barriers) — watching them would blame victims.
# Same reasoning as critical_path's non-barrier blame split; excluded
# from the watch unless a deployment lists one by exact name.
def _barrier_series() -> Tuple[str, ...]:
    from torchft_tpu_torch.telemetry.anatomy import BARRIER_PHASES

    return tuple(f"phase.{p}" for p in BARRIER_PHASES)


class RegressionDetector:
    """Per-(replica, series) Page-Hinkley bank over the watched series
    prefixes. Feed with :meth:`observe`; emits ``perf_regression`` /
    ``perf_regression_cleared`` events and bumps
    ``tft_perf_regression_total{replica,series}`` on transitions."""

    def __init__(
        self,
        prefixes: Optional[Tuple[str, ...]] = None,
        **ph_kwargs: Any,
    ) -> None:
        self._ph_kwargs = ph_kwargs
        self.prefixes = (
            tuple(prefixes) if prefixes is not None else SERIES
        )
        self._tests: Dict[Tuple[str, str], PageHinkley] = {}

    def watched(self, series: str) -> bool:
        if series in _barrier_series() and series not in self.prefixes:
            return False
        return any(series.startswith(p) for p in self.prefixes)

    def regressed(self) -> List[Tuple[str, str]]:
        """Currently latched (replica, series) pairs, sorted."""
        return sorted(
            key for key, ph in self._tests.items() if ph.latched
        )

    def observe(
        self, replica: str, series: str, step: int, value: float
    ) -> Optional[Dict[str, Any]]:
        """One sample; returns the emitted event record on a latch/clear
        transition, else None."""
        if not self.watched(series):
            return None
        key = (replica, series)
        ph = self._tests.get(key)
        if ph is None:
            ph = self._tests[key] = PageHinkley(**self._ph_kwargs)
        transition = ph.observe(value)
        if transition is None:
            return None
        # phase.<name> series name the anatomy phase directly; the rest
        # (local_s, wall_s, lat.*) name themselves
        phase = (
            series[len("phase."):] if series.startswith("phase.") else series
        )
        if transition == "latched":
            ev = {
                "event": "perf_regression",
                "replica": replica,
                "series": series,
                "phase": phase,
                "step": step,
                "baseline_s": round(ph.baseline, 6),
                "value_s": round(value, 6),
            }
            try:
                from torchft_tpu_torch import telemetry

                telemetry.PERF_REGRESSION_TOTAL.labels(
                    replica=replica, series=series
                ).inc()
                telemetry.emit(
                    "perf_regression",
                    **{k: v for k, v in ev.items() if k != "event"},
                )
            except Exception:  # noqa: BLE001 — never fail the monitor
                pass
            return ev
        ev = {
            "event": "perf_regression_cleared",
            "replica": replica,
            "series": series,
            "phase": phase,
            "step": step,
            "value_s": round(value, 6),
        }
        try:
            from torchft_tpu_torch import telemetry

            telemetry.emit(
                "perf_regression_cleared",
                **{k: v for k, v in ev.items() if k != "event"},
            )
        except Exception:  # noqa: BLE001
            pass
        return ev


class RegressionMonitor:
    """Fleet-side host: polls the lighthouse's ``/timeseries.json`` and
    feeds every new sample of the watched series to a
    :class:`RegressionDetector`, in step order per stream. Run one per
    fleet (a rank-0 Manager hosts one under
    ``TORCHFT_REGRESSION_MONITOR=1``)."""

    def __init__(
        self,
        lighthouse_addr: str,
        detector: Optional[RegressionDetector] = None,
        poll_s: Optional[float] = None,
    ) -> None:
        self.addr = lighthouse_addr
        self.detector = detector or RegressionDetector()
        self.poll_s = poll_s if poll_s is not None else _env_float(
            "TORCHFT_REGRESSION_POLL_S", 2.0
        )
        self._cursor: Dict[Tuple[str, str], int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(
        self, reply: Optional[Dict[str, Any]] = None
    ) -> List[Dict[str, Any]]:
        """One poll + detection round; returns the transition events
        emitted (also the testable core). Pass ``reply`` to reuse a
        /timeseries.json fetch another consumer already paid for (the
        Manager's history thread feeds this monitor and the critical-path
        monitor from ONE poll — the full-ring reply can be megabytes)."""
        from torchft_tpu_torch.telemetry.timeseries import (
            iter_new_samples,
            poll_timeseries,
        )

        if reply is None:
            reply = poll_timeseries(self.addr)
        if not reply:
            return []
        events: List[Dict[str, Any]] = []
        for rid, name, _epoch, step, value in iter_new_samples(
            reply, self._cursor
        ):
            ev = self.detector.observe(rid, name, step, value)
            if ev is not None:
                events.append(ev)
        return events

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass

    def start(self) -> "RegressionMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tft_regression_monitor"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 2.0)
            self._thread = None
