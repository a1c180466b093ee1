"""Burn-rate SLOs and fleet straggler detection — the port's copy of
``torchft_tpu/telemetry/slo.py``.

**Burn-rate SLOs** (:class:`BurnRateSlo`, :class:`SloManager`): an SLO
says a fraction ``target`` of events must be good (a step's wall under
``TORCHFT_SLO_STEP_S``; a rejoin's time to its commit under
:data:`SLO_REJOIN_S`). A window's burn rate is its bad fraction over the
error budget ``1 - target``; a breach latches only when both the fast and
the slow window burn past :data:`SLO_BURN` (the fast one for latency, the
slow one against blips). A breach emits ``slo_breach``, counts in
``tft_slo_breach_total{slo}`` and rides the telemetry piggyback to
``/cluster.json``; the latch clears (``slo_recovered``) once the fast
window burns under 1.

**Straggler detection** (:class:`StragglerDetector`,
:class:`FleetMonitor`): each group's local step-time p50 (wall less the
peer-wait phases, ``anatomy.BARRIER_PHASES``) rides the piggyback and is
read back from ``/cluster.json``. A group whose p50 exceeds the median of
the OTHER groups by :data:`STRAGGLER_FACTOR` for :data:`STRAGGLER_K`
consecutive fresh observations latches ``straggler_detected`` once; K
observations back under the hysteresis threshold clear it
(``straggler_cleared``).

Knobs read from the environment: ``TORCHFT_SLO_STEP_S`` (0, the default,
turns the step SLO off), ``TORCHFT_STRAGGLER_POLL_S`` (the monitor's
period, 2 s) and ``TORCHFT_STRAGGLER_FACTOR`` / ``TORCHFT_STRAGGLER_K``
(the detector's factor and K when its constructor names none; the fault
matrix's ``diagnose_straggler`` workers take 2.0 and 3);
``TORCHFT_STRAGGLER_MONITOR=1`` makes a rank-0 Manager host a
:class:`FleetMonitor`. The rest are module constants that tests patch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from statistics import median
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = [
    "BurnRateSlo",
    "SloManager",
    "StragglerDetector",
    "FleetMonitor",
]


# the rejoin-to-commit SLO's threshold (s); 0 turns it off
SLO_REJOIN_S = 0.0
SLO_TARGET = 0.99  # the good-event objective
SLO_FAST_S = 60.0  # the fast burn window
SLO_SLOW_S = 600.0  # the slow burn window
SLO_BURN = 2.0  # the burn rate both windows must pass to latch
STRAGGLER_FACTOR = 1.5  # a p50 this far over its baseline counts as over
STRAGGLER_K = 5  # consecutive observations to latch and to clear


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class BurnRateSlo:
    """One SLO with fast/slow-window burn-rate evaluation (see module
    docstring for the math). Thread-compat: call from one thread (the
    Manager's main thread / a test)."""

    def __init__(
        self,
        name: str,
        threshold_s: float,
        target: Optional[float] = None,
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        burn: Optional[float] = None,
        min_events: int = 1,
    ) -> None:
        self.name = name
        self.threshold_s = float(threshold_s)
        self.target = target if target is not None else SLO_TARGET
        self.fast_s = fast_s if fast_s is not None else SLO_FAST_S
        self.slow_s = slow_s if slow_s is not None else SLO_SLOW_S
        self.burn = burn if burn is not None else SLO_BURN
        # a breach needs at least this many events in the fast window —
        # rare-event SLOs (rejoin) use 1, the step SLO a small handful so
        # a cold start's first slow step can't alarm on a sample of one
        self.min_events = min_events
        self._events: Deque[Tuple[float, bool]] = deque()
        self.breached = False
        self.breaches = 0

    def _budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def observe(self, value_s: float, now: Optional[float] = None) -> bool:
        """Record one event (good iff ``value_s <= threshold_s``) and
        re-evaluate; returns the latch state."""
        now = time.monotonic() if now is None else now
        self._events.append((now, value_s <= self.threshold_s))
        # prune past the slow window (nothing older can matter)
        horizon = now - self.slow_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()
        return self.evaluate(now)

    def _burn_rate(self, window_s: float, now: float) -> Optional[float]:
        """Bad fraction over the window divided by the error budget; None
        when the window holds fewer than ``min_events`` events."""
        lo = now - window_s
        total = bad = 0
        for ts, good in self._events:
            if ts < lo:
                continue
            total += 1
            if not good:
                bad += 1
        if total < self.min_events:
            return None
        return (bad / total) / self._budget()

    def evaluate(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        fast = self._burn_rate(self.fast_s, now)
        slow = self._burn_rate(self.slow_s, now)
        if (
            not self.breached
            and fast is not None
            and slow is not None
            and fast > self.burn
            and slow > self.burn
        ):
            self.breached = True
            self.breaches += 1
            try:
                from torchft_tpu_torch import telemetry

                telemetry.SLO_BREACH_TOTAL.labels(slo=self.name).inc()
                telemetry.emit(
                    "slo_breach",
                    slo=self.name,
                    threshold_s=self.threshold_s,
                    fast_burn=round(fast, 3),
                    slow_burn=round(slow, 3),
                )
            except Exception:  # noqa: BLE001 — never fail the step path
                pass
        elif self.breached and fast is not None and fast < 1.0:
            # spending slower than budget again: clear the latch
            self.breached = False
            try:
                from torchft_tpu_torch import telemetry

                telemetry.emit(
                    "slo_recovered", slo=self.name, fast_burn=round(fast, 3)
                )
            except Exception:  # noqa: BLE001
                pass
        return self.breached


class SloManager:
    """The Manager's pair of SLOs (step time, rejoin-to-commit): a
    threshold of 0 turns an evaluator off, so the default deployment pays
    nothing."""

    def __init__(self) -> None:
        step_thr = _env_float("TORCHFT_SLO_STEP_S", 0.0)
        rejoin_thr = SLO_REJOIN_S
        self.step: Optional[BurnRateSlo] = (
            BurnRateSlo("step_time", step_thr, min_events=8)
            if step_thr > 0
            else None
        )
        self.rejoin: Optional[BurnRateSlo] = (
            BurnRateSlo("rejoin_commit", rejoin_thr, min_events=1)
            if rejoin_thr > 0
            else None
        )

    def observe_step(self, wall_s: float) -> None:
        if self.step is not None:
            self.step.observe(wall_s)

    def observe_rejoin(self, duration_s: float) -> None:
        if self.rejoin is not None:
            self.rejoin.observe(duration_s)

    def breached(self) -> bool:
        return bool(
            (self.step is not None and self.step.breached)
            or (self.rejoin is not None and self.rejoin.breached)
        )


class StragglerDetector:
    """Latched per-group straggler detection over local-step p50s.

    Call :meth:`update` with one fresh observation per group (the
    FleetMonitor only calls when the fleet's max step advanced, so
    repeated identical reports don't inflate the consecutive counters).
    Hysteresis: latch at ``factor``, unlatch at ``unlatch_factor``
    (default ``0.8 * factor``), both requiring K consecutive
    observations — a group oscillating around the threshold neither
    flaps nor silently clears."""

    def __init__(
        self,
        factor: Optional[float] = None,
        k: Optional[int] = None,
        unlatch_factor: Optional[float] = None,
        min_groups: int = 2,
    ) -> None:
        self.factor = (factor if factor is not None
                       else _env_float("TORCHFT_STRAGGLER_FACTOR", STRAGGLER_FACTOR))
        self.k = int(k if k is not None else _env_float("TORCHFT_STRAGGLER_K", STRAGGLER_K))
        self.unlatch_factor = (
            unlatch_factor
            if unlatch_factor is not None
            else 0.8 * self.factor
        )
        self.min_groups = min_groups
        self._over: Dict[str, int] = {}
        self._under: Dict[str, int] = {}
        self._latched: Dict[str, bool] = {}

    def stragglers(self) -> List[str]:
        """Currently latched groups, sorted."""
        return sorted(g for g, v in self._latched.items() if v)

    def update(self, p50s: Dict[str, float]) -> List[Dict[str, Any]]:
        """One detection round over ``{group: local_step_p50_s}``; returns
        the events emitted (latch/clear records)."""
        events: List[Dict[str, Any]] = []
        live = {g: v for g, v in p50s.items() if v and v > 0}
        if len(live) < self.min_groups:
            # no detection round happened: every streak breaks ("K
            # consecutive" must mean consecutive detection rounds, never
            # K jittery samples separated by a fleet-too-small gap)
            self._over.clear()
            self._under.clear()
            return events
        # a group absent from this round (manager restart, no report yet)
        # breaks ITS streaks the same way; the latch itself persists —
        # absence is not evidence of recovery
        for group in list(self._over):
            if group not in live:
                self._over[group] = 0
        for group in list(self._under):
            if group not in live:
                self._under[group] = 0
        for group, p50 in live.items():
            others = [v for g, v in live.items() if g != group]
            baseline = median(others)
            if baseline <= 0:
                continue
            over = p50 > self.factor * baseline
            under = p50 < self.unlatch_factor * baseline
            if over:
                self._over[group] = self._over.get(group, 0) + 1
                self._under[group] = 0
            else:
                self._over[group] = 0
                if under:
                    self._under[group] = self._under.get(group, 0) + 1
                else:
                    self._under[group] = 0
            if not self._latched.get(group) and self._over[group] >= self.k:
                self._latched[group] = True
                ev = {
                    "group": group,
                    "p50_s": round(p50, 6),
                    "baseline_s": round(baseline, 6),
                    "factor": self.factor,
                }
                events.append({"event": "straggler_detected", **ev})
                try:
                    from torchft_tpu_torch import telemetry

                    telemetry.STRAGGLER_DETECTED.labels(group=group).inc()
                    telemetry.STRAGGLERS.set(len(self.stragglers()))
                    telemetry.emit("straggler_detected", **ev)
                except Exception:  # noqa: BLE001
                    pass
            elif self._latched.get(group) and self._under[group] >= self.k:
                self._latched[group] = False
                ev = {
                    "group": group,
                    "p50_s": round(p50, 6),
                    "baseline_s": round(baseline, 6),
                }
                events.append({"event": "straggler_cleared", **ev})
                try:
                    from torchft_tpu_torch import telemetry

                    telemetry.STRAGGLERS.set(len(self.stragglers()))
                    telemetry.emit("straggler_cleared", **ev)
                except Exception:  # noqa: BLE001
                    pass
        return events


class FleetMonitor:
    """Polls the lighthouse's ``/cluster.json`` aggregation and feeds the
    per-replica ``local_step_p50_s`` scalars into a
    :class:`StragglerDetector` — the fleet-side consumer of the anatomy
    piggyback. Run one per fleet (a rank-0 Manager starts one when
    ``TORCHFT_STRAGGLER_MONITOR=1``)."""

    def __init__(
        self,
        lighthouse_addr: str,
        detector: Optional[StragglerDetector] = None,
        poll_s: Optional[float] = None,
    ) -> None:
        self.addr = lighthouse_addr
        self.detector = detector or StragglerDetector()
        self.poll_s = poll_s if poll_s is not None else _env_float(
            "TORCHFT_STRAGGLER_POLL_S", 2.0
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guarded-by: _lock
        self._max_step = -1
        self._lock = threading.Lock()

    def poll_once(self) -> List[Dict[str, Any]]:
        """One poll + detection round (also the testable core). Only runs
        the detector when the fleet's max reported step advanced, so a
        stalled scrape target can't inflate the consecutive counters."""
        from torchft_tpu_torch.telemetry.native import poll_cluster

        cluster = poll_cluster(self.addr)
        if not cluster:
            return []
        replicas = cluster.get("replicas") or {}
        p50s: Dict[str, float] = {}
        max_step = -1
        for rid, rec in replicas.items():
            try:
                p50s[rid] = float(rec.get("local_step_p50_s") or 0.0)
                max_step = max(max_step, int(rec.get("step", -1)))
            except (TypeError, ValueError):
                continue
        with self._lock:
            if max_step <= self._max_step:
                return []
            self._max_step = max_step
        return self.detector.update(p50s)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass

    def start(self) -> "FleetMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tft_fleet_monitor"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 2.0)
            self._thread = None
