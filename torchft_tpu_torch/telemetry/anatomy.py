"""Step-anatomy ledger — per-step wall-clock attribution into named phases;
the port's copy of ``torchft_tpu/telemetry/anatomy.py`` without the
black-box mirror.

On the card a train step's halves replay from CUDA graphs and return at
once: the ``compute`` record is the host time of the replay calls, and the
device's tail lands in whichever phase blocks on it next (see ``PERF.md``
for which, plane by plane). No record reads a tensor or syncs the device.

The paper's per-step fault tolerance means every step pays a quorum, an
averaging collective and a commit vote; without a ledger only the wire
plane's four codec stages would be attributable, and only as
process-cumulative totals. The ledger decomposes each step's wall clock
into the phases

    compute / host_copy / quantize / wire / dequant_reduce /
    quorum_wait / commit_barrier / heal / telemetry / idle

assembled from instrumentation that already existed piecemeal —
``collectives.record_wire_stage`` (now a thin shim over this ledger),
the Manager's quorum-wait/commit-barrier timing, ``StepTimer``'s
quorum/heal outlier tagging — plus explicit ``compute`` records from
``TrainStep``. ``idle`` is the residual, so the row always sums to the
measured wall clock **exactly** (the bench ``step_anatomy`` acceptance
reconciles p50 sums to within 5%, which the residual makes structural).

Two accounting views, one mechanism:

* **step rows** decompose the MAIN thread's wall clock: records made on
  the main thread enter the row — an op-thread socket pump overlaps the
  main thread and cannot be part of a wall-clock decomposition. A row
  phase recorded off the main thread (``telemetry``: the report's build
  and encode on the quorum thread) overlaps the main thread's own phases
  (its compute, or the quorum wait that covers it): it takes the row's
  residual, never more, so the row still sums to its wall (the JAX
  ledger adds it in full and can pass the wall);
* **wire-stage totals** keep the wire plane's semantics: every
  ``record_wire_stage`` call (either thread) accumulates into the
  process-cumulative per-stage totals the crossgroup bench reads via
  ``collectives.wire_stage_snapshot`` — the shim's old private dict is
  gone; this ledger is the one source of truth.

The ledger also derives the **local step time** — wall minus the
peer-wait phases (``wire``/``quorum_wait``/``commit_barrier``/``heal``)
— whose rolling p50 is the straggler-discriminating signal: in a
synchronous fleet one slow group stretches *everyone's* wall clock, but
only the straggler's local time grows (the victims' extra time lands in
their barrier phases). That p50 is piggybacked to the lighthouse and fed
to the fleet plane's straggler detector (``telemetry/slo.py``).

Histograms use the fixed log2 bucket grid ``LOG2_BUCKETS`` (2^-20 s ..
2^6 s), the same bounds as the native plane's latency histograms
(``native/lathist.h``), so cross-process and cross-plane merges are exact
count additions — see :func:`merge_lathist`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "PHASES",
    "WIRE_STAGES",
    "BARRIER_PHASES",
    "LOG2_BUCKETS",
    "StepLedger",
    "LEDGER",
    "merge_lathist",
    "lathist_quantile",
]

# The named phases of one step's wall clock (docs/observability.md
# "Step anatomy"). `idle` is the residual — rows sum to wall by
# construction.
PHASES = (
    "compute",
    "host_copy",
    "quantize",
    "wire",
    "dequant_reduce",
    "quorum_wait",
    "commit_barrier",
    "heal",
    "telemetry",
    "idle",
)

# The wire plane's stage vocabulary (authoritative here; collectives.py
# re-exports it).
WIRE_STAGES = ("host_copy", "quantize", "wire", "dequant_reduce")

# Phases that absorb *peer* skew in a synchronous fleet: a slow group
# shows up in everyone ELSE's barrier phases, so excluding them from the
# local-time signal is what lets the straggler detector name the right
# group instead of flagging the whole fleet.
BARRIER_PHASES = ("wire", "quorum_wait", "commit_barrier", "heal")

# One bucket per binary order of magnitude, ~1 µs .. 64 s — identical to
# native/lathist.h's grid (_native.LATHIST_BOUNDS_S), so bucket counts
# from the Python and native planes merge exactly.
LOG2_BUCKETS = tuple(2.0 ** e for e in range(-20, 7))


def _lathist_sum_ns(h: Dict[str, Any]) -> int:
    # two on-the-wire shapes carry the same histogram: the ctypes
    # snapshot (sum_ns, exact integer) and the lighthouse /status.json
    # "latency" entries (sum_s, rendered seconds) — accept both so the
    # documented "merge anything on the fixed grid" contract holds
    if "sum_ns" in h:
        return int(h["sum_ns"])
    return int(round(float(h.get("sum_s", 0.0)) * 1e9))


def merge_lathist(
    a: Dict[str, Dict[str, Any]], b: Dict[str, Dict[str, Any]]
) -> Dict[str, Dict[str, Any]]:
    """Merge two native-latency histogram dicts — the
    ``_native.lathist_snapshot`` format or the lighthouse
    ``/status.json`` ``"latency"`` entries (``sum_s`` instead of
    ``sum_ns``). Exact by construction: every process records on the
    same fixed bucket grid, so the merge is elementwise integer
    addition — no re-binning, no precision loss (a ``sum_s`` input
    round-trips through its rendered seconds, still exact to the ns)."""
    out: Dict[str, Dict[str, Any]] = {}
    for op in set(a) | set(b):
        ha, hb = a.get(op), b.get(op)
        if ha is None or hb is None:
            src = ha or hb
            assert src is not None
            out[op] = {
                "counts": list(src["counts"]),
                "count": int(src["count"]),
                "sum_ns": _lathist_sum_ns(src),
            }
            continue
        if len(ha["counts"]) != len(hb["counts"]):
            raise ValueError(
                f"lathist merge: bucket count mismatch for {op} "
                f"({len(ha['counts'])} vs {len(hb['counts'])})"
            )
        out[op] = {
            "counts": [
                int(x) + int(y) for x, y in zip(ha["counts"], hb["counts"])
            ],
            "count": int(ha["count"]) + int(hb["count"]),
            "sum_ns": _lathist_sum_ns(ha) + _lathist_sum_ns(hb),
        }
    return out


def lathist_quantile(hist: Dict[str, Any], q: float) -> float:
    """Interpolated quantile of one native-latency histogram (the
    ``_native.lathist_snapshot`` / merged format) over the LOG2_BUCKETS
    grid; 0.0 when empty. Same estimate the C++ side serves in
    /status.json, so the two agree."""
    counts = [int(c) for c in hist["counts"]]
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    acc = 0.0
    lo = 0.0
    for i, b in enumerate(LOG2_BUCKETS):
        nxt = acc + counts[i]
        if nxt >= target and counts[i]:
            frac = min(1.0, max(0.0, (target - acc) / counts[i]))
            return lo + (b - lo) * frac
        acc = nxt
        lo = b
    return LOG2_BUCKETS[-1]


class StepLedger:
    """Thread-safe per-step phase accounting (see module docstring).

    Producers call :meth:`record` as phases complete; the Manager calls
    :meth:`tick` at each commit boundary, which assembles the interval's
    records into one step row, computes the ``idle`` residual and the
    local (peer-wait-excluded) time, and feeds the per-phase histograms.
    """

    def __init__(self, window: int = 128) -> None:
        self._lock = threading.Lock()
        self._last: Optional[float] = None
        self._interval: Dict[str, float] = {}
        # row phases recorded off the main thread: they overlap it, and
        # take at most the row's residual at the tick
        self._overlap: Dict[str, float] = {}
        self._totals: Dict[str, float] = {}        # row-eligible cumulative
        self._wire_totals: Dict[str, float] = {}   # record_wire_stage view
        self._wire_marks: Dict[str, float] = {}    # wire_stage_snapshot(reset)
        self._heal_stages: Dict[str, float] = {}   # record_heal_stage view
        self._rows: Deque[Dict[str, Any]] = deque(maxlen=window)
        self.steps = 0
        self._timer = None  # profiling.StepTimer for the outlier digest

    # -- producer side ---------------------------------------------------

    def record(
        self, phase: str, seconds: float, wire_total: bool = False
    ) -> None:
        """Accumulate ``seconds`` into ``phase``.

        ``wire_total=True`` marks a ``record_wire_stage`` call: it always
        feeds the cumulative wire-stage totals (the crossgroup bench's view,
        either thread) and the ``tft_wire_stage_seconds_total`` mirror,
        but joins the current STEP ROW only when made on the main thread
        — an op-thread pump overlaps the main thread's wall clock and
        would break the row's sum-to-wall invariant. Any other record
        made off the main thread overlaps it too: it joins the row at the
        tick, within the row's residual."""
        if seconds <= 0.0:
            return
        on_main = threading.current_thread() is threading.main_thread()
        row_eligible = not wire_total or on_main
        with self._lock:
            if wire_total:
                self._wire_totals[phase] = (
                    self._wire_totals.get(phase, 0.0) + seconds
                )
            if row_eligible and not on_main:
                self._overlap[phase] = self._overlap.get(phase, 0.0) + seconds
            elif row_eligible:
                self._interval[phase] = (
                    self._interval.get(phase, 0.0) + seconds
                )
                self._totals[phase] = self._totals.get(phase, 0.0) + seconds
        if wire_total:
            from torchft_tpu_torch import telemetry

            telemetry.WIRE_STAGE_SECONDS.labels(stage=phase).inc(seconds)

    def record_heal_stage(self, stage: str, seconds: float) -> None:
        """Accumulate a heal sub-stage (``meta``/``recv``/``decode``/
        ``device_put`` — docs/heal_plane.md) into the cumulative heal-stage
        view. Heals are rare, mostly ride the quorum thread, and span step
        boundaries, so these do NOT enter step rows (the row's ``heal``
        phase stays the main-thread apply) — they exist so
        a rejoin-to-commit regression is attributable to a stage instead
        of a single opaque ``heal_end`` duration."""
        if seconds <= 0.0:
            return
        with self._lock:
            self._heal_stages[stage] = (
                self._heal_stages.get(stage, 0.0) + seconds
            )
        try:
            from torchft_tpu_torch import telemetry

            telemetry.HEAL_STAGE_SECONDS.labels(stage=stage).inc(seconds)
        except Exception:  # noqa: BLE001 — observability never fails a heal
            pass

    def heal_stage_snapshot(self) -> Dict[str, float]:
        """Process-cumulative seconds per heal sub-stage."""
        with self._lock:
            return {k: v for k, v in self._heal_stages.items() if v > 0.0}

    def attach_timer(self, timer: Any) -> None:
        """Attach the Manager's :class:`~torchft_tpu_torch.profiling.StepTimer`
        so anatomy summaries/dumps carry its tagged-outlier digest (the
        quorum/heal outlier list)."""
        self._timer = timer

    def tick(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Step boundary: assemble the interval's records into one row.

        Returns the row (None on the first call — no previous boundary to
        measure from). The row's phases sum to the measured wall clock
        exactly: ``idle`` is the residual (clamped at 0 when explicitly
        recorded phases overlap the boundary, e.g. a quorum-thread heal
        racing the tick)."""
        now = time.perf_counter()
        with self._lock:
            interval = self._interval
            overlap = self._overlap
            self._interval = {}
            self._overlap = {}
            last = self._last
            self._last = now
            if last is None:
                return None
            self.steps += 1
        wall = now - last
        residual = max(0.0, wall - sum(interval.values()))
        # off-main-thread phases overlapped the main thread's: they fill
        # the residual (scaled down when they would pass it)
        extra = sum(overlap.values())
        scale = min(1.0, residual / extra) if extra > 0.0 else 0.0
        for phase, seconds in overlap.items():
            interval[phase] = interval.get(phase, 0.0) + seconds * scale
        interval["idle"] = max(0.0, residual - extra * scale)
        local = max(
            0.0,
            wall - sum(interval.get(p, 0.0) for p in BARRIER_PHASES),
        )
        row = {
            "step": step,
            "wall_s": wall,
            "local_s": local,
            "phases": {k: v for k, v in interval.items() if v > 0.0},
        }
        with self._lock:
            for phase, seconds in overlap.items():
                self._totals[phase] = self._totals.get(phase, 0.0) + seconds * scale
            self._totals["idle"] = self._totals.get("idle", 0.0) + interval["idle"]
            self._rows.append(row)
        try:
            from torchft_tpu_torch import telemetry

            # EVERY phase is observed EVERY step (zero when inactive):
            # a phase's p50 then reads "typical per-step cost" — and the
            # per-phase p50s compose to a typical step, which is what
            # lets the bench step_anatomy row reconcile its p50 sum
            # against the measured wall p50 (rare phases like heal keep
            # their cost visible in the p99)
            for phase in PHASES:
                telemetry.STEP_PHASE_SECONDS.labels(phase=phase).observe(
                    interval.get(phase, 0.0)
                )
            telemetry.STEP_WALL_SECONDS.observe(wall)
            telemetry.STEP_LOCAL_SECONDS.observe(local)
        except Exception:  # noqa: BLE001 — observability never fails a step
            pass
        return row

    # -- wire-stage view (the collectives.record_wire_stage shim) --------

    def wire_stage_snapshot(self, reset: bool = False) -> Dict[str, float]:
        """Process-cumulative seconds per wire-plane stage since the last
        ``reset=True`` mark. Resetting moves the mark; the ledger's own
        cumulative totals (and the telemetry counters) stay monotonic."""
        with self._lock:
            out = {
                k: v - self._wire_marks.get(k, 0.0)
                for k, v in self._wire_totals.items()
            }
            if reset:
                self._wire_marks = dict(self._wire_totals)
        return {k: v for k, v in out.items() if v > 0.0}

    # -- consumer side ---------------------------------------------------

    @staticmethod
    def _percentile(values: List[float], q: float) -> float:
        """Exact interpolated percentile of a value list (the summary's
        quantiles come from the retained step rows, not the log2-bucket
        histograms — one bucket per octave is fine for Prometheus but its
        ±50% quantile resolution would swamp the bench row's 5%
        phase-sum-vs-wall reconciliation)."""
        if not values:
            return 0.0
        vs = sorted(values)
        if len(vs) == 1:
            return vs[0]
        pos = q * (len(vs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vs) - 1)
        return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)

    def last_row(self) -> Optional[Dict[str, Any]]:
        """The most recent step row (step / wall_s / local_s / phases) or
        None — the per-step sample the time-series piggyback publishes
        (telemetry/timeseries.py): percentiles smooth exactly the level
        shifts the regression sentinel exists to catch, so the retained
        series carries raw per-step values."""
        with self._lock:
            if not self._rows:
                return None
            r = self._rows[-1]
            return {
                "step": r["step"],
                "wall_s": r["wall_s"],
                "local_s": r["local_s"],
                "phases": dict(r["phases"]),
            }

    def local_p50(self) -> Optional[float]:
        """Rolling p50 of the local (peer-wait-excluded) step time over
        the retained row window — the scalar piggybacked to the
        lighthouse for straggler detection."""
        with self._lock:
            vals = [r["local_s"] for r in self._rows]
        if not vals:
            return None
        return self._percentile(vals, 0.5)

    def outlier_digest(self) -> List[Dict[str, Any]]:
        """The attached StepTimer's tagged outliers (quorum/heal steps) as
        JSON-safe records; empty when no timer is attached."""
        if self._timer is None:
            return []
        try:
            return self._timer.outlier_digest()
        except Exception:  # noqa: BLE001
            return []

    def summary(self) -> Dict[str, Any]:
        """Compact per-phase digest for piggybacks and bench rows:
        per-phase p50/p99/cumulative seconds, wall/local p50s, step count
        and the tagged-outlier digest. Quantiles are EXACT percentiles
        over the retained row window (see :meth:`_percentile`); every
        phase contributes zero on steps it was inactive, so the per-phase
        p50s compose to a typical step."""
        with self._lock:
            rows = list(self._rows)
            totals = dict(self._totals)
            steps = self.steps
        last = rows[-1] if rows else None
        phases: Dict[str, Any] = {}
        for phase in PHASES:
            vals = [r["phases"].get(phase, 0.0) for r in rows]
            total = totals.get(phase, 0.0)
            if not any(vals) and total <= 0.0:
                continue
            phases[phase] = {
                "p50_s": round(self._percentile(vals, 0.5), 6),
                "p99_s": round(self._percentile(vals, 0.99), 6),
                "total_s": round(total, 4),
            }
        out: Dict[str, Any] = {
            "steps": steps,
            "phases": phases,
            "wall_p50_s": round(
                self._percentile([r["wall_s"] for r in rows], 0.5), 6
            ),
            "wall_p99_s": round(
                self._percentile([r["wall_s"] for r in rows], 0.99), 6
            ),
            "local_p50_s": round(
                self._percentile([r["local_s"] for r in rows], 0.5), 6
            ),
        }
        if last is not None:
            out["last"] = {
                "step": last["step"],
                "wall_s": round(last["wall_s"], 6),
                "phases": {
                    k: round(v, 6) for k, v in last["phases"].items()
                },
            }
        heal_stages = self.heal_stage_snapshot()
        if heal_stages:
            out["heal_stages"] = {
                k: round(v, 6) for k, v in heal_stages.items()
            }
        outliers = self.outlier_digest()
        if outliers:
            out["outliers"] = outliers[-8:]  # recent tail keeps it compact
        return out

    def dump(self) -> Dict[str, Any]:
        """Full ledger state for evidence dumps (flight recorder /
        SIGUSR2): every retained step row + the summary digest."""
        with self._lock:
            rows = [
                {
                    "step": r["step"],
                    "wall_s": round(r["wall_s"], 6),
                    "local_s": round(r["local_s"], 6),
                    "phases": {
                        k: round(v, 6) for k, v in r["phases"].items()
                    },
                }
                for r in self._rows
            ]
        return {"rows": rows, "summary": self.summary()}

    def reset(self) -> None:
        """Clear rows/intervals/totals/marks (tests). The registry
        histograms are zeroed separately by ``telemetry.reset()``."""
        with self._lock:
            self._last = None
            self._interval = {}
            self._overlap = {}
            self._totals = {}
            self._wire_totals = {}
            self._wire_marks = {}
            self._heal_stages = {}
            self._rows.clear()
            self.steps = 0


# Process-wide ledger: the data plane shims and the Manager all feed one
# instance (one Manager per process in production; in-process multi-
# manager tests interleave ticks, which is fine for telemetry).
LEDGER = StepLedger()
