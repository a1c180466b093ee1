"""Per-commit critical-path attribution: which replica's which phase
gated the fleet, and what fixing it would buy — the port's copy of
``torchft_tpu/telemetry/critical_path.py``.

In a synchronous fleet a committed step ends when its slowest group ends
its local work; the others wait in barrier phases
(``anatomy.BARRIER_PHASES``). For each committed step this takes the
fleet's per-replica rows (the wall, local and phase series of the
time-series piggyback, ``timeseries.py``), finds the gating replica (the
largest local time), charges it the step's excess (its local time less
the median of the others': the seconds the rest provably waited) and
splits the charge over its non-barrier phases by their own excess over
the fleet's median. The blame accumulates in
``tft_critical_path_seconds_total{replica,phase}`` and in
:meth:`CriticalPathAttributor.report`, served at ``GET
/critical_path.json`` on every checkpoint HTTP server, beside a what-if
estimate: the fleet's steps/s had every gating group run at the median.

Threshold-free and stateless per step: pure arithmetic over the step's
rows, beside the SLO, straggler and regression detectors.
"""

from __future__ import annotations

import threading
from statistics import median
from typing import Any, Dict, List, Optional, Tuple

from torchft_tpu_torch.telemetry.anatomy import BARRIER_PHASES

__all__ = [
    "CriticalPathAttributor",
    "CriticalPathMonitor",
    "attribute_step",
    "REPORTER",
    "set_reporter",
    "report_json",
]


def attribute_step(
    rows: Dict[str, Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Attribute ONE committed step. ``rows`` maps replica →
    ``{"wall_s", "local_s", "phases": {phase: seconds}}`` (the per-step
    values each replica published). Returns None when fewer than two
    replicas reported (nothing gates anything in a fleet of one);
    otherwise::

        {"gating": replica, "phase": phase, "blame_s": s,
         "phase_blame": {phase: s}, "wall_s": fleet wall,
         "whatif_wall_s": wall minus blame}

    ``blame_s`` is the gating replica's local time minus the OTHERS'
    median local time (leave-one-out, same reasoning as the straggler
    baseline: in a small fleet the straggler's own sample drags a plain
    median toward itself), clamped at 0 — the seconds the fleet would
    have saved had the gater run at the median."""
    live = {
        r: row
        for r, row in rows.items()
        if isinstance(row, dict) and row.get("local_s") is not None
    }
    if len(live) < 2:
        return None
    locals_ = {r: float(row["local_s"]) for r, row in live.items()}
    gating = max(locals_, key=locals_.get)
    others = [v for r, v in locals_.items() if r != gating]
    baseline = median(others)
    blame = max(0.0, locals_[gating] - baseline)
    # fleet wall: the step took as long as the slowest view of it
    wall = max(float(row.get("wall_s") or 0.0) for row in live.values())

    # split the blame across the gater's NON-barrier phases by their own
    # excess over the fleet median of that phase — barrier phases are
    # waiting-for-peers and can never be a cause, only a symptom
    g_phases: Dict[str, float] = {
        p: float(s)
        for p, s in (live[gating].get("phases") or {}).items()
        if p not in BARRIER_PHASES and s and s > 0
    }
    excess: Dict[str, float] = {}
    for p, s in g_phases.items():
        peer_vals = [
            float((live[r].get("phases") or {}).get(p, 0.0))
            for r in live
            if r != gating
        ]
        excess[p] = max(0.0, s - median(peer_vals)) if peer_vals else s
    total_excess = sum(excess.values())
    phase_blame: Dict[str, float] = {}
    if blame > 0:
        if total_excess > 0:
            for p, e in excess.items():
                if e > 0:
                    phase_blame[p] = blame * e / total_excess
        elif g_phases:
            # no phase stands out vs the fleet (e.g. uniformly slower
            # box): charge the gater's largest phase so the blame is
            # still actionable rather than dropped
            p = max(g_phases, key=g_phases.get)
            phase_blame[p] = blame
        else:
            phase_blame["idle"] = blame
    top_phase = (
        max(phase_blame, key=phase_blame.get) if phase_blame else None
    )
    return {
        "gating": gating,
        "phase": top_phase,
        "blame_s": blame,
        "phase_blame": phase_blame,
        "wall_s": wall,
        "whatif_wall_s": max(baseline, wall - blame),
    }


class CriticalPathAttributor:
    """Accumulates per-step attributions into the per-(replica, phase)
    blamed-seconds ledger and the what-if throughput estimate.
    Thread-safe (monitor thread writes, HTTP route reads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._blame: Dict[Tuple[str, str], float] = {}
        self._steps = 0
        self._sum_wall = 0.0
        self._sum_whatif = 0.0
        self._last: Optional[Dict[str, Any]] = None

    def observe_step(
        self, step: int, rows: Dict[str, Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        """Attribute one committed step's rows (see
        :func:`attribute_step`) and fold it into the ledger."""
        att = attribute_step(rows)
        if att is None:
            return None
        att["step"] = step
        with self._lock:
            self._steps += 1
            self._sum_wall += att["wall_s"]
            self._sum_whatif += att["whatif_wall_s"]
            for phase, s in att["phase_blame"].items():
                key = (att["gating"], phase)
                self._blame[key] = self._blame.get(key, 0.0) + s
            self._last = att
        if att["blame_s"] > 0:
            try:
                from torchft_tpu_torch import telemetry

                for phase, s in att["phase_blame"].items():
                    telemetry.CRITICAL_PATH_SECONDS.labels(
                        replica=att["gating"], phase=phase
                    ).inc(s)
                whatif = self.report().get("whatif_steps_per_sec")
                if whatif:
                    telemetry.CRITICAL_PATH_WHATIF.set(whatif)
            except Exception:  # noqa: BLE001 — never fail the monitor
                pass
        return att

    def report(self) -> Dict[str, Any]:
        """The ``/critical_path.json`` document: blamed seconds per
        (replica, phase) with share-of-total fractions, measured vs
        what-if steps/s, and the most recent step's attribution."""
        with self._lock:
            blame = dict(self._blame)
            steps, sum_wall, sum_whatif = (
                self._steps, self._sum_wall, self._sum_whatif,
            )
            last = dict(self._last) if self._last else None
        total_blame = sum(blame.values())
        rows: List[Dict[str, Any]] = [
            {
                "replica": r,
                "phase": p,
                "blamed_s": round(s, 6),
                "share": round(s / total_blame, 4) if total_blame else 0.0,
            }
            for (r, p), s in sorted(
                blame.items(), key=lambda kv: -kv[1]
            )
        ]
        out: Dict[str, Any] = {
            "steps": steps,
            "blamed_total_s": round(total_blame, 6),
            "blame": rows,
            "measured_steps_per_sec": (
                round(steps / sum_wall, 4) if sum_wall > 0 else None
            ),
            "whatif_steps_per_sec": (
                round(steps / sum_whatif, 4) if sum_whatif > 0 else None
            ),
        }
        if last:
            out["last"] = {
                "step": last.get("step"),
                "gating": last["gating"],
                "phase": last["phase"],
                "blame_s": round(last["blame_s"], 6),
            }
        return out

    def blame_by_replica(self) -> Dict[str, float]:
        """Total blamed seconds per replica."""
        with self._lock:
            out: Dict[str, float] = {}
            for (r, _p), s in self._blame.items():
                out[r] = out.get(r, 0.0) + s
            return out

    def reset(self) -> None:
        with self._lock:
            self._blame = {}
            self._steps = 0
            self._sum_wall = 0.0
            self._sum_whatif = 0.0
            self._last = None


# Process-global attributor serving GET /critical_path.json on the
# checkpoint HTTP server; a monitor installs itself here via set_reporter
# (None until one runs — the route then serves an empty report).
REPORTER: Optional[CriticalPathAttributor] = None
_REPORTER_LOCK = threading.Lock()


def set_reporter(attributor: Optional[CriticalPathAttributor]) -> None:
    global REPORTER
    with _REPORTER_LOCK:
        REPORTER = attributor


def report_json() -> str:
    """The /critical_path.json body (stable shape even with no monitor).

    The ``status`` field tells the empty shapes apart:
    ``"no-monitor"`` = no CriticalPathMonitor ever installed itself here
    (the route is served but nothing feeds it — check
    ``TORCHFT_REGRESSION_MONITOR``), ``"empty"`` = a monitor is wired
    but no step has been attributed yet, ``"ok"`` = live data."""
    import json

    with _REPORTER_LOCK:
        rep = REPORTER
    if rep is None:
        return json.dumps(
            {"status": "no-monitor", "steps": 0, "blamed_total_s": 0.0,
             "blame": [], "measured_steps_per_sec": None,
             "whatif_steps_per_sec": None, "monitor": False}
        )
    out = rep.report()
    out["monitor"] = True
    out["status"] = "ok" if out.get("steps") else "empty"
    return json.dumps(out, separators=(",", ":"))


class CriticalPathMonitor:
    """Fleet-side consumer: polls the lighthouse's ``/timeseries.json``,
    reassembles per-step cross-replica rows from the ``wall_s`` /
    ``local_s`` / ``phase.*`` series, and feeds completed steps to a
    :class:`CriticalPathAttributor`. A step is *complete* once the
    fleet's max published step has moved ``slack`` steps past it (late
    reporters in a synchronous fleet are at most a step behind; a
    replica absent from a completed step — dead, healing — is simply
    absent from that step's rows). Run one per fleet, like the
    FleetMonitor (a rank-0 Manager hosts one under
    ``TORCHFT_REGRESSION_MONITOR=1`` next to the regression sentinel —
    one history plane, one knob)."""

    def __init__(
        self,
        lighthouse_addr: str,
        attributor: Optional[CriticalPathAttributor] = None,
        slack: int = 2,
        pending_cap: int = 1024,
    ) -> None:
        self.addr = lighthouse_addr
        self.attributor = attributor or CriticalPathAttributor()
        self.slack = slack
        self.pending_cap = pending_cap
        self._cursor: Dict[Tuple[str, str], int] = {}
        # step -> replica -> partial row
        self._pending: Dict[int, Dict[str, Dict[str, Any]]] = {}
        set_reporter(self.attributor)

    def _fold(self, rid: str, name: str, step: int, value: float) -> None:
        row = self._pending.setdefault(step, {}).setdefault(
            rid, {"phases": {}}
        )
        if name == "wall_s":
            row["wall_s"] = value
        elif name == "local_s":
            row["local_s"] = value
        elif name.startswith("phase."):
            row["phases"][name[len("phase."):]] = value

    def poll_once(
        self, reply: Optional[Dict[str, Any]] = None
    ) -> List[Dict[str, Any]]:
        """One poll + attribution round; returns the step attributions
        finalized this round (also the testable core). Pass ``reply`` to
        reuse a fetch another consumer already paid for (see
        RegressionMonitor.poll_once)."""
        from torchft_tpu_torch.telemetry.timeseries import (
            iter_new_samples,
            poll_timeseries,
        )

        if reply is None:
            reply = poll_timeseries(self.addr)
        if not reply:
            return []
        max_step = -1
        for rid, name, _epoch, step, value in iter_new_samples(
            reply, self._cursor
        ):
            if name == "wall_s" or name == "local_s" or name.startswith(
                "phase."
            ):
                self._fold(rid, name, step, value)
            max_step = max(max_step, step)
        out: List[Dict[str, Any]] = []
        for step in sorted(self._pending):
            if max_step >= 0 and step <= max_step - self.slack:
                att = self.attributor.observe_step(
                    step, self._pending.pop(step)
                )
                if att is not None:
                    out.append(att)
            elif len(self._pending) > self.pending_cap:
                self._pending.pop(step)
            else:
                break
        return out

    def drain(self) -> List[Dict[str, Any]]:
        """Finalize every pending step regardless of slack (end of a
        run: the fleet stopped publishing, nothing more is coming)."""
        out = []
        for step in sorted(self._pending):
            att = self.attributor.observe_step(
                step, self._pending.pop(step)
            )
            if att is not None:
                out.append(att)
        return out
