"""Latch-triggered deep-capture engine — the port's copy of
``torchft_tpu/telemetry/diagnosis.py``, the bridge from detection to
diagnosis.

The fleet detects well: straggler latches, burn-rate SLOs, the step
watchdog, the divergence sentinel and the perf-regression sentinel all
fire precise, debounced events. But each bottoms out at phase
granularity ("group 2 lost 150 ms a step in its local time"), and nothing
says which code. The profilers are always on at low Hz
(:mod:`torchft_tpu_torch.telemetry.profiler`, ``native/profiler.h``), and
a latch event triggers a **bounded deep capture** instead of a human
attaching a profiler after the fact.

One :class:`DiagnosisEngine` per process (the Manager hosts it whenever
``TORCHFT_DIAG_DIR`` is set). It subscribes to the live event trail and,
on any of the five latch events —

    ``straggler_detected``, ``perf_regression``, ``slo_breach``,
    ``watchdog_stall``, ``divergence_detected``

— debounced **once per episode** (re-armed by the matching ``*_cleared``
event, or after :data:`DEFAULT_REARM_S` for latches that never clear),
writes a **diagnosis bundle** under ``TORCHFT_DIAG_DIR``:

``bundle.json``
    the trigger record, the (epoch, step, seq) coordinates, the capture
    window, the native latency histograms' p50/p99 over the window, the
    flight recorder's hang-localization digest, and (when a lighthouse is
    known) the time-series window around the onset;
``native.folded`` / ``python.folded``
    collapsed stacks sampled during the window with both samplers boosted
    to ``TORCHFT_PROF_BURST_HZ`` (exact snapshot diffs), flamegraph-ready;
``flight.json``
    the whole flight-recorder ring at capture time;
``torch_trace/``
    a bounded ``torch.profiler`` trace of the compute phase, CPU and CUDA
    activities (``TORCHFT_DIAG_TORCH=1`` only; the JAX package's
    ``jax_trace/`` under ``TORCHFT_DIAG_JAX``). A step runs its compute
    once, so the trace spans at least :data:`TRACE_STEPS` of the ledger's
    steady steps when the window is shorter (the JAX trace spans the
    window alone).

Events that name a different replica (a fleet monitor here latching some
other group) are ignored: the victim captures its own evidence, the only
process whose stacks answer the question. Each capture emits
``diagnosis_captured`` and counts in ``tft_diagnosis_bundles_total``, and
the Manager announces it on the quorum piggyback (``diag_bundles`` /
``diag_last`` / ``diag_dir``), so the lighthouse's ``GET /diagnosis.json``
indexes the fleet's evidence.

Knobs: ``TORCHFT_DIAG_DIR`` and ``TORCHFT_DIAG_WINDOW_S`` (the capture
window, default :data:`DEFAULT_WINDOW_S`); the re-arm period is the
module constant :data:`DEFAULT_REARM_S` (or the ``rearm_s`` argument).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "TRIGGER_EVENTS",
    "DiagnosisEngine",
    "diag_dir",
    "read_bundles",
]

# trigger → the event that ends its episode (None = never clears on its
# own; the engine re-arms after DEFAULT_REARM_S instead)
TRIGGER_EVENTS: Dict[str, Optional[str]] = {
    "straggler_detected": "straggler_cleared",
    "perf_regression": "perf_regression_cleared",
    "slo_breach": "slo_recovered",
    "watchdog_stall": None,
    "divergence_detected": None,
}

_CLEAR_TO_TRIGGER = {
    clear: trig for trig, clear in TRIGGER_EVENTS.items() if clear
}

DEFAULT_WINDOW_S = 3.0
DEFAULT_REARM_S = 600.0
# the torch trace spans at least this many of the ledger's steady steps
# (a step runs its compute phase once), and at most TRACE_MAX_S
TRACE_STEPS = 1.5
TRACE_MAX_S = 30.0

# One capture in flight per PROCESS, not per engine: the burst boost
# mutates the shared global samplers (PROFILER / the native plane), so
# two engines racing a subject-less latch (divergence_detected triggers
# every installed engine) would each save the OTHER's burst rate as its
# "pre-burst" value — leaving the fleet sampling at burst Hz forever —
# and write duplicate bundles for one incident. Non-blocking: a loser
# stays latched (debounced) and the in-flight bundle carries the
# window's evidence.
_CAPTURE_MU = threading.Lock()


def _step_wall_p50() -> float:
    """This process's steady step wall (the ledger's p50; 0 before a row)."""
    try:
        from torchft_tpu_torch.telemetry import LEDGER

        return float(LEDGER.summary().get("wall_p50_s") or 0.0)
    except Exception:  # noqa: BLE001 — no ledger read: the window alone
        return 0.0


def diag_dir() -> Optional[str]:
    """The bundle directory; None disarms the whole plane (the default
    deployment pays nothing)."""
    return os.environ.get("TORCHFT_DIAG_DIR") or None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _subject(record: Dict[str, Any]) -> Optional[str]:
    """The replica/group a latch event names (None = process-local
    event like watchdog_stall / slo_breach / divergence_detected)."""
    s = record.get("group") or record.get("replica")
    return str(s) if s else None


def _episode_key(kind: str, record: Dict[str, Any]) -> tuple:
    """The debounce key: one episode per (trigger, subject, stream).
    The stream discriminator keeps DISTINCT latches independent — the
    two SLOs (step_time / rejoin_commit) share one event kind, and a
    perf_regression on wall_s is a different episode than one on
    phase.compute; without it, a rejoin breach would be swallowed by a
    live step_time episode and its recovery would re-arm the wrong
    latch."""
    return (
        kind,
        _subject(record),
        record.get("slo") or record.get("series"),
    )


def _lathist_delta_quantiles(
    after: Dict[str, Any], before: Dict[str, Any]
) -> Dict[str, Any]:
    """Per-op p50/p99 of ONLY the window's observations: both snapshots
    are cumulative on the shared log2 grid, so the window's histogram is
    an exact per-bucket subtraction."""
    from torchft_tpu_torch.telemetry.anatomy import lathist_quantile

    out: Dict[str, Any] = {}
    for op, h1 in (after or {}).items():
        h0 = (before or {}).get(op) or {}
        c1 = list(h1.get("counts") or [])
        c0 = list(h0.get("counts") or [0] * len(c1))
        if len(c0) != len(c1):
            continue
        window = [max(0, a - b) for a, b in zip(c1, c0)]
        count = sum(window)
        entry: Dict[str, Any] = {
            "count_window": int(count),
            "p50_s_total": round(lathist_quantile(h1, 0.5), 6),
            "p99_s_total": round(lathist_quantile(h1, 0.99), 6),
        }
        if count:
            wh = {"counts": window, "count": count}
            entry["p50_s_window"] = round(lathist_quantile(wh, 0.5), 6)
            entry["p99_s_window"] = round(lathist_quantile(wh, 0.99), 6)
        out[op] = entry
    return out


class DiagnosisEngine:
    """See the module docstring. ``synchronous=True`` runs captures
    inline on the emitting thread (tests); production captures run on a
    daemon thread so a latch never blocks the step path."""

    def __init__(
        self,
        directory: Optional[str] = None,
        replica_id: str = "",
        lighthouse_addr: Optional[str] = None,
        window_s: Optional[float] = None,
        burst_hz: Optional[float] = None,
        rearm_s: Optional[float] = None,
        synchronous: bool = False,
        clock=time.monotonic,
    ) -> None:
        from torchft_tpu_torch.telemetry.profiler import burst_hz as _burst

        self.directory = directory or diag_dir()
        self.replica_id = replica_id
        self.lighthouse_addr = lighthouse_addr
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float("TORCHFT_DIAG_WINDOW_S", DEFAULT_WINDOW_S)
        )
        self.burst_hz = burst_hz if burst_hz is not None else _burst()
        self.rearm_s = rearm_s if rearm_s is not None else DEFAULT_REARM_S
        self.synchronous = synchronous
        self._clock = clock
        self._lock = threading.Lock()
        # (trigger, subject) → latch monotonic ts. guarded-by: _lock
        self._episodes: Dict[Any, float] = {}
        self._seq = 0  # guarded-by: _lock
        self.bundles: List[str] = []  # bundle names, oldest first
        self.last_bundle: Optional[str] = None
        self._installed = False

    # -- wiring ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def install(self) -> "DiagnosisEngine":
        """Subscribe to the live event trail (idempotent)."""
        if not self._installed and self.enabled:
            from torchft_tpu_torch.telemetry import EVENTS

            EVENTS.subscribe(self.on_event)
            self._installed = True
        return self

    def remove(self) -> None:
        if self._installed:
            from torchft_tpu_torch.telemetry import EVENTS

            EVENTS.unsubscribe(self.on_event)
            self._installed = False

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def wait_idle(self, timeout: float) -> bool:
        """Wait up to ``timeout`` s for a capture in flight in this process
        to finish writing its bundle (a worker about to exit calls it);
        returns whether none was in flight by then."""
        if not _CAPTURE_MU.acquire(timeout=timeout):
            return False
        _CAPTURE_MU.release()
        return True

    # -- trigger path (runs on the emitting thread: keep it cheap) ------

    def on_event(self, record: Dict[str, Any]) -> None:
        kind = record.get("event")
        if kind in _CLEAR_TO_TRIGGER:
            # the episode is over: re-arm this trigger for its subject
            # (+ stream — the *_cleared events carry the same slo/series
            # fields their latches do)
            key = _episode_key(_CLEAR_TO_TRIGGER[kind], record)
            with self._lock:
                self._episodes.pop(key, None)
            return
        if kind not in TRIGGER_EVENTS or not self.enabled:
            return
        subject = _subject(record)
        if subject is not None and self.replica_id:
            # a fleet monitor here may latch SOME OTHER group — only the
            # named victim captures (its stacks are the evidence). Match
            # prefix both ways: detector subjects come from /cluster.json
            # ids, which carry the same example-chosen prefix.
            if not (
                subject.startswith(self.replica_id)
                or self.replica_id.startswith(subject)
            ):
                return
        now = self._clock()
        key = _episode_key(kind, record)
        with self._lock:
            latched_at = self._episodes.get(key)
            if latched_at is not None:
                rearm = (
                    TRIGGER_EVENTS[kind] is None
                    and now - latched_at >= self.rearm_s
                )
                if not rearm:
                    return  # once per episode
            self._episodes[key] = now
        if not _CAPTURE_MU.acquire(blocking=False):
            # a capture is already running (this engine or another in
            # the process) for another latch; this episode stays latched
            # (debounced) and the in-flight bundle carries the fleet's
            # evidence for the window
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
        if self.synchronous:
            self._capture(dict(record), seq)
        else:
            try:
                threading.Thread(
                    target=self._capture,
                    args=(dict(record), seq),
                    daemon=True,
                    name="tft_diagnosis_capture",
                ).start()
            except Exception:  # noqa: BLE001 — thread exhaustion is
                # exactly the distressed-fleet state diagnosis targets:
                # a failed start must release the in-flight guard, or
                # every future latch is silently ignored forever
                _CAPTURE_MU.release()

    # -- capture ---------------------------------------------------------

    def _capture(self, trigger: Dict[str, Any], seq: int) -> None:
        try:
            self._capture_inner(trigger, seq)
        except Exception:  # noqa: BLE001 — diagnosis must never crash
            pass           # the process it is diagnosing
        finally:
            _CAPTURE_MU.release()

    def _capture_inner(self, trigger: Dict[str, Any], seq: int) -> None:
        from torchft_tpu_torch.telemetry import BLACKBOX, FLIGHT
        from torchft_tpu_torch.telemetry import profiler as prof

        t_wall = time.time()
        coords = BLACKBOX.context()
        # pid in the name: a process-local event (e.g. divergence) can
        # capture on EVERY replica sharing one fleet TORCHFT_DIAG_DIR in
        # the same wall-clock second — same-named dirs would silently
        # merge (makedirs exist_ok) and overwrite each other's evidence
        name = "diag_{:.0f}_{}_{}_{}".format(
            t_wall, trigger.get("event", "manual"), os.getpid(), seq
        )
        bundle_dir = os.path.join(self.directory, name)
        os.makedirs(bundle_dir, exist_ok=True)

        lat_before = self._lathist()
        native_before = prof.native_folded()
        py_before = prof.PROFILER.folded()

        # boost both samplers for the window, restore after — to their
        # PRE-burst rates, not the env default: a rate someone set live
        # (including a deliberate disarm) must survive a capture
        restore_py = prof.PROFILER.hz
        restore_native = prof.native_hz()
        prof.PROFILER.set_hz(self.burst_hz)
        native_armed = prof.native_set_hz(self.burst_hz)
        trace_dir = os.path.join(bundle_dir, "torch_trace")
        session = None
        try:
            session = prof.start_torch_trace(trace_dir)
            t_trace = time.monotonic()
            time.sleep(self.window_s)
        finally:
            prof.PROFILER.set_hz(restore_py)
            if native_armed:
                prof.native_set_hz(
                    restore_native
                    if restore_native is not None
                    else prof.env_hz()
                )

        native_folded = prof.subtract_folded(
            prof.native_folded(), native_before
        )
        py_folded = prof.subtract_folded(prof.PROFILER.folded(), py_before)
        lat_after = self._lathist()
        prof.poll_native_samples()
        if session is not None:
            # the trace is of the compute phase, which a step runs once:
            # it spans TRACE_STEPS of the ledger's steady steps when the
            # window is shorter, so it holds one whatever the window's
            # phase (the samplers' window stays window_s)
            rest = min(TRACE_MAX_S, TRACE_STEPS * _step_wall_p50()) - (
                time.monotonic() - t_trace
            )
            if rest > 0:
                time.sleep(rest)
            prof.stop_torch_trace(session, trace_dir)

        flight_entries = FLIGHT.snapshot()
        tsdb_window = None
        if self.lighthouse_addr:
            from torchft_tpu_torch.telemetry.timeseries import poll_timeseries

            tsdb_window = poll_timeseries(
                self.lighthouse_addr, max_points=256
            )

        self._write(bundle_dir, "native.folded", native_folded)
        self._write(bundle_dir, "python.folded", py_folded)
        self._write(
            bundle_dir,
            "flight.json",
            json.dumps(
                {"entries": flight_entries, **FLIGHT.analyze(flight_entries)},
                default=str,
            ),
        )
        meta = {
            "schema": 1,
            "bundle": name,
            "ts": round(t_wall, 3),
            "replica_id": self.replica_id or coords.get("replica_id"),
            # the same clock-sync-free coordinates every other forensic
            # surface orders by — postmortem --bundles merges on these
            "epoch": coords.get("epoch"),
            "step": trigger.get("step", coords.get("step")),
            "seq": coords.get("seq"),
            "trigger": trigger,
            "window_s": self.window_s,
            "burst_hz": self.burst_hz,
            "native_armed": native_armed,
            "torch_trace": session is not None,
            "lathist": _lathist_delta_quantiles(lat_after, lat_before),
            "files": {
                "native_folded": "native.folded",
                "python_folded": "python.folded",
                "flight": "flight.json",
                "torch_trace": "torch_trace" if session is not None else None,
            },
        }
        if tsdb_window is not None:
            self._write(
                bundle_dir, "tsdb.json", json.dumps(tsdb_window, default=str)
            )
            meta["files"]["tsdb"] = "tsdb.json"
        self._write(bundle_dir, "bundle.json", json.dumps(meta, default=str))

        self.bundles.append(name)
        self.last_bundle = name
        try:
            from torchft_tpu_torch import telemetry

            telemetry.DIAGNOSIS_BUNDLES.labels(
                trigger=trigger.get("event", "manual")
            ).inc()
            telemetry.emit(
                "diagnosis_captured",
                trigger=trigger.get("event"),
                bundle=name,
                path=bundle_dir,
                step=meta["step"],
                epoch=meta["epoch"],
                window_s=self.window_s,
            )
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _lathist() -> Dict[str, Any]:
        try:
            from torchft_tpu_torch import _native

            return _native.lathist_snapshot()
        except Exception:  # noqa: BLE001 — native plane optional
            return {}

    @staticmethod
    def _write(bundle_dir: str, fname: str, text: str) -> None:
        try:
            with open(
                os.path.join(bundle_dir, fname), "w", encoding="utf-8"
            ) as f:
                f.write(text)
        except OSError:
            pass  # a full disk must not fail the capture thread


def load_bundle_meta(bundle_dir: str) -> Optional[Dict[str, Any]]:
    """Load ONE bundle directory's ``bundle.json`` (stamped with
    ``_dir``); None for torn/malformed/absent bundles. The single
    reader behind :func:`read_bundles` and the postmortem ``--bundles``
    collector — one place to evolve when the schema does."""
    path = os.path.join(bundle_dir, "bundle.json")
    if not os.path.isfile(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    meta["_dir"] = bundle_dir
    return meta


def read_bundles(directory: str) -> List[Dict[str, Any]]:
    """Load every bundle's ``bundle.json`` under ``directory`` (the
    one-level layout the engine writes), ordered by capture time. Torn
    or malformed bundles are skipped; ``chip_smoke.py``'s diagnosis
    checks read through this."""
    out: List[Dict[str, Any]] = []
    if not directory or not os.path.isdir(directory):
        return out
    for entry in sorted(os.listdir(directory)):
        meta = load_bundle_meta(os.path.join(directory, entry))
        if meta is not None:
            out.append(meta)
    out.sort(key=lambda m: m.get("ts", 0.0))
    return out
