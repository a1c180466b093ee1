"""Structured FT event trail — the flight recorder for fault-tolerance
lifecycle events; the port's copy of ``torchft_tpu/telemetry/events.py``
without the black-box mirror (the forensics slice).

Every quorum formation, heal, peer death, eviction and commit/abort is an
append-only JSONL record, so a recovery incident can be reconstructed from
disk (event ordering + wall-clock deltas) instead of re-run under a
profiler. The trail is process-wide: configure a sink once (or export
``TORCHFT_EVENT_TRAIL=/path/trail.jsonl`` before the process starts) and
every instrumented layer — Manager, collectives, checkpoint transports —
appends to it. An in-memory ring buffer always records the most recent
events regardless of sink, so tests and ``telemetry.dump()`` can read the
trail without touching the filesystem.

Record schema (one JSON object per line)::

    {"ts": <unix seconds, float>, "event": "<kind>", ...fields}

Canonical kinds and their fields are documented in
``docs/observability.md`` (quorum_start, quorum_ready, heal_begin,
heal_end, peer_death, eviction, commit, abort, checkpoint_send,
checkpoint_recv, step_outlier).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "EventTrail",
    "read_trail",
    "CANONICAL_EVENTS",
    "LIFECYCLE_EVENTS",
]

ENV_TRAIL_PATH = "TORCHFT_EVENT_TRAIL"
ENV_TRAIL_MAX_BYTES = "TORCHFT_EVENT_TRAIL_MAX_BYTES"

# Soak runs must not grow the trail unboundedly: past this many bytes the
# sink rolls to `<path>.1` (one generation kept) and starts fresh. 0
# disables rotation.
DEFAULT_TRAIL_MAX_BYTES = 64 << 20

# The documented event vocabulary (docs/observability.md "FT event trail"
# table). The drift-check test asserts doc <-> code agreement in both
# directions, so adding a kind here without documenting it (or vice versa)
# fails CI.
CANONICAL_EVENTS = (
    "quorum_start",
    "quorum_ready",
    "heal_begin",
    "heal_end",
    "heal_failed",
    "peer_death",
    "eviction",
    "commit",
    "abort",
    "commit_rollback",
    "checkpoint_send",
    "checkpoint_recv",
    "step_outlier",
    "watchdog_stall",
    "flight_dump",
    "fault_injected",
    "slo_breach",
    "slo_recovered",
    "straggler_detected",
    "straggler_cleared",
    "divergence_detected",
    "blackbox_recovered",
    "perf_regression",
    "perf_regression_cleared",
    "diagnosis_captured",
)

# The protocol-lifecycle subset of the vocabulary: the events the
# executable FT-protocol spec (the JAX package's analysis/protocol/) models and
# the trace-conformance checker replays. One constant, shared by the
# emitting side (this trail) and the verifying side (the spec), so the
# two can never silently disagree about which records ARE the protocol.
LIFECYCLE_EVENTS = (
    "quorum_start",
    "quorum_ready",
    "heal_begin",
    "heal_end",
    "heal_failed",
    "commit",
    "abort",
    "commit_rollback",
    "divergence_detected",
)


class EventTrail:
    """Thread-safe JSONL event sink with an in-memory ring buffer."""

    def __init__(
        self,
        path: Optional[str] = None,
        maxlen: int = 4096,
        max_bytes: Optional[int] = None,
    ) -> None:
        self._lock = threading.Lock()
        # live subscribers (the diagnosis trigger engine): called OUTSIDE
        # the trail lock, exceptions swallowed — a consumer can never
        # deadlock or fail the emitting step. guarded-by: _lock
        self._subscribers: List[Any] = []
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self._file: Optional[io.TextIOBase] = None
        self._path: Optional[str] = None
        self._env_checked = False
        self._written = 0
        if max_bytes is None:
            try:
                max_bytes = int(
                    os.environ.get(
                        ENV_TRAIL_MAX_BYTES, str(DEFAULT_TRAIL_MAX_BYTES)
                    )
                )
            except ValueError:
                max_bytes = DEFAULT_TRAIL_MAX_BYTES
        self.max_bytes = max_bytes
        if path:
            self.configure(path)

    # -- sink management --

    def configure(self, path: Optional[str]) -> None:
        """Point the trail at ``path`` (append mode), or detach with None.
        Replaces any previous sink."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._path = path
            self._env_checked = True  # explicit config wins over env
            if path:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._file = open(path, "a", encoding="utf-8")
                self._written = self._existing_size(path)

    def path(self) -> Optional[str]:
        with self._lock:
            return self._path

    def _maybe_open_from_env(self) -> None:
        # called under self._lock
        if self._env_checked:
            return
        self._env_checked = True
        path = os.environ.get(ENV_TRAIL_PATH)
        if not path:
            return
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(path, "a", encoding="utf-8")
            self._path = path
            self._written = self._existing_size(path)
        except OSError:
            # observability must never take down training
            self._file = None
            self._path = None

    @staticmethod
    def _existing_size(path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    def _maybe_rotate(self) -> None:
        # called under self._lock, after a successful write+flush. One
        # rolled generation (`<path>.1`) bounds total disk at ~2x max_bytes
        # while keeping enough history to reconstruct a recent incident.
        if (
            self.max_bytes <= 0
            or self._file is None
            or self._path is None
            or self._written < self.max_bytes
        ):
            return
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        try:
            os.replace(self._path, self._path + ".1")
        except OSError:
            pass  # rotation is best-effort; keep appending either way
        try:
            self._file = open(self._path, "a", encoding="utf-8")
            self._written = self._existing_size(self._path)
        except OSError:
            self._file = None

    # -- producer side --

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        """Append one record; returns it (with the stamped ``ts``)."""
        record = {"ts": time.time(), "event": event, **fields}
        line: Optional[str] = None
        with self._lock:
            self._maybe_open_from_env()
            self._ring.append(record)
            if self._file is not None:
                try:
                    line = json.dumps(record, default=str)
                    self._file.write(line + "\n")
                    self._file.flush()
                    self._written += len(line) + 1
                    self._maybe_rotate()
                except (OSError, ValueError):
                    pass  # a full disk must not fail a step
        # metric alongside the trail so dashboards can rate() FT events
        # without parsing JSONL (late import avoids a module cycle)
        from torchft_tpu_torch.telemetry import FT_EVENTS_TOTAL

        FT_EVENTS_TOTAL.labels(event=event).inc()
        # live fan-out: a consumer (the diagnosis engine) turns latch
        # events into deep captures the moment they fire, instead of
        # polling the ring. Outside the lock; failures swallowed. The
        # unlocked emptiness check keeps the common no-subscriber
        # deployment from paying a second lock acquire per event — safe
        # because the list is only mutated under _lock (GIL-atomic ref
        # read) and a stale-empty read just delays one delivery.
        if self._subscribers:
            with self._lock:
                subscribers = list(self._subscribers)
            for cb in subscribers:
                try:
                    cb(record)
                except Exception:  # noqa: BLE001 — a consumer must never
                    pass           # fail the emitting step
        return record

    def subscribe(self, callback: Any) -> None:
        """Register a live consumer: ``callback(record)`` runs on the
        emitting thread after every :meth:`emit` (outside the trail
        lock). Keep callbacks fast — heavy work belongs on the
        consumer's own thread."""
        with self._lock:
            if callback not in self._subscribers:
                self._subscribers.append(callback)

    def unsubscribe(self, callback: Any) -> None:
        with self._lock:
            if callback in self._subscribers:
                self._subscribers.remove(callback)

    # -- consumer side --

    def recent(
        self, event: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Most recent records from the ring buffer, oldest first;
        optionally filtered to one event kind."""
        with self._lock:
            records = list(self._ring)
        if event is not None:
            records = [r for r in records if r.get("event") == event]
        if limit is not None:
            records = records[-limit:]
        return records

    def clear(self) -> None:
        """Empty the ring buffer (the file sink, if any, is untouched)."""
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def read_trail(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trail file back into records (skipping torn tails —
    a SIGKILLed process may leave a partial last line)."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    except FileNotFoundError:
        pass
    return records
