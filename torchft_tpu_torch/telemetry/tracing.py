"""Distributed spans for the FT runtime — the cross-replica timeline; the
port's copy of ``torchft_tpu/telemetry/tracing.py``.

The metrics and the event trail answer "how many, how long"; spans answer
"what overlapped what, across which replicas". Every quorum RPC, heal
send/recv, checkpoint transfer and commit barrier is a span carrying a
``trace_id`` of the form ``replica_id:step:quorum_epoch`` — because the
step counter and quorum epoch are *globally agreed* values, spans emitted
by different replicas for the same step/epoch correlate with no clock
sync beyond wall-clock timestamps. Context propagates between replicas
through RPC metadata (:meth:`Tracer.inject` / carrier dicts), so e.g. a
checkpoint GET served for a healing peer records the healer's span as
its parent.

Spans export two ways:

* JSONL (one span per line, ``TORCHFT_TRACE_PATH`` env or
  :meth:`Tracer.configure`) — grep/jq-friendly, merge-friendly;
* Chrome trace-event JSON (:meth:`Tracer.chrome_events` /
  :func:`chrome_trace`) — open in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``; the lighthouse's ``GET /trace`` serves the whole
  cluster merged on one timeline (replicas piggyback recent span batches
  on their quorum traffic — see ``docs/observability.md``).

Design constraints match the rest of the package: stdlib-only, no jax
import, exception-free on the hot path (a tracing bug must never fail a
step), and cheap when idle (span entry/exit is a couple of dict ops).
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "TRACER",
    "chrome_trace",
    "ENV_TRACE_PATH",
]

ENV_TRACE_PATH = "TORCHFT_TRACE_PATH"
ENV_TRACE_RING = "TORCHFT_TRACE_RING"


def _ring_size() -> int:
    try:
        return max(16, int(os.environ.get(ENV_TRACE_RING, "4096")))
    except ValueError:
        return 4096


def _stable_pid(replica_id: str) -> int:
    """Deterministic Chrome-trace pid for a replica: the merged cluster
    trace groups each replica's spans into its own process lane even
    though the events were recorded on different hosts."""
    if not replica_id:
        return os.getpid()
    return zlib.crc32(replica_id.encode()) & 0x7FFFFFFF


class Span:
    """One recorded operation: name, trace identity, parent link, wall
    timestamps. Created via :meth:`Tracer.span`; attributes set inside the
    ``with`` block land in ``attrs``."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "replica_id",
        "ts",
        "dur_s",
        "tid",
        "attrs",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        replica_id: str,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.replica_id = replica_id
        self.ts = time.time()
        self.dur_s = 0.0
        self.tid = threading.get_ident() & 0x7FFFFFFF
        self.attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "ts": self.ts,
            "dur_s": round(self.dur_s, 6),
            "replica_id": self.replica_id,
            "tid": self.tid,
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event ("X" complete event, microsecond clock)."""
        return _chrome_event(self.to_dict())


def _chrome_event(d: Dict[str, Any]) -> Dict[str, Any]:
    """One span dict -> one Chrome trace "X" event — the single place the
    event shape is defined (Span.to_chrome, chrome_events and the
    piggyback fragments all go through here)."""
    args = dict(d.get("attrs", {}))
    args["trace_id"] = d.get("trace_id", "")
    args["span_id"] = d.get("span_id", "")
    if d.get("parent_id"):
        args["parent_id"] = d["parent_id"]
    return {
        "name": d.get("name", "?"),
        "cat": "tft",
        "ph": "X",
        "ts": float(d.get("ts", 0.0)) * 1e6,
        "dur": max(float(d.get("dur_s", 0.0)), 0.0) * 1e6,
        "pid": _stable_pid(d.get("replica_id", "")),
        "tid": int(d.get("tid", 0)),
        "args": args,
    }


def _chrome_process_name(replica_id: str) -> Dict[str, Any]:
    """Metadata event naming a replica's process lane."""
    return {
        "name": "process_name",
        "ph": "M",
        "pid": _stable_pid(replica_id),
        "tid": 0,
        "args": {"name": replica_id},
    }


class _SpanCtx:
    """Context manager produced by :meth:`Tracer.span`."""

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self.span = span
        self._t0 = time.perf_counter()

    def __enter__(self) -> Span:
        self._tracer._push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.dur_s = time.perf_counter() - self._t0
        if exc is not None:
            self.span.attrs.setdefault("error", repr(exc))
        self._tracer._pop(self.span)
        self._tracer._record(self.span)
        return None  # never swallow exceptions


class Tracer:
    """Process-wide span recorder with carrier-based context propagation.

    The process context (``replica_id``, ``step``, ``quorum_epoch``) is set
    by the Manager at each step boundary; spans created without an explicit
    ``trace_id`` inherit it. Thread-local span stacks give implicit
    parent/child nesting; cross-process links use :meth:`inject` (producer)
    and the ``parent=`` carrier argument (consumer)."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        n = maxlen or _ring_size()
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=n)
        # spans not yet shipped to the lighthouse (piggyback batches)
        self._pending: Deque[Span] = deque(maxlen=n)
        self._last_batch: List[Span] = []
        self._tls = threading.local()
        self._seq = 0
        self._file = None
        self._path: Optional[str] = None
        self._env_checked = False
        self._ctx: Dict[str, Any] = {
            "replica_id": "",
            "step": -1,
            "quorum_epoch": -1,
        }

    # -- context ---------------------------------------------------------

    def set_context(
        self,
        replica_id: Optional[str] = None,
        step: Optional[int] = None,
        quorum_epoch: Optional[int] = None,
    ) -> None:
        """Update the process trace context (Manager calls this at quorum
        start and whenever the epoch changes)."""
        with self._lock:
            if replica_id is not None:
                self._ctx["replica_id"] = replica_id
            if step is not None:
                self._ctx["step"] = int(step)
            if quorum_epoch is not None:
                self._ctx["quorum_epoch"] = int(quorum_epoch)

    def context(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._ctx)

    def current_trace_id(self) -> str:
        with self._lock:
            c = self._ctx
            return f"{c['replica_id']}:{c['step']}:{c['quorum_epoch']}"

    def _next_span_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{os.getpid():x}-{self._seq:x}"

    # -- producing spans -------------------------------------------------

    def span(
        self,
        name: str,
        parent: Optional[Dict[str, Any]] = None,
        trace_id: Optional[str] = None,
        replica_id: Optional[str] = None,
        **attrs: Any,
    ) -> _SpanCtx:
        """Open a span. ``parent`` is a carrier dict (from :meth:`inject`,
        possibly received over an RPC) that both links the parent span and
        adopts its trace_id; otherwise the innermost open span on this
        thread is the parent and the process context names the trace."""
        parent_id: Optional[str] = None
        if parent:
            parent_id = parent.get("span_id") or None
            if trace_id is None:
                trace_id = parent.get("trace_id") or None
        if parent_id is None:
            cur = self._current()
            if cur is not None:
                parent_id = cur.span_id
                if trace_id is None:
                    trace_id = cur.trace_id
        if trace_id is None:
            trace_id = self.current_trace_id()
        if replica_id is None:
            replica_id = trace_id.split(":", 1)[0] or self.context()["replica_id"]
        s = Span(name, trace_id, self._next_span_id(), parent_id, replica_id)
        if attrs:
            s.attrs.update(attrs)
        return _SpanCtx(self, s)

    def inject(self) -> Dict[str, str]:
        """Carrier for RPC metadata: the current span (or bare context) as
        ``{"trace_id", "span_id"}`` — attach it to an outgoing request and
        pass it as ``parent=`` on the serving side."""
        cur = self._current()
        if cur is not None:
            return {"trace_id": cur.trace_id, "span_id": cur.span_id}
        return {"trace_id": self.current_trace_id(), "span_id": ""}

    @staticmethod
    def parse_carrier(raw: str) -> Optional[Dict[str, str]]:
        """Parse the ``trace_id|span_id`` header form used by the HTTP
        transports back into a carrier dict."""
        if not raw:
            return None
        trace_id, _, span_id = raw.partition("|")
        return {"trace_id": trace_id, "span_id": span_id}

    @staticmethod
    def format_carrier(carrier: Dict[str, str]) -> str:
        return f"{carrier.get('trace_id', '')}|{carrier.get('span_id', '')}"

    # -- thread-local stack ----------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:  # tolerate mismatched exits
            st.remove(span)

    # -- recording -------------------------------------------------------

    def configure(self, path: Optional[str]) -> None:
        """Point the JSONL sink at ``path`` (append), or detach with None."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._path = path
            self._env_checked = True
            if path:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._file = open(path, "a", encoding="utf-8")

    def _maybe_open_from_env(self) -> None:
        # called under self._lock
        if self._env_checked:
            return
        self._env_checked = True
        path = os.environ.get(ENV_TRACE_PATH)
        if not path:
            return
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(path, "a", encoding="utf-8")
            self._path = path
        except OSError:
            self._file = None
            self._path = None

    def _record(self, span: Span) -> None:
        try:
            d = span.to_dict()
            with self._lock:
                self._maybe_open_from_env()
                self._ring.append(d)
                self._pending.append(span)
                if self._file is not None:
                    try:
                        self._file.write(json.dumps(d, default=str) + "\n")
                        self._file.flush()
                    except (OSError, ValueError):
                        pass
            from torchft_tpu_torch import telemetry

            telemetry.TRACE_SPANS.labels(span=span.name).inc()
        except Exception:  # noqa: BLE001 — tracing must never fail a step
            pass

    # -- consuming -------------------------------------------------------

    def recent(
        self, name: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Most recent span dicts, oldest first, optionally by name."""
        with self._lock:
            spans = list(self._ring)
        if name is not None:
            spans = [s for s in spans if s.get("name") == name]
        if limit is not None:
            spans = spans[-limit:]
        return spans

    def drain_chrome_fragment(
        self, max_events: int = 64, max_bytes: int = 32768
    ) -> str:
        """Pop up-to-``max_events`` not-yet-shipped spans as a comma-joined
        Chrome trace-event fragment (no enclosing brackets) — the compact
        batch replicas piggyback on their quorum traffic. Includes a
        ``process_name`` metadata event per distinct replica so the merged
        timeline labels its lanes; duplicates across batches are harmless."""
        spans: List[Span] = []
        with self._lock:
            while self._pending and len(spans) < max_events:
                spans.append(self._pending.popleft())
        if not spans:
            return ""
        parts: List[str] = []
        named: set = set()
        total = 0
        consumed = 0
        for s in spans:
            try:
                frag = json.dumps(s.to_chrome(), separators=(",", ":"), default=str)
            except (TypeError, ValueError):
                consumed += 1
                continue  # unserializable span: drop it, keep draining
            if total + len(frag) > max_bytes and parts:
                break  # over budget: later spans stay pending (below)
            if s.replica_id and s.replica_id not in named:
                named.add(s.replica_id)
                parts.append(
                    json.dumps(
                        _chrome_process_name(s.replica_id),
                        separators=(",", ":"),
                    )
                )
            total += len(frag)
            parts.append(frag)
            consumed += 1
        if consumed < len(spans):
            # push the unshipped tail back (in order) for the next batch —
            # busy incident windows must not lose their spans to the cap
            with self._lock:
                for s in reversed(spans[consumed:]):
                    self._pending.appendleft(s)
        self._last_batch = spans[:consumed]
        return ",".join(parts)

    def requeue_last_batch(self) -> None:
        """Re-queue the spans returned by the most recent
        :meth:`drain_chrome_fragment` (callers that failed to ship a
        piggyback batch use this so an outage window keeps its spans; a
        rare double-requeue only duplicates events, which the merged
        trace tolerates)."""
        with self._lock:
            batch = getattr(self, "_last_batch", None)
            self._last_batch = []
            if batch:
                for s in reversed(batch):
                    self._pending.appendleft(s)

    def chrome_events(
        self, spans: Optional[List[Dict[str, Any]]] = None
    ) -> List[Dict[str, Any]]:
        """Chrome trace events for ``spans`` (default: the recent ring),
        with a ``process_name`` metadata event per replica."""
        if spans is None:
            spans = self.recent()
        out: List[Dict[str, Any]] = []
        named: set = set()
        for d in spans:
            rid = d.get("replica_id", "")
            if rid and rid not in named:
                named.add(rid)
                out.append(_chrome_process_name(rid))
            out.append(_chrome_event(d))
        return out

    def clear(self) -> None:
        """Empty the ring and pending batches (tests)."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


TRACER = Tracer()


def chrome_trace(path: str, spans: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write the recent spans (or ``spans``) as a Chrome trace-event JSON
    file loadable in Perfetto; returns the path."""
    events = TRACER.chrome_events(spans)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"displayTimeUnit": "ms", "traceEvents": events}, f)
    return path


def read_spans(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL span file back into dicts (skips torn tails)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except FileNotFoundError:
        pass
    return out
