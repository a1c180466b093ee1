"""Collective flight recorder + step watchdog — hang forensics; the port's
copy of ``torchft_tpu/telemetry/flight.py``. Every issue and completion
is mirrored into the crash-durable black box (``op_issue`` /
``op_complete``) when it is armed.
The watchdog holds its ``on_stall`` bound method weakly, so its thread never
keeps a dropped Manager (and the CUDA graphs it reaches) alive, and exits
once the owner is gone.

A silent multihost hang is the worst FT failure mode: every process is
alive, nothing errors, and the only observable fact is "step N never
committed". PyTorch distributed grew the NCCL flight recorder for exactly
this; here the analogue is a fixed-size ring of the last N cross-group
collective ops (op, plane, bytes, issue/complete wall timestamps,
status), recorded by both data-plane backends. When something wedges, the
per-rank dumps answer the two questions that localize a hang: *what was
the last op this rank completed* and *what is the first op it is stuck
in* — diffing those across ranks names the rank (and usually the op) that
stalled the ring.

Dumps are triggered three ways:

* **SIGUSR2** — operator-initiated (``kill -USR2 <pid>`` on a wedged
  worker); handler installed by the Manager (main thread only);
* **deadline expiry** — the futures timeout manager dumps when it fails
  a future (rate-limited);
* **step watchdog** — :class:`StepWatchdog` fires when the step a
  Manager armed exceeds ``TORCHFT_WATCHDOG_MULT`` × the steady-step p99
  (floor ``TORCHFT_WATCHDOG_MIN_S``), i.e. the step is an extreme outlier
  against this process's own recorded history.

Dump files are JSON at ``TORCHFT_FLIGHT_DIR`` (default: the system temp
dir), named ``tft_flight_<pid>_<seq>.json``. Stdlib-only; recording an op
is one lock + a few dict stores.
"""

from __future__ import annotations

import inspect
import json
import os
import signal
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "FLIGHT",
    "StepWatchdog",
    "install_sigusr2",
    "ENV_FLIGHT_DIR",
    "ENV_FLIGHT_SIZE",
]

ENV_FLIGHT_DIR = "TORCHFT_FLIGHT_DIR"
ENV_FLIGHT_SIZE = "TORCHFT_FLIGHT_SIZE"
ENV_WATCHDOG_MULT = "TORCHFT_WATCHDOG_MULT"
ENV_WATCHDOG_MIN_S = "TORCHFT_WATCHDOG_MIN_S"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class FlightRecorder:
    """Fixed-size ring of collective-op records.

    ``record_issue`` returns a sequence id; ``record_complete(seq)`` marks
    it completed/failed if it is still in the ring (wraparound of a long
    ring while an op is in flight simply loses the record — acceptable,
    the recorder is forensic, not accounting)."""

    def __init__(self, size: Optional[int] = None) -> None:
        if size is None:
            try:
                size = max(16, int(os.environ.get(ENV_FLIGHT_SIZE, "256")))
            except ValueError:
                size = 256
        self._size = size
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * size
        self._seq = 0
        self._dump_seq = 0
        self._last_dump: Dict[str, float] = {}  # reason -> monotonic ts
        self.min_dump_interval_s = 5.0

    # -- producer side ---------------------------------------------------

    def record_issue(
        self,
        op: str,
        plane: str,
        nbytes: int = 0,
        tag: int = 0,
        rank: int = -1,
    ) -> int:
        rec = {
            "seq": 0,
            "op": op,
            "plane": plane,
            "bytes": int(nbytes),
            "tag": tag,
            "rank": rank,
            "issue_ts": time.time(),
            "complete_ts": None,
            "status": "issued",
        }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring[self._seq % self._size] = rec
            seq = self._seq
        # crash-durable mirror: the in-memory ring dies with the process,
        # so the black box records every issue and completion — a
        # SIGKILLed worker's last in-flight op is recoverable from disk
        from torchft_tpu_torch.telemetry.blackbox import BLACKBOX

        BLACKBOX.record(
            "op_issue", op=op, plane=plane, fseq=seq,
            bytes=int(nbytes), tag=tag, rank=rank,
        )
        return seq

    def record_complete(self, seq: int, error: Optional[BaseException] = None) -> None:
        with self._lock:
            rec = self._ring[seq % self._size]
            if rec is None or rec["seq"] != seq:
                return  # overwritten by wraparound
            rec["complete_ts"] = time.time()
            rec["status"] = "completed" if error is None else "failed"
            if error is not None:
                rec["error"] = repr(error)
        from torchft_tpu_torch.telemetry.blackbox import BLACKBOX

        BLACKBOX.record(
            "op_complete", fseq=seq,
            status="completed" if error is None else "failed",
            **({"error": repr(error)} if error is not None else {}),
        )

    # -- consumer side ---------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Records oldest→newest (deep-enough copies for JSON dumping)."""
        with self._lock:
            recs = [dict(r) for r in self._ring if r is not None]
        recs.sort(key=lambda r: r["seq"])
        return recs

    @staticmethod
    def analyze(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
        """The hang-localization digest: the newest completed op and the
        oldest still-issued one."""
        last_completed = None
        first_stuck = None
        for r in entries:
            if r["status"] == "completed":
                last_completed = r
            elif r["status"] == "issued" and first_stuck is None:
                first_stuck = r
        return {"last_completed": last_completed, "first_stuck": first_stuck}

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self._size

    # -- dumping ---------------------------------------------------------

    def dump_dir(self) -> str:
        return os.environ.get(ENV_FLIGHT_DIR) or tempfile.gettempdir()

    def dump(self, reason: str, force: bool = False) -> Optional[str]:
        """Write the ring to disk; returns the path (None when rate-limited
        or the write failed). ``force`` skips the per-reason rate limit
        (the SIGUSR2 path — an explicit operator ask always dumps)."""
        now = time.monotonic()
        with self._lock:
            if not force:
                last = self._last_dump.get(reason, 0.0)
                if now - last < self.min_dump_interval_s:
                    return None
            self._last_dump[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
        entries = self.snapshot()
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "host": _hostname(),
            "entries": entries,
            **self.analyze(entries),
        }
        # the step-anatomy ledger rides every dump (one handler, one
        # evidence dir: the SIGUSR2 / watchdog / deadline dump answers
        # "where did the wedged step's time go" next to "which op is
        # stuck"), tagged-outlier digest included
        try:
            from torchft_tpu_torch.telemetry.anatomy import LEDGER

            payload["anatomy"] = LEDGER.dump()
        except Exception:  # noqa: BLE001 — never fail the dump path
            pass
        # every live Python thread's stack rides along too: where each
        # thread is parked is the first question a wedge postmortem asks
        try:
            payload["py_stacks"] = _thread_stacks()
        except Exception:  # noqa: BLE001
            pass
        path = os.path.join(
            self.dump_dir(), f"tft_flight_{os.getpid()}_{seq}.json"
        )
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
        except OSError:
            return None
        try:
            from torchft_tpu_torch import telemetry

            telemetry.FLIGHT_DUMPS.labels(reason=reason).inc()
            telemetry.emit("flight_dump", reason=reason, path=path)
        except Exception:  # noqa: BLE001 — never fail the trigger path
            pass
        return path


def _hostname() -> str:
    import socket

    try:
        return socket.gethostname()
    except OSError:
        return "?"


def _thread_stacks() -> List[Dict[str, Any]]:
    """Every live Python thread's current stack (root-first
    ``file:line:function`` frames), named via threading.enumerate — the
    wedge-localization snapshot the SIGUSR2 / deadline / watchdog dumps
    carry."""
    import sys
    import traceback

    names = {
        t.ident: t.name for t in threading.enumerate() if t.ident is not None
    }
    out: List[Dict[str, Any]] = []
    for tid, frame in sys._current_frames().items():
        frames = [
            f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno}:{fs.name}"
            for fs in traceback.extract_stack(frame)
        ]
        out.append(
            {
                "thread": names.get(tid, f"tid{tid}"),
                "tid": tid,
                "frames": frames,  # root-first
            }
        )
    return out


FLIGHT = FlightRecorder()

_SIGUSR2_INSTALLED = False
_SIGUSR2_LOCK = threading.Lock()


def install_sigusr2() -> bool:
    """Install the SIGUSR2 → flight dump handler (idempotent; main thread
    only — returns False when installation was impossible, e.g. called
    from a worker thread or a non-Unix platform)."""
    global _SIGUSR2_INSTALLED
    with _SIGUSR2_LOCK:
        if _SIGUSR2_INSTALLED:
            return True
        try:
            prev = signal.getsignal(signal.SIGUSR2)

            def _handler(signum, frame):  # noqa: ARG001
                # dump on a thread: json/file IO is not async-signal-safe
                # enough to run inline in an arbitrary interrupted frame
                threading.Thread(
                    target=FLIGHT.dump,
                    args=("signal",),
                    kwargs={"force": True},
                    daemon=True,
                    name="tft_flight_dump",
                ).start()
                if callable(prev) and prev not in (
                    signal.SIG_IGN,
                    signal.SIG_DFL,
                ):
                    prev(signum, frame)

            signal.signal(signal.SIGUSR2, _handler)
        except (ValueError, OSError, AttributeError):
            return False
        _SIGUSR2_INSTALLED = True
        return True


def _waker(cond: threading.Condition) -> Callable[[Any], None]:
    """A weakref callback that wakes ``cond``'s waiter (the monitor thread
    checks its owner under ``cond`` before every wait, so the wake-up is
    never lost)."""

    def wake(_ref: Any) -> None:
        with cond:
            cond.notify_all()

    return wake


class StepWatchdog:
    """Per-Manager stall detector driven by the step-duration histogram.

    ``arm(step)`` at each ``start_quorum``; ``disarm()`` at the commit
    boundary. A monitor thread compares the armed step's elapsed wall time
    against ``mult × p99(steady step duration)`` (floor ``min_s``); past
    the threshold it fires ``on_stall`` once for that step, dumps the
    flight recorder, and latches :attr:`stalled` until the next disarm —
    the Manager piggybacks that flag to the lighthouse so the cluster
    dashboard shows a stuck-collective marker for the replica.

    Knobs (env): ``TORCHFT_WATCHDOG_MULT`` (default 10; <=0 disables) and
    ``TORCHFT_WATCHDOG_MIN_S`` (default 60)."""

    WARMUP_SAMPLES = 8

    def __init__(
        self,
        mult: Optional[float] = None,
        min_s: Optional[float] = None,
        on_stall: Optional[Callable[[int, float, float], None]] = None,
        recorder: Optional[FlightRecorder] = None,
    ) -> None:
        self.mult = mult if mult is not None else _env_float(ENV_WATCHDOG_MULT, 10.0)
        self.min_s = min_s if min_s is not None else _env_float(ENV_WATCHDOG_MIN_S, 60.0)
        self._recorder = recorder or FLIGHT
        # reentrant: the owner's weakref callback takes it, and may run
        # inside a garbage collection on the monitor thread itself
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # a bound method is held weakly: the monitor thread must never keep
        # its owner alive, and it exits once the owner is gone (the
        # weakref's callback wakes it)
        self._owned = inspect.ismethod(on_stall)
        self._on_stall: Callable[[], Optional[Callable[[int, float, float], None]]] = (
            weakref.WeakMethod(on_stall, _waker(self._cond)) if self._owned
            else (lambda: on_stall)
        )
        self._armed_step: Optional[int] = None
        self._armed_at = 0.0
        self._fired_step: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._running = True
        self.stalled = False  # guarded-by: _cond
        self.stalls = 0

    @property
    def enabled(self) -> bool:
        return self.mult > 0

    def threshold_s(self) -> float:
        """Current stall threshold; the histogram p99 only engages after
        WARMUP_SAMPLES steady steps so cold starts never false-positive."""
        p99 = None
        try:
            from torchft_tpu_torch import telemetry

            steady = telemetry.STEP_DURATION.labels(kind="steady")
            if steady.count >= self.WARMUP_SAMPLES:
                p99 = steady.quantile(0.99)
        except Exception:  # noqa: BLE001
            p99 = None
        if not p99:
            return self.min_s
        return max(self.min_s, self.mult * p99)

    def arm(self, step: int) -> None:
        if not self.enabled:
            return
        with self._cond:
            self._armed_step = step
            self._armed_at = time.monotonic()
            if self._fired_step != step:
                self.stalled = False
            if self._thread is None and self._running:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="tft_step_watchdog"
                )
                self._thread.start()
            self._cond.notify()

    def disarm(self) -> None:
        with self._cond:
            self._armed_step = None
            self.stalled = False

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify()

    def _done(self) -> bool:
        # under _cond: stopped, or the owner of a bound on_stall is gone
        return not self._running or (self._owned and self._on_stall() is None)

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._done():
                    return
                if self._armed_step is None:
                    self._cond.wait(timeout=1.0)
                    continue
                step = self._armed_step
                elapsed = time.monotonic() - self._armed_at
            thr = self.threshold_s()
            if elapsed >= thr and step is not None:
                fire = False
                with self._cond:
                    if self._armed_step == step and self._fired_step != step:
                        self._fired_step = step
                        self.stalled = True
                        self.stalls += 1
                        fire = True
                if fire:
                    self._fire(step, elapsed, thr)
                wait_s = max(1.0, thr / 4)
            else:
                wait_s = min(max(0.05, thr - elapsed), max(1.0, thr / 4))
            with self._cond:
                if not self._done():
                    self._cond.wait(timeout=wait_s)

    def _fire(self, step: int, elapsed: float, thr: float) -> None:
        try:
            from torchft_tpu_torch import telemetry

            telemetry.WATCHDOG_STALLS.inc()
            telemetry.emit(
                "watchdog_stall",
                step=step,
                elapsed_s=round(elapsed, 3),
                threshold_s=round(thr, 3),
            )
        except Exception:  # noqa: BLE001
            pass
        try:
            self._recorder.dump("watchdog")
        except Exception:  # noqa: BLE001
            pass
        on_stall = self._on_stall()
        if on_stall is not None:
            try:
                on_stall(step, elapsed, thr)
            except Exception:  # noqa: BLE001
                pass
