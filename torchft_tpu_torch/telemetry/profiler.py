"""Always-on Python stack sampler and collapsed-stack utilities — the
port's copy of ``torchft_tpu/telemetry/profiler.py``.

The Python half of the diagnosis plane's profiler pair (the native core's
SIGPROF sampler, ``native/profiler.h``, samples the GIL-free planes; this
module samples the interpreter threads): a daemon thread wakes at
``TORCHFT_PROF_HZ`` (default :data:`DEFAULT_HZ`, ``0`` disarms) and folds
every live thread's ``sys._current_frames`` stack into a collapsed-stack
aggregate, the same flamegraph-ready ``label;root;...;leaf count`` text
the native side emits, so one toolchain reads both.

Sampling a Python stack costs microseconds at single-digit Hz, cheap
enough to leave on for the life of the trainer: when a latch fires, the
history is already in the aggregate, and the diagnosis engine
(:mod:`torchft_tpu_torch.telemetry.diagnosis`) only boosts the rate
(``TORCHFT_PROF_BURST_HZ``) for a bounded window.

Also here:

* :func:`merge_folded` / :func:`subtract_folded`, exact aggregation
  across processes and snapshots (counts are integers on identical keys,
  so a merge is elementwise addition and a capture window is a snapshot
  diff);
* :func:`capture_torch_trace` (and its halves :func:`start_torch_trace` /
  :func:`stop_torch_trace`), the bounded ``torch.profiler`` window (CPU
  and CUDA activities) over the compute phase, the counterpart of the JAX
  package's ``capture_jax_trace``, gated by ``TORCHFT_DIAG_TORCH=1``
  (the JAX package's ``TORCHFT_DIAG_JAX``): traces are large. It starts
  and stops the profiler only while no CUDA-graph capture runs in the
  process (:func:`torchft_tpu_torch.parallel.train_step.capture_quiesced`);
* :func:`poll_native_samples`, :func:`native_set_hz`, :func:`native_hz`
  and :func:`native_folded`, the native sampler through ``_native``
  (``tft_prof_*``); the native count folds into
  ``tft_prof_samples_total{plane="native"}`` on poll.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "DEFAULT_HZ",
    "DEFAULT_BURST_HZ",
    "PROFILER",
    "PyStackSampler",
    "env_hz",
    "burst_hz",
    "merge_folded",
    "subtract_folded",
    "parse_folded",
    "render_folded",
    "capture_torch_trace",
    "start_torch_trace",
    "stop_torch_trace",
    "torch_capture_enabled",
    "native_set_hz",
    "native_hz",
    "native_folded",
    "poll_native_samples",
]

# prime-ish default, matching native/profiler.h kDefaultHz: avoids
# lockstep with 10 ms schedulers and 100 Hz tick sources
DEFAULT_HZ = 11.0
DEFAULT_BURST_HZ = 97.0


def env_hz() -> float:
    """The configured always-on rate (``TORCHFT_PROF_HZ``; unset →
    :data:`DEFAULT_HZ`, ``0`` → disarmed)."""
    raw = os.environ.get("TORCHFT_PROF_HZ")
    if raw is None or raw == "":
        return DEFAULT_HZ
    try:
        return float(raw)
    except ValueError:
        return DEFAULT_HZ


def burst_hz() -> float:
    """The capture-window boost rate (``TORCHFT_PROF_BURST_HZ``)."""
    raw = os.environ.get("TORCHFT_PROF_BURST_HZ")
    try:
        return float(raw) if raw else DEFAULT_BURST_HZ
    except ValueError:
        return DEFAULT_BURST_HZ


class PyStackSampler:
    """Low-Hz ``sys._current_frames`` sampler with collapsed-stack
    aggregation.

    One instance per process (:data:`PROFILER`); the Manager calls
    :meth:`ensure_started` at init so every trainer is always-on by
    default. ``set_hz(0)`` pauses (the thread idles), ``set_hz(h)``
    resumes — the diagnosis engine's burst boost."""

    MAX_DEPTH = 48

    def __init__(self, hz: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._agg: Counter = Counter()  # guarded-by: _lock
        self._hz = hz if hz is not None else env_hz()
        self._samples = 0  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # -- control ---------------------------------------------------------

    @property
    def hz(self) -> float:
        return self._hz

    def set_hz(self, hz: float) -> None:
        self._hz = float(hz)
        self._wake.set()  # re-evaluate the sleep immediately
        if self._hz > 0:
            self.ensure_started()

    def ensure_started(self) -> "PyStackSampler":
        """Idempotent; a disarmed sampler (hz=0) starts no thread at all
        — zero cost until someone boosts it."""
        if self._hz <= 0 or self._thread is not None:
            return self
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="tft_py_profiler"
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling --------------------------------------------------------

    def _thread_labels(self) -> Dict[int, str]:
        return {
            t.ident: t.name or f"tid{t.ident}"
            for t in threading.enumerate()
            if t.ident is not None
        }

    def sample_once(self) -> int:
        """One sampling pass over every live thread (also the testable
        core); returns the number of stacks recorded."""
        labels = self._thread_labels()
        me = threading.get_ident()
        n = 0
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # never sample the sampler
            stack: List[str] = []
            f: Any = frame
            depth = 0
            while f is not None and depth < self.MAX_DEPTH:
                code = f.f_code
                stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{code.co_name}")
                f = f.f_back
                depth += 1
            if not stack:
                continue
            stack.reverse()  # root-first, like the native renderer
            label = labels.get(tid, f"tid{tid}")
            key = label.replace(";", ":") + ";" + ";".join(
                s.replace(";", ":") for s in stack
            )
            with self._lock:
                self._agg[key] += 1
                self._samples += 1
            n += 1
        if n:
            try:
                from torchft_tpu_torch import telemetry

                telemetry.PROF_SAMPLES.labels(plane="py").inc(n)
            except Exception:  # noqa: BLE001 — never fail the sampler
                pass
        return n

    def _run(self) -> None:
        while not self._stop.is_set():
            hz = self._hz
            if hz <= 0:
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — sampling must never die
                pass
            self._wake.wait(timeout=max(0.001, 1.0 / hz))
            self._wake.clear()

    # -- consumers -------------------------------------------------------

    def samples_total(self) -> int:
        with self._lock:
            return self._samples

    def folded(self) -> str:
        """Collapsed stacks, sorted (same shape as
        ``_native.prof_snapshot``)."""
        with self._lock:
            items = sorted(self._agg.items())
        return "".join(f"{k} {v}\n" for k, v in items)

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._samples = 0


PROFILER = PyStackSampler()


# ---------------------------------------------------------------------------
# collapsed-stack (folded) text utilities
# ---------------------------------------------------------------------------


def parse_folded(text: str) -> Dict[str, int]:
    """``"stack count"`` lines → ``{stack: count}`` (malformed lines are
    skipped — a torn capture file must not fail the merge)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, cnt = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(cnt)
        except ValueError:
            continue
    return out


def render_folded(agg: Dict[str, int]) -> str:
    return "".join(
        f"{k} {v}\n" for k, v in sorted(agg.items()) if v > 0
    )


def merge_folded(*texts: str) -> str:
    """EXACT cross-process merge: counts are integers on identical stack
    keys, so merging N replicas' captures is elementwise addition — the
    same property the lathist grid gives histograms (and the test
    asserts: ``counts(merge) == counts(a) + counts(b)`` per key)."""
    total: Dict[str, int] = {}
    for t in texts:
        for k, v in parse_folded(t).items():
            total[k] = total.get(k, 0) + v
    return render_folded(total)


def subtract_folded(after: str, before: str) -> str:
    """The bounded-window diff: both samplers aggregate cumulatively, so
    ``snapshot(t1) − snapshot(t0)`` is exactly the samples recorded in
    the window (clamped at 0 per key to tolerate a reset in between)."""
    a = parse_folded(after)
    for k, v in parse_folded(before).items():
        a[k] = a.get(k, 0) - v
    return render_folded(a)


# ---------------------------------------------------------------------------
# torch profiler capture window
# ---------------------------------------------------------------------------

ENV_DIAG_TORCH = "TORCHFT_DIAG_TORCH"
TRACE_FILE = "trace.json"


def torch_capture_enabled() -> bool:
    return os.environ.get(ENV_DIAG_TORCH, "0") == "1"


def start_torch_trace(log_dir: str) -> Optional[Any]:
    """Start a ``torch.profiler`` session for a bounded window: CPU
    activities always, CUDA activities when this process has initialized
    CUDA (CUPTI records every kernel on the card, the ones replayed CUDA
    graphs launch among them, whichever thread started the session).
    Returns the session, or None when ``TORCHFT_DIAG_TORCH`` is off or the
    profiler did not start (a failed trace never fails the capture that
    asked for it).

    A profiler that starts or stops while a stream captures a CUDA graph
    breaks the capture, so the start here and the stop in
    :func:`stop_torch_trace` run under the train step's capture lock
    (:func:`~torchft_tpu_torch.parallel.train_step.capture_quiesced`):
    each waits for a capture in progress, and a capture waits for each."""
    if not torch_capture_enabled():
        return None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from torchft_tpu_torch.parallel.train_step import capture_quiesced

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        session = profile(activities=activities)
        with capture_quiesced():
            session.start()
        return session
    except Exception:  # noqa: BLE001 — no trace; the window is not consumed
        return None


def stop_torch_trace(session: Any, log_dir: str) -> None:
    """Stop a session from :func:`start_torch_trace` (under the capture
    lock) and write its Chrome trace, ``log_dir/trace.json``. A failed stop
    or export leaves a torn or missing trace, never an error."""
    try:
        from torchft_tpu_torch.parallel.train_step import capture_quiesced

        with capture_quiesced():
            session.stop()
        session.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    except Exception:  # noqa: BLE001 — the window was slept: it is consumed
        pass


def capture_torch_trace(log_dir: str, duration_s: float) -> Optional[str]:
    """The bounded window in one call, the counterpart of the JAX
    ``capture_jax_trace``: start, sleep ``duration_s``, stop. Returns the
    trace dir, or None when the trace did not start (the window was then
    NOT slept: the caller sleeps it). Once the session started, the window
    is consumed exactly once and the dir is returned even if the stop or
    the export fails."""
    session = start_torch_trace(log_dir)
    if session is None:
        return None
    try:
        time.sleep(duration_s)
    finally:
        stop_torch_trace(session, log_dir)
    return log_dir


# ---------------------------------------------------------------------------
# native-side plumbing (best-effort: the native plane is optional)
# ---------------------------------------------------------------------------

_native_base = 0
_native_lock = threading.Lock()


def poll_native_samples() -> int:
    """Fold the native sampler's cumulative count into
    ``tft_prof_samples_total{plane="native"}`` (counters can only
    increase, so this tracks the delta since the last poll and re-bases
    after a native reset). Returns the cumulative native count."""
    global _native_base
    try:
        from torchft_tpu_torch import _native

        total = _native.prof_samples_total()
    except Exception:  # noqa: BLE001
        return 0
    with _native_lock:
        delta = total - _native_base
        if delta < 0:  # native side was reset
            delta = total
        _native_base = total
    if delta > 0:
        try:
            from torchft_tpu_torch import telemetry

            telemetry.PROF_SAMPLES.labels(plane="native").inc(delta)
        except Exception:  # noqa: BLE001
            pass
    return total


def native_set_hz(hz: float) -> bool:
    """Retarget the native sampler (burst boost / restore); False when
    the native plane is unavailable."""
    try:
        from torchft_tpu_torch import _native

        _native.prof_set_hz(hz)
        return True
    except Exception:  # noqa: BLE001
        return False


def native_hz() -> Optional[float]:
    """The native sampler's current effective rate (None when the
    native plane is unavailable) — saved before a burst boost so the
    restore honors a rate someone set live, not just the env default."""
    try:
        from torchft_tpu_torch import _native

        return float(_native.prof_hz())
    except Exception:  # noqa: BLE001
        return None


def native_folded() -> str:
    try:
        from torchft_tpu_torch import _native

        return _native.prof_snapshot()
    except Exception:  # noqa: BLE001
        return ""
