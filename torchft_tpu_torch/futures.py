"""Futures with deadline enforcement.

The reference wraps ``torch.futures.Future`` with a timeout manager backed by
a lazily-started asyncio thread (torchft/futures.py:43-165 upstream).
The port keeps the JAX package's own chainable ``Future`` (continuations
via ``then``, error propagation) plus a single daemon timer thread that
fails futures past their deadline — a copy of ``torchft_tpu/futures.py``
without its fault-injection point. A deadline counts in
``tft_future_timeouts_total`` and dumps the flight recorder.
"""

from __future__ import annotations

import heapq
import threading
from datetime import timedelta
from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")
S = TypeVar("S")

__all__ = ["Future", "future_timeout", "future_wait", "run_in_executor"]


class Future(Generic[T]):
    """A chainable future.

    ``then(cb)`` schedules ``cb(fut)`` when this future completes and returns
    a new Future holding ``cb``'s result (exceptions propagate), matching the
    continuation style the reference relies on for gradient normalization and
    error swallowing (torchft/manager.py:280-293, 348-362).
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._done = False
        self._value: Optional[T] = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future[T]"], None]] = []

    # -- producer side --
    def set_result(self, value: T) -> None:
        with self._cond:
            if self._done:
                return
            self._value = value
            self._done = True
            callbacks = self._callbacks
            self._callbacks = []
            self._cond.notify_all()
        for cb in callbacks:
            self._run_callback(cb)

    def set_exception(self, exc: BaseException) -> None:
        with self._cond:
            if self._done:
                return
            self._exception = exc
            self._done = True
            callbacks = self._callbacks
            self._callbacks = []
            self._cond.notify_all()
        for cb in callbacks:
            self._run_callback(cb)

    # -- consumer side --
    def done(self) -> bool:
        with self._cond:
            return self._done

    def wait(self, timeout: Optional[timedelta] = None) -> T:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._done,
                timeout.total_seconds() if timeout is not None else None,
            )
            if not ok:
                raise TimeoutError("future wait timed out")
        return self.value()

    def value(self) -> T:
        with self._cond:
            assert self._done, "future is not complete"
            if self._exception is not None:
                raise self._exception
            return self._value  # type: ignore[return-value]

    def exception(self) -> Optional[BaseException]:
        with self._cond:
            assert self._done, "future is not complete"
            return self._exception

    def then(self, callback: Callable[["Future[T]"], S]) -> "Future[S]":
        out: Future[S] = Future()

        def run(fut: "Future[T]") -> None:
            try:
                out.set_result(callback(fut))
            except BaseException as e:  # noqa: BLE001 — error futures carry anything
                out.set_exception(e)

        with self._cond:
            if not self._done:
                self._callbacks.append(run)
                return out
        run(self)
        return out

    def _run_callback(self, cb: Callable[["Future[T]"], None]) -> None:
        try:
            cb(self)
        except BaseException:  # noqa: BLE001 — continuation errors land in `out`
            pass

    @staticmethod
    def completed(value: T) -> "Future[T]":
        f: Future[T] = Future()
        f.set_result(value)
        return f

    @staticmethod
    def failed(exc: BaseException) -> "Future[Any]":
        f: Future[Any] = Future()
        f.set_exception(exc)
        return f


class _TimeoutManager:
    """Single daemon timer thread enforcing future deadlines (the asyncio
    event-loop analogue of torchft/futures.py:43-117)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        # heap entries hold a one-element SLOT, cleared when the future
        # completes, so payloads are never pinned for the full deadline
        self._heap: List[Tuple[float, int, List[Optional[Future[Any]]]]] = []
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    def register(self, fut: Future[Any], timeout: timedelta) -> None:
        import time

        deadline = time.monotonic() + timeout.total_seconds()
        # the heap entry must not pin the future (and its payload — e.g. a
        # whole gradient pytree on device) for the full deadline after it
        # completes: clear the slot on completion, the timer skips it
        slot: List[Optional[Future[Any]]] = [fut]
        fut.then(lambda _f: slot.__setitem__(0, None))
        with self._cond:
            self._seq += 1
            heapq.heappush(self._heap, (deadline, self._seq, slot))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="tft_timeout_manager", daemon=True
                )
                self._thread.start()
            self._cond.notify()

    def _run(self) -> None:
        import time

        while True:
            with self._cond:
                while not self._heap:
                    self._cond.wait()
                deadline, _, slot = self._heap[0]
                now = time.monotonic()
                if deadline > now:
                    self._cond.wait(timeout=deadline - now)
                    continue
                heapq.heappop(self._heap)
            fut = slot[0]
            if fut is not None and not fut.done():
                from torchft_tpu_torch import telemetry

                telemetry.FUTURE_TIMEOUTS.inc()
                # a deadline on the data plane usually means a wedged
                # collective: capture the op history now, while the last
                # completed and the first stuck op are fresh (rate-limited
                # inside dump(); it must never fail the timeout)
                try:
                    telemetry.FLIGHT.dump("deadline")
                except Exception:  # noqa: BLE001
                    pass
                fut.set_exception(
                    TimeoutError("future did not complete within deadline")
                )


_TIMEOUT_MANAGER = _TimeoutManager()


def future_timeout(fut: Future[T], timeout: timedelta) -> Future[T]:
    """Return a future that mirrors ``fut`` but fails with TimeoutError if it
    is not complete within ``timeout`` (torchft/futures.py:123-135)."""
    out: Future[T] = Future()

    def copy(f: Future[T]) -> None:
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
        else:
            out.set_result(f.value())

    fut.then(lambda f: copy(f))
    _TIMEOUT_MANAGER.register(out, timeout)
    return out


def future_wait(fut: Future[T], timeout: timedelta) -> T:
    """Block on ``fut`` up to ``timeout``; its error, or TimeoutError."""
    return fut.wait(timeout)


def run_in_executor(executor: Any, fn: Callable[..., T], *args: Any, **kwargs: Any) -> Future[T]:
    """Run ``fn`` on ``executor`` (a ``concurrent.futures`` executor) and
    return a chainable :class:`Future` for the result. The Manager's
    pipelined commit ships its vote RPC onto the vote thread with it."""
    out: Future[T] = Future()

    def task() -> None:
        try:
            out.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 — error futures carry anything
            out.set_exception(e)

    executor.submit(task)
    return out
