"""Monitored IPC queues — the port's copy of ``torchft_tpu/multiprocessing.py``.

Reference: torchft/multiprocessing.py:9-91. A plain mp.Queue.get() blocks
forever if the producer process died; `MonitoredQueue` polls the remote
process every second during get/put and raises RuntimeError the moment it
is gone, and re-raises Exception payloads on get. This is what makes the
subprocess-isolated collectives (``proxy.CollectivesProxy``) killable rather than
wedging the trainer.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as _q
import time
from datetime import timedelta
from typing import Any, Optional, Union

__all__ = ["MonitoredQueue"]

_POLL_S = 1.0


class MonitoredQueue:
    def __init__(self, q: mp.Queue) -> None:
        self._q = q

    def _deadline(self, timeout: Optional[Union[float, timedelta]]) -> Optional[float]:
        if timeout is None:
            return None
        secs = timeout.total_seconds() if isinstance(timeout, timedelta) else timeout
        return time.monotonic() + secs

    def get(
        self,
        proc: mp.Process,
        timeout: Optional[Union[float, timedelta]] = None,
    ) -> Any:
        deadline = self._deadline(timeout)
        while True:
            if not proc.is_alive():
                raise RuntimeError(f"process {proc.pid} is dead (exitcode {proc.exitcode})")
            wait = _POLL_S
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("queue.get timed out")
                wait = min(wait, remaining)
            try:
                item = self._q.get(timeout=wait)
            except _q.Empty:
                continue
            if isinstance(item, Exception):
                raise item
            return item

    def put(
        self,
        item: Any,
        proc: mp.Process,
        timeout: Optional[Union[float, timedelta]] = None,
    ) -> None:
        deadline = self._deadline(timeout)
        while True:
            if not proc.is_alive():
                raise RuntimeError(f"process {proc.pid} is dead (exitcode {proc.exitcode})")
            wait = _POLL_S
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("queue.put timed out")
                wait = min(wait, remaining)
            try:
                self._q.put(item, timeout=wait)
                return
            except _q.Full:
                continue

    def close(self) -> None:
        self._q.close()
