"""Readers-writer lock with timeouts.

Gates checkpoint serving: the writer is held while checkpoints are
disallowed, so a healing replica's GET blocks until ``send_checkpoint``
stages fresh state (reference: torchft/checkpointing/_rwlock.py:42-132,
used at http_transport.py:181-202). Writer-preference is not needed —
there is exactly one writer (the manager thread) and it must win promptly,
which the ``_want_write`` gate provides.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional


class RWLock:
    """Many readers / one writer, every acquire bounded by ``timeout``."""

    def __init__(self, timeout: Optional[float] = None) -> None:
        self._timeout = timeout
        self._cond = threading.Condition()
        self._readers = 0  # guarded-by: _cond
        self._writer = False  # guarded-by: _cond
        self._want_write = 0  # pending writers block new readers; guarded-by: _cond

    def _wait(self, predicate, timeout: Optional[float] = None) -> None:
        timeout = self._timeout if timeout is None else timeout
        ok = self._cond.wait_for(predicate, timeout=timeout)
        if not ok:
            raise TimeoutError(f"rwlock acquire timed out after {timeout}s")

    def r_acquire(self, timeout: Optional[float] = None) -> None:
        """``timeout`` overrides the lock-wide default for this acquire —
        the heal metadata endpoints use a short bound so a healer probing
        a source that will NEVER stage this round (e.g. one whose quorum
        ran allow_heal=False) fails fast instead of burning the full
        transfer timeout (docs/heal_plane.md)."""
        with self._cond:
            self._wait(
                lambda: not self._writer and self._want_write == 0,
                timeout=timeout,
            )
            self._readers += 1

    def r_release(self) -> None:
        with self._cond:
            assert self._readers > 0
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def w_acquire(self) -> None:
        with self._cond:
            self._want_write += 1
            try:
                self._wait(lambda: not self._writer and self._readers == 0)
            except BaseException:
                self._want_write -= 1
                if self._want_write == 0:
                    # readers block on _want_write == 0; wake them or they
                    # stall until their own timeout after a writer gives up
                    self._cond.notify_all()
                raise
            self._want_write -= 1
            self._writer = True

    def w_release(self) -> None:
        with self._cond:
            assert self._writer
            self._writer = False
            self._cond.notify_all()

    def w_locked(self) -> bool:
        with self._cond:
            return self._writer

    class _Guard:
        def __init__(self, acquire, release) -> None:
            self._acquire, self._release = acquire, release

        def __enter__(self) -> None:
            self._acquire()

        def __exit__(self, *exc) -> None:
            self._release()

    def read_lock(self) -> "_Guard":
        return RWLock._Guard(self.r_acquire, self.r_release)

    def write_lock(self) -> "_Guard":
        return RWLock._Guard(self.w_acquire, self.w_release)
