"""Checkpoint transport interface.

Mirrors the reference ABC exactly (torchft/checkpointing/transport.py:14-68):
``metadata`` advertises how peers can reach this transport, ``send`` /
``recv`` move one step's state dict, and ``disallow_checkpoint`` closes the
serving window after the commit barrier so stale state is never served.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from datetime import timedelta
from typing import Generic, List, TypeVar

T = TypeVar("T")

__all__ = ["CheckpointTransport"]


class CheckpointTransport(ABC, Generic[T]):
    @abstractmethod
    def metadata(self) -> str:
        """Metadata (e.g. an URL) peers need to fetch checkpoints from this
        rank. Carried to them through the quorum exchange."""

    @abstractmethod
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: timedelta
    ) -> None:
        """Make ``state_dict`` for ``step`` available to ``dst_ranks``."""

    def disallow_checkpoint(self) -> None:  # noqa: B027 — optional hook
        """Close the serving window (called after the commit barrier)."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        """Fetch ``step``'s state dict from ``src_rank``."""

    def shutdown(self, wait: bool = True) -> None:  # noqa: B027 — optional hook
        """Release resources (server threads, sockets)."""
