"""Low-level coordination API: Lighthouse / Manager servers and clients —
the port's copy of ``torchft_tpu/coordination.py``, without the telemetry
piggyback, tracing and fault points.

The servers run in the C++ core (``native/coord.cc``); CANCELLED /
DEADLINE_EXCEEDED replies become ``TimeoutError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, List, Optional

from torchft_tpu_torch import _native

__all__ = ["LighthouseServer", "ManagerServer", "ManagerClient", "QuorumResult"]


def _ms(t: timedelta) -> int:
    return max(1, int(t.total_seconds() * 1000))


def _strs(values: List[Any]) -> List[str]:
    return [s if isinstance(s, str) else s.decode() for s in values]


@dataclass
class QuorumResult:
    """Per-rank quorum outcome."""

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 1
    recover_src_manager_address: str = ""
    recover_src_rank: Optional[int] = None
    recover_dst_ranks: List[int] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_rank: Optional[int] = None
    max_world_size: int = 1
    heal: bool = False
    # any local rank of this group heals -> the group contributes zeros on
    # every rank plane (participation must be plane-consistent)
    group_heal: bool = False
    # quorum members' replica_ids in replica_rank order
    participant_ids: List[str] = field(default_factory=list)

    @staticmethod
    def _from_wire(d: Dict[str, Any]) -> "QuorumResult":
        return QuorumResult(
            quorum_id=d.get("quorum_id", 0),
            replica_rank=d.get("replica_rank", 0),
            replica_world_size=d.get("replica_world_size", 1),
            recover_src_manager_address=d.get("recover_src_manager_address", ""),
            recover_src_rank=d.get("recover_src_rank"),
            recover_dst_ranks=list(d.get("recover_dst_ranks", [])),
            store_address=d.get("store_address", ""),
            max_step=d.get("max_step", 0),
            max_rank=d.get("max_rank"),
            max_world_size=d.get("max_world_size", 1),
            heal=d.get("heal", False),
            group_heal=d.get("group_heal", d.get("heal", False)),
            participant_ids=_strs(d.get("participant_ids", [])),
        )


class LighthouseServer:
    """Global quorum coordinator across replica groups (C++ server,
    native/coord.cc): heartbeat health, fast quorum, split-brain guard,
    join-timeout straggler wait. Defaults: join=100ms, tick=100ms,
    heartbeat timeout=5s."""

    def __init__(
        self,
        bind: str,
        min_replicas: int,
        join_timeout_ms: Optional[int] = None,
        quorum_tick_ms: Optional[int] = None,
        heartbeat_timeout_ms: Optional[int] = None,
    ) -> None:
        self._handle, self._address = _native.lighthouse_create(
            bind,
            min_replicas,
            join_timeout_ms if join_timeout_ms is not None else 100,
            quorum_tick_ms if quorum_tick_ms is not None else 100,
            heartbeat_timeout_ms if heartbeat_timeout_ms is not None else 5000,
        )

    def address(self) -> str:
        return self._address

    def shutdown(self) -> None:
        if self._handle:
            _native.lighthouse_shutdown(self._handle)
            self._handle = 0

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


class ManagerServer:
    """Per-replica-group coordinator: aggregates the group's ranks, proxies
    quorum to the lighthouse, computes recovery assignments and arbitrates
    the commit vote."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        hostname: str,
        bind: str,
        store_addr: str,
        world_size: int,
        connect_timeout: timedelta = timedelta(seconds=60),
    ) -> None:
        self._handle, self._address = _native.manager_create(
            replica_id,
            lighthouse_addr,
            hostname,
            bind,
            store_addr,
            world_size,
            100,  # heartbeat interval, ms
            _ms(connect_timeout),
        )

    def address(self) -> str:
        return self._address

    def shutdown(self) -> None:
        if self._handle:
            _native.manager_shutdown(self._handle)
            self._handle = 0

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


class ManagerClient:
    """Client for a ManagerServer. Timeouts travel in-band and are enforced
    server-side."""

    def __init__(self, addr: str, connect_timeout: timedelta) -> None:
        self._client = _native.NativeClient(addr, _ms(connect_timeout))

    def _quorum(
        self,
        rank: int,
        step: int,
        checkpoint_metadata: str,
        timeout: timedelta,
        commit_failures: int = 0,
    ) -> QuorumResult:
        """``commit_failures > 0`` requests a data-plane flush: the
        lighthouse bumps quorum_id even without a membership change, so
        every group re-rendezvouses its collectives."""
        req: Dict[str, Any] = {
            "rank": rank,
            "step": step,
            "checkpoint_metadata": checkpoint_metadata,
            "shrink_only": False,
            "commit_failures": commit_failures,
        }
        return QuorumResult._from_wire(
            self._client.call("mgr.quorum", req, _ms(timeout))
        )

    def _checkpoint_metadata(self, rank: int, timeout: timedelta) -> str:
        resp = self._client.call(
            "mgr.checkpoint_metadata", {"rank": rank}, _ms(timeout)
        )
        return resp["checkpoint_metadata"]

    def should_commit(
        self, rank: int, step: int, should_commit: bool, timeout: timedelta
    ) -> bool:
        req = {"rank": rank, "step": step, "should_commit": should_commit}
        resp = self._client.call("mgr.should_commit", req, _ms(timeout))
        return resp["should_commit"]

    def close(self) -> None:
        self._client.close()
