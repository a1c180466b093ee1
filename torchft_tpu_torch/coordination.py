"""Low-level coordination API: Lighthouse / Manager servers and clients —
the port's copy of ``torchft_tpu/coordination.py``. The quorum and vote
RPCs carry the caller's trace context
(``"trace"``), run in ``quorum_rpc`` / ``should_commit_rpc`` spans, and the
quorum's latency and count are recorded (``tft_quorum_latency_seconds``,
``tft_quorums_total``). The quorum RPC and a heartbeat carry the replica's
telemetry report (``"telemetry"``: a delta blob or the full-JSON row),
which the lighthouse folds into ``/cluster.json``, ``/fleet.json``,
``/timeseries.json`` and the merged ``/trace``; the quorum reply acks the
delta chain (``"tack"``, :attr:`QuorumResult.telemetry_ack`). The vote
carries the divergence sentinel's digest, its epoch and the fence flag,
and its reply the lighthouse's divergence latch
(:attr:`ManagerClient.last_divergence`). Fault
points (``faultinject.core``): ``quorum.reply`` once the quorum reply
arrived, ``commit.vote`` (``match="rpc"``) before the vote RPC.

The servers run in the C++ core (``native/coord.cc``); CANCELLED /
DEADLINE_EXCEEDED replies become ``TimeoutError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, List, Optional

from torchft_tpu_torch import _native
from torchft_tpu_torch.faultinject.core import fault_point

__all__ = [
    "LighthouseServer",
    "LighthouseClient",
    "ManagerServer",
    "ManagerClient",
    "QuorumResult",
]


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
    # the striped heal: manager addresses of the whole max-step cohort (the
    # one bootstrap source at max_step 0)
    recover_src_addresses: List[str] = field(default_factory=list)
    # someone heals this round: every up-to-date member stages a checkpoint,
    # so that all of them can serve stripes
    heal_pending: bool = False
    # the telemetry delta chain's ack: the lighthouse's last applied
    # version per encoder incarnation, {inc_hex: {"ver": int, "resync":
    # bool}}; None until the lighthouse has acked anything
    telemetry_ack: Optional[Dict[str, Any]] = None

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
            recover_src_addresses=_strs(d.get("recover_src_addresses", [])),
            heal_pending=d.get("heal_pending", False),
            telemetry_ack=d.get("tack") or None,
        )


class LighthouseServer:
    """Global quorum coordinator across replica groups (C++ server,
    native/coord.cc): heartbeat health, fast quorum, split-brain guard,
    join-timeout straggler wait, and eviction reports (``lh.evict``: the
    victim's manager address is probed for 100 ms before its heartbeat
    lease is expired). Defaults: join=100ms, tick=100ms, heartbeat
    timeout=5s."""

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
        _native.track(self, "shutdown")

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
        heartbeat_interval: timedelta = timedelta(milliseconds=100),
    ) -> None:
        self._handle, self._address = _native.manager_create(
            replica_id,
            lighthouse_addr,
            hostname,
            bind,
            store_addr,
            world_size,
            _ms(heartbeat_interval),
            _ms(connect_timeout),
        )
        _native.track(self, "shutdown")

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

    # the divergence flag of the last vote's reply (a class default, so a
    # spec'd test double has the attribute too)
    last_divergence = False

    def __init__(self, addr: str, connect_timeout: timedelta) -> None:
        self._client = _native.NativeClient(addr, _ms(connect_timeout))

    def _quorum(
        self,
        rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout: timedelta,
        commit_failures: int = 0,
        telemetry_payload: Optional[Dict[str, Any]] = None,
    ) -> QuorumResult:
        """``shrink_only`` lets the quorum only lose members (a planned
        downscale). ``commit_failures > 0`` requests a data-plane flush:
        the lighthouse bumps quorum_id even without a membership change, so
        every group re-rendezvouses its collectives. ``telemetry_payload``
        is this replica's telemetry report, which the manager server
        forwards to the lighthouse: no extra round trip."""
        import time

        from torchft_tpu_torch import telemetry

        req: Dict[str, Any] = {
            "rank": rank,
            "step": step,
            "checkpoint_metadata": checkpoint_metadata,
            "shrink_only": shrink_only,
            "commit_failures": commit_failures,
            # the caller's trace context rides the request; the C++ server
            # keeps no spans, so it is for the wire (a capture names the
            # caller's span). The live cross-replica link is the heal's
            # X-TFT-Trace header.
            "trace": telemetry.TRACER.inject(),
        }
        if telemetry_payload:
            req["telemetry"] = telemetry_payload
        t0 = time.perf_counter()
        with telemetry.TRACER.span("quorum_rpc", rank=rank, step=step):
            resp = self._client.call("mgr.quorum", req, _ms(timeout))
        # the RPC long-polls until the lighthouse forms the quorum: this is
        # the quorum's formation latency as this rank saw it
        telemetry.QUORUM_LATENCY.observe(time.perf_counter() - t0)
        telemetry.QUORUMS_TOTAL.inc()
        # reply-side injection: a delay stretches the window between the
        # quorum landing and the plane's reconfigure; an error makes this
        # rank treat a delivered quorum as failed (retried next step)
        fault_point("quorum.reply", match="", rank=rank, step=step)
        return QuorumResult._from_wire(resp)

    def _checkpoint_metadata(self, rank: int, timeout: timedelta) -> str:
        resp = self._client.call(
            "mgr.checkpoint_metadata", {"rank": rank}, _ms(timeout)
        )
        return resp["checkpoint_metadata"]

    def should_commit(
        self,
        rank: int,
        step: int,
        should_commit: bool,
        timeout: timedelta,
        digest: Optional[str] = None,
        epoch: int = -1,
        fence: bool = False,
    ) -> bool:
        """The commit vote. ``digest`` is the divergence sentinel's
        post-reduce state digest (``"-"`` abstains): the manager server
        folds its ranks' digests and reports them to the lighthouse's
        (epoch, step) cohort compare. With ``fence`` the lighthouse decides
        before the decision is published, and a mismatch vetoes the commit.
        The reply's divergence flag is kept on :attr:`last_divergence`."""
        from torchft_tpu_torch import telemetry

        # vote-RPC injection: a delay is a synthetic commit-barrier round
        # trip (what the pipelined mode hides), an error a lost vote
        fault_point("commit.vote", match="rpc", rank=rank, step=step)
        req: Dict[str, Any] = {
            "rank": rank,
            "step": step,
            "should_commit": should_commit,
            "trace": telemetry.TRACER.inject(),
        }
        if digest is not None:
            req["digest"] = digest
            req["epoch"] = epoch
            req["fence"] = fence
        with telemetry.TRACER.span("should_commit_rpc", rank=rank, step=step,
                                   vote=should_commit):
            resp = self._client.call("mgr.should_commit", req, _ms(timeout))
        self.last_divergence = bool(resp.get("divergence", False))
        return resp["should_commit"]

    def evict(self, victim: str, timeout: timedelta = timedelta(seconds=5)) -> bool:
        """Report ``victim`` (a replica_id seen dead on the data plane) for
        immediate eviction. The manager forwards it to the lighthouse, which
        probes the victim's manager address before expiring its heartbeat:
        a false report about a live peer is a no-op. Returns whether the
        victim was evicted."""
        resp = self._client.call("mgr.evict", {"victim": victim}, _ms(timeout))
        return bool(resp.get("evicted", False))

    def close(self) -> None:
        self._client.close()


class LighthouseClient:
    """Direct lighthouse client: heartbeats, eviction reports and the
    divergence sentinel's digest reports. The manager server normally sends
    them; exposed for tests and tooling."""

    def __init__(self, addr: str, connect_timeout: timedelta) -> None:
        self._client = _native.NativeClient(addr, _ms(connect_timeout))

    def heartbeat(
        self,
        replica_id: str,
        timeout: timedelta = timedelta(seconds=5),
        telemetry_payload: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One heartbeat; ``telemetry_payload`` carries a telemetry report
        (the shape the Manager sends on its quorum RPC) to the lighthouse."""
        req: Dict[str, Any] = {"replica_id": replica_id}
        if telemetry_payload:
            req["telemetry"] = telemetry_payload
        self._client.call("lh.heartbeat", req, _ms(timeout))

    def evict(
        self, reporter: str, victim: str, timeout: timedelta = timedelta(seconds=5)
    ) -> bool:
        """Direct eviction report (see :meth:`ManagerClient.evict`)."""
        resp = self._client.call(
            "lh.evict", {"reporter": reporter, "victim": victim}, _ms(timeout)
        )
        return bool(resp.get("evicted", False))

    def digest(
        self,
        replica_id: str,
        epoch: int,
        step: int,
        digest: str,
        wait: bool = False,
        cohort: int = 0,
        timeout: timedelta = timedelta(seconds=10),
    ) -> Dict[str, Any]:
        """Report one replica's commit-time state digest to the
        lighthouse's (epoch, step) cohort compare (``lh.digest``; the
        manager server normally sends it from the vote). ``wait``
        long-polls until the whole cohort reported (``cohort`` overrides
        the quorum's size). Returns ``{"match", "divergence", "reports"}``."""
        req: Dict[str, Any] = {
            "replica_id": replica_id,
            "epoch": epoch,
            "step": step,
            "digest": digest,
            "wait": wait,
        }
        if cohort:
            req["cohort"] = cohort
        return self._client.call("lh.digest", req, _ms(timeout))

    def close(self) -> None:
        self._client.close()
