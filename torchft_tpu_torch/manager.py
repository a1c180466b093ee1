"""Manager — the per-replica fault-tolerance runtime, the port's copy of
``torchft_tpu/manager.py`` trimmed to the core protocol:

* ``start_quorum`` runs the quorum RPC on a worker thread so it overlaps
  the forward pass (``use_async_quorum=False`` waits for it, and applies a
  heal before returning); a new ``quorum_id`` reconfigures the collectives;
* the heal: the quorum thread serves a checkpoint to
  ``recover_dst_ranks`` or receives one when ``quorum.heal``, and stages it
  for the main thread, which applies it at the commit barrier (async
  quorum) or inside ``start_quorum`` (sync quorum). While anyone heals,
  every member of the max-step cohort within the source cap stages its
  state (a stripe source), and the healer pulls byte ranges from all of
  them at once (``HTTPTransport.recv_checkpoint_multi``); with
  ``TORCHFT_HEAL_DIFF=1`` each step boundary records a digest trail of the
  committed state, and a healer that still holds the committed state of
  a recent step receives only the leaves that changed since;
* ``allreduce_many`` averages across replica groups: host buffers in place
  on the host plane, tensors on the device on the device plane
  (``device_data_plane()``); healing replicas contribute zeros and the
  divisor is the issue-time participant count, not the world size;
* ``should_commit`` is the per-step commit barrier: drain pending work,
  apply staged state, vote; the optimizer steps only on a unanimous True;
* the pipelined commit (``commit_pipeline=True``): ``should_commit_async``
  issues the vote on its own thread and socket while the trainer runs the
  next step, ``resolve_pending_commit`` lands it, and a speculation fence
  keeps the quorum thread's heal traffic off speculative state;
* the death path: a peer that dies on the data plane (the collectives'
  death watch, or an op failing with ``PeerGoneError``) is reported to the
  lighthouse for eviction at once, so the next quorum need not wait out
  its heartbeat lease; the death watch also starts an early re-quorum
  (no heal) under the doomed step, whose quorum the retried step then
  takes (with its heal), and a step whose ops spanned two quorum epochs
  votes False.

Telemetry (:mod:`torchft_tpu_torch.telemetry`), at the JAX Manager's
sites: the trail's lifecycle events (``quorum_start``, ``quorum_ready``,
``heal_begin`` / ``heal_end`` / ``heal_failed``, ``peer_death``,
``eviction``, ``commit`` / ``abort`` / ``commit_rollback``,
``step_outlier``); ``quorum``, ``heal_send``, ``heal_recv`` and
``should_commit`` spans whose trace id is ``replica_id:step:quorum_id``;
the step-anatomy ledger's ``quorum_wait``, ``heal`` and ``commit_barrier``
records and a ``tick`` at each vote; a ``StepTimer`` whose quorum and heal
steps are tagged outliers; ``SIGUSR2`` dumps the flight recorder (when the
Manager is made on the main thread); and a ``StepWatchdog`` armed at each
``start_quorum`` and disarmed at the vote, which emits ``watchdog_stall``
and dumps the flight recorder when a step runs far past its steady p99.

The fleet plane: each quorum RPC carries this replica's telemetry report
(health scalars, counters digest, anatomy, log2 histograms, the time
series), delta-encoded against what the lighthouse acked
(``telemetry/fleetdelta.py``; ``TORCHFT_TELEMETRY_DELTA=0`` sends the
full-JSON row, ``TORCHFT_TELEMETRY_PIGGYBACK=0`` nothing), its encoding
recorded as the ledger's ``telemetry`` phase; a stalled step pushes one
heartbeat with the JSON row, so ``/cluster.json`` shows it stuck; the SLO
evaluators (``TORCHFT_SLO_STEP_S``) see each step's wall and a rejoin's
time to its commit; and a rank-0 Manager hosts the straggler monitor
(``TORCHFT_STRAGGLER_MONITOR=1``) and the history thread feeding the
regression sentinel and the critical-path attributor
(``TORCHFT_REGRESSION_MONITOR=1``).

Forensics and the fault plane: the Python stack sampler runs always-on
(``TORCHFT_PROF_HZ``); with ``TORCHFT_DIAG_DIR`` set the Manager hosts a
``DiagnosisEngine`` that turns latch events into diagnosis bundles, and
the report and payload announce them (``diag_bundles`` / ``diag_last`` /
``diag_dir``, which the lighthouse's ``/diagnosis.json`` lists); the
crash-durable black box's (replica, step, epoch) context moves in
lockstep with the tracer's; and the commit barrier's drain is the
``commit.vote`` injection site (``match="prepare"``).

The divergence sentinel (``TORCHFT_DIVERGENCE_SENTINEL=1``): each op's
reduced outputs are folded into a digest on the op thread (copied to the
host first on the device plane), the step's digests into one at the
commit, and the vote carries it to the lighthouse's (epoch, step) cohort
compare; a step that will not commit cleanly abstains (``"-"``). A
mismatch latches ``divergence_detected`` once a process and the series'
``flag.divergence``; ``TORCHFT_DIVERGENCE_FENCE=1`` (which implies the
sentinel) also vetoes the commit. ``WorldSizeMode.FIXED_WITH_SPARES``
pins the divisor at ``min_replica_size`` and demotes the groups past it
to spares that contribute zeros.

The heal warm-up (``set_heal_warmup``): a callback that gets the incoming
state's shapes (a tree of ``TensorSpec`` leaves) on a daemon thread as soon
as the transfer's header lands, while the bulk bytes still stream; a
trainer builds what its first update needs from them
(``FTTrainer._heal_warmup``). A failing warm-up never fails the heal.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar, cast

import numpy as np
import torch

from torchft_tpu_torch import telemetry
from torchft_tpu_torch.checkpointing import delta
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.serialization import _tensor_to_host, flatten_state
from torchft_tpu_torch.checkpointing.stripes import heal_sources_limit
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collectives, PeerGoneError, ReduceOp
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer
from torchft_tpu_torch.faultinject.core import fault_point
from torchft_tpu_torch.futures import Future, future_timeout, run_in_executor
from torchft_tpu_torch.profiling import StepTimer
from torchft_tpu_torch.store import StoreClient
from torchft_tpu_torch.telemetry import fleetdelta, timeseries
from torchft_tpu_torch.telemetry.critical_path import CriticalPathMonitor
from torchft_tpu_torch.telemetry.diagnosis import DiagnosisEngine, diag_dir
from torchft_tpu_torch.telemetry.profiler import PROFILER
from torchft_tpu_torch.telemetry.regression import RegressionMonitor
from torchft_tpu_torch.telemetry.slo import FleetMonitor, SloManager

T = TypeVar("T")

MANAGER_ADDR_KEY: str = "manager/addr"
REPLICA_ID_KEY: str = "manager/replica_id"
MANAGER_PORT_ENV: str = "TORCHFT_MANAGER_PORT"
LIGHTHOUSE_ENV: str = "TORCHFT_LIGHTHOUSE"
STORE_ADDR_ENV: str = "TORCHFT_STORE_ADDR"
COMMIT_PIPELINE_ENV: str = "TORCHFT_COMMIT_PIPELINE"
PIGGYBACK_ENV: str = "TORCHFT_TELEMETRY_PIGGYBACK"
STRAGGLER_MONITOR_ENV: str = "TORCHFT_STRAGGLER_MONITOR"
REGRESSION_MONITOR_ENV: str = "TORCHFT_REGRESSION_MONITOR"
REGRESSION_POLL_ENV: str = "TORCHFT_REGRESSION_POLL_S"
DIVERGENCE_SENTINEL_ENV: str = "TORCHFT_DIVERGENCE_SENTINEL"
DIVERGENCE_FENCE_ENV: str = "TORCHFT_DIVERGENCE_FENCE"
# the lighthouse refuses an anatomy digest past this (the JSON row's cap)
ANATOMY_CAP_BYTES = 1 << 16

__all__ = ["Manager", "WorldSizeMode"]


class WorldSizeMode(Enum):
    """What the divisor does when replica groups come and go.

    DYNAMIC: the batch scales with the live group count; gradients divide
    by the current participant count.
    FIXED_WITH_SPARES: the world size is pinned at ``min_replica_size``;
    groups past it are hot spares that contribute zeros, so the divisor
    (and the effective batch) never changes.
    """

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class _PendingCommit:
    """One in-flight pipelined vote. What the post-vote accounting needs is
    taken at issue time: when the vote resolves, the manager's live fields
    already describe the next step."""

    __slots__ = ("future", "step", "n_step", "local_vote", "enough_replicas",
                 "mixed_epochs", "errored", "on_resolved", "prepare_s", "digest", "epoch")

    def __init__(self) -> None:
        self.future: Optional[Future] = None
        self.step = 0
        self.n_step = 0
        self.local_vote = False
        self.enough_replicas = False
        self.mixed_epochs = False
        self.errored: Optional[Exception] = None
        self.on_resolved: Optional[Callable[[bool], None]] = None
        self.prepare_s = 0.0  # the pre-vote drain's wall clock
        # the divergence sentinel's folded step digest (None when off, "-"
        # to abstain) and the plane epoch the step reduced under
        self.digest: Optional[str] = None
        self.epoch = -1


def _diag_fields(manager: Any) -> Dict[str, Any]:
    """The diagnosis bundles' announcement on a Manager's report and
    payload (``diag_bundles``, the latest's name, the directory) once its
    engine wrote one; the lighthouse indexes them at ``/diagnosis.json``.
    ``getattr``: the report builders also run on partly built Managers."""
    diagnosis = getattr(manager, "_diagnosis", None)
    if diagnosis is None or not diagnosis.bundle_count:
        return {}
    return {"diag_bundles": diagnosis.bundle_count,
            "diag_last": diagnosis.last_bundle or "",
            "diag_dir": diagnosis.directory or ""}


class _ManagerLogger:
    """Prefixes every line with ``[replica_id/rank - step N]``."""

    def __init__(self, manager: "Manager", replica_id: str, rank: int) -> None:
        self._logger = logging.getLogger("torchft_tpu_torch.manager")
        self._replica_id = replica_id
        self._rank = rank
        self._manager = manager

    def _prefix(self) -> str:
        return f"[{self._replica_id}/{self._rank} - step {self._manager.current_step()}]"

    def info(self, msg: str) -> None:
        self._logger.info(f"{self._prefix()} {msg}")

    def warn(self, msg: str) -> None:
        self._logger.warning(f"{self._prefix()} {msg}")

    def exception(self, msg: str) -> None:
        self._logger.exception(f"{self._prefix()} {msg}")


class Manager:
    """Fault-tolerance manager for one rank of one replica group."""

    def __init__(
        self,
        collectives: Collectives,
        load_state_dict: Optional[Callable[[T], None]],
        state_dict: Optional[Callable[[], T]],
        min_replica_size: int,
        use_async_quorum: bool = True,
        timeout: timedelta = timedelta(seconds=60),
        quorum_timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=60),
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        port: Optional[int] = None,
        hostname: Optional[str] = None,
        checkpoint_transport: Optional[CheckpointTransport[Dict[str, T]]] = None,
        commit_pipeline: bool = False,
    ) -> None:
        """
        Args:
            collectives: the reconfigurable cross-replica-group collectives
                (unconfigured; the Manager configures it each quorum change)
            load_state_dict / state_dict: user snapshot/restore callbacks for
                live recovery (or later via :meth:`set_state_dict_fns`)
            min_replica_size: minimum replica groups for a step to commit
            use_async_quorum: overlap the quorum RPC with the forward pass;
                False waits for it in ``start_quorum`` and heals there
            timeout: deadline for collectives, commit votes and transfers
            quorum_timeout: deadline for quorum formation
            rank / world_size: this rank within the replica group (env RANK /
                WORLD_SIZE fallback)
            world_size_mode: see :class:`WorldSizeMode`
            store_addr: ``host:port`` of the group's KV store
                (TORCHFT_STORE_ADDR fallback)
            lighthouse_addr: rank 0 only; TORCHFT_LIGHTHOUSE fallback
            replica_id: rank 0 only; a uuid4 suffix is always appended so a
                restarted group is a distinct lighthouse member
            port: rank-0 manager server port (TORCHFT_MANAGER_PORT fallback,
                else ephemeral)
            checkpoint_transport: defaults to an :class:`HTTPTransport`
                that lands received tensors on the CPU
            commit_pipeline: issue the commit vote asynchronously
                (:meth:`should_commit_async`) so the next step's compute
                overlaps it; the trainer keeps a rollback snapshot.
                ``TORCHFT_COMMIT_PIPELINE=1`` enables it too. Every replica
                group must agree on it.
        """
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        # the heal warm-up: set on the main thread before the first quorum
        # (set_heal_warmup), read by the quorum thread's heal
        self._heal_warmup: Optional[Callable[[Any], None]] = None
        # unguarded-ok: quorum-thread handoff — staged by the quorum thread
        #   during a heal, applied on the main thread strictly after
        #   wait_quorum() (_apply_pending_state_dict waits for it)
        self._pending_state_dict: Optional[Dict[str, object]] = None
        self._use_async_quorum = use_async_quorum
        self._commit_pipeline = commit_pipeline or (
            os.environ.get(COMMIT_PIPELINE_ENV, "0") == "1"
        )
        self._timeout = timeout
        self._quorum_timeout = quorum_timeout
        self._connect_timeout = connect_timeout
        self._min_replica_size = min_replica_size
        self._world_size_mode = world_size_mode
        # The divergence sentinel: digest each step's post-reduce state and
        # let the lighthouse compare it within the (epoch, step) cohort at
        # the vote. The fence (implies the sentinel) also vetoes the commit
        # on a mismatch; every group must agree on it, as on the pipelined
        # commit. Off by default: hashing every reduced buffer is not free.
        self._divergence_fence = os.environ.get(DIVERGENCE_FENCE_ENV, "0") == "1"
        self._divergence_sentinel = self._divergence_fence or (
            os.environ.get(DIVERGENCE_SENTINEL_ENV, "0") == "1"
        )
        # unguarded-ok: op-thread handoff — appended by the op thread in
        #   issue order, read and cleared at the commit barrier after the
        #   pending-work drain has waited for every op of the step
        self._step_digests: List[str] = []
        # unguarded-ok: a once-a-process latch; a racing second set is a no-op
        self._divergence_latched = False

        store_addr = store_addr or os.environ[STORE_ADDR_ENV]
        self._rank: int = rank if rank is not None else int(os.environ["RANK"])
        world_size = world_size or int(os.environ["WORLD_SIZE"])

        if checkpoint_transport is None:
            checkpoint_transport = HTTPTransport(timeout=timeout)
        self._checkpoint_transport: CheckpointTransport[Dict[str, T]] = (
            checkpoint_transport
        )
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="async_quorum")
        self._quorum_future: Optional[concurrent.futures.Future] = None  # guarded-by: _qf_lock
        # guards _quorum_future replacement: the death watch may submit an
        # early re-quorum from its monitor thread (see _on_peer_death)
        self._qf_lock = threading.Lock()
        self._shutting_down = False
        self._last_quorum_args: tuple = (True, False, None)
        # the death watch's last early re-quorum: the next start_quorum
        # takes its result for the retried step instead of asking again
        self._early_future: Optional[concurrent.futures.Future] = None  # guarded-by: _qf_lock

        self._store = StoreClient(store_addr, connect_timeout=connect_timeout)
        self._collectives = collectives
        self._manager: Optional[ManagerServer] = None
        # rank 0's: the fleet monitors and the stall push talk to it
        self._lighthouse_addr: Optional[str] = None
        if self._rank == 0:
            if port is None:
                port = int(os.environ.get(MANAGER_PORT_ENV, 0))
            lighthouse_addr = lighthouse_addr or os.environ[LIGHTHOUSE_ENV]
            self._lighthouse_addr = lighthouse_addr
            replica_id = (replica_id or "") + str(uuid.uuid4())
            self._manager = ManagerServer(
                replica_id=replica_id,
                lighthouse_addr=lighthouse_addr,
                hostname=hostname or socket.gethostname(),
                bind=f"[::]:{port}",
                store_addr=store_addr,
                world_size=world_size,
                connect_timeout=connect_timeout,
            )
            self._store.set(MANAGER_ADDR_KEY, self._manager.address())
            self._store.set(REPLICA_ID_KEY, replica_id)

        self._manager_addr = self._store.get(MANAGER_ADDR_KEY).decode()
        self._client = ManagerClient(self._manager_addr, connect_timeout=connect_timeout)
        self._replica_id = self._store.get(REPLICA_ID_KEY).decode()
        self._logger = _ManagerLogger(self, self._replica_id, self._rank)

        # unguarded-ok: quorum-thread handoff — wait_quorum() orders the
        #   quorum thread's heal write of _step before main-thread reads
        self._step = 0
        self._quorum_id = -1
        # _participant_ids/_evicted cross three threads: the quorum thread
        # replaces membership each epoch, while the death-watch monitor and
        # the main thread's error paths report evictions. The lock makes
        # check-then-add one step (a victim reported twice costs a second
        # liveness probe) and keeps attribution reading a consistent pair.
        self._evict_lock = threading.Lock()
        self._participant_ids: List[str] = []  # guarded-by: _evict_lock
        self._evicted: set = set()  # guarded-by: _evict_lock
        # (plane_generation, participant_ids) armed for the death watch
        self._death_watch_snapshot: Optional[Tuple[int, List[str]]] = None
        # unguarded-ok: issue-time latch — read at the commit barrier after
        #   the pending-work drain (last write wins is the latch contract)
        self._commit_failures = 0  # pending data-plane flush request
        # unguarded-ok: error latch — any thread may latch, the commit
        #   barrier reads it after draining pending work; a racing latch
        #   changes which error aborts the step, never whether it aborts
        self._errored: Optional[Exception] = None
        self._errored_epoch = -1  # quorum_id whose plane produced _errored
        self._step_epochs: set = set()  # quorum_ids this step's ops ran on
        self._step_n: Optional[int] = None  # issue-time participant count

        # The data plane's sockets learn of a dead peer (FIN/RST) within
        # milliseconds, long before the next op would trip over them: the
        # eviction and the re-quorum then overlap the doomed step.
        if hasattr(collectives, "set_death_watch"):
            collectives.set_death_watch(self._on_peer_death)
        # unguarded-ok: quorum-thread handoff — wait_quorum() (async) or the
        #   synchronous start_quorum path orders the quorum thread's writes
        self._healing = False
        # unguarded-ok: quorum-thread handoff — same barrier as _healing
        self._group_healing = False
        self._pending_work: List[Future] = []
        # unguarded-ok: quorum-thread handoff — the heal restores it on the
        #   quorum thread, the main thread increments it after the drain
        self._batches_committed = 0
        self._participating_rank: Optional[int] = None
        self._participating_world_size: int = 0

        # pipelined commit: at most one vote in flight. _spec_cond fences
        # the quorum thread's heal send/recv until the main thread resolves
        # it, so a served checkpoint is never speculative state. The vote
        # has its own client: self._client serializes calls on one socket,
        # so the vote would otherwise queue behind the next step's quorum
        # long-poll.
        self._pending_commit: Optional[_PendingCommit] = None
        self._spec_cond = threading.Condition()
        self._commit_executor: Optional[ThreadPoolExecutor] = None
        self._commit_client: Optional[ManagerClient] = None

        # The differential heal (TORCHFT_HEAL_DIFF=1): per-leaf digests of
        # the committed state at recent steps, recorded on the main thread
        # at each start_quorum and read by the transport's delta endpoint.
        # None when off: the record costs a flatten (a device-to-host copy
        # of the whole state) and a digest every step.
        self._heal_trail = delta.CommitTrail() if delta.diff_enabled() else None
        if self._heal_trail is not None and hasattr(checkpoint_transport, "commit_trail"):
            checkpoint_transport.commit_trail = self._heal_trail

        # rolling steps/s with quorum and heal steps tagged as outliers;
        # the vote ticks it. Attached to the process's step-anatomy ledger,
        # which the vote ticks too, so summaries and flight dumps carry its
        # outlier digest.
        self.step_timer = StepTimer()
        telemetry.LEDGER.attach_timer(self.step_timer)
        # the burn-rate SLOs (off unless TORCHFT_SLO_STEP_S is set); the
        # latch rides the telemetry report to the lighthouse
        self._slo = SloManager()
        # unguarded-ok: quorum-thread handoff — set at a heal's begin on the
        #   quorum thread, read and cleared at the next committed vote on
        #   the main thread (wait_quorum orders them)
        self._rejoin_t0: Optional[float] = None
        # unguarded-ok: quorum-thread handoff — written where a heal lands,
        #   read when a report is made (a float: a stale read is harmless)
        self._last_heal_ts = 0.0
        # the delta chain's encoder, made at the first report: its random
        # incarnation tells the lighthouse a respawn from a continuation,
        # so it lives as long as the Manager (quorum thread only)
        self._tdelta_encoder: Optional[fleetdelta.DeltaEncoder] = None
        # unguarded-ok: a warn-once latch (the quorum thread's JSON row and
        #   the stall push's); a race can only repeat the warning
        self._anatomy_oversize_warned = False
        # rank 0 may host the fleet's monitors (one a fleet is enough)
        self._fleet_monitor: Optional[FleetMonitor] = None
        self._regression_monitor: Optional[RegressionMonitor] = None
        self._critical_path_monitor: Optional[CriticalPathMonitor] = None
        self._history_stop = threading.Event()
        self._history_thread: Optional[threading.Thread] = None
        if self._lighthouse_addr is not None:
            if os.environ.get(STRAGGLER_MONITOR_ENV, "0") == "1":
                self._fleet_monitor = FleetMonitor(self._lighthouse_addr).start()
            if os.environ.get(REGRESSION_MONITOR_ENV, "0") == "1":
                self._regression_monitor = RegressionMonitor(self._lighthouse_addr)
                self._critical_path_monitor = CriticalPathMonitor(self._lighthouse_addr)
                self._start_history_thread()
        # hang forensics: SIGUSR2 dumps the flight recorder (installable
        # from the main thread only; elsewhere this returns False), and the
        # step watchdog turns a silently wedged step into a watchdog_stall
        # event and a flight dump. It holds _on_stall weakly: its thread
        # never keeps this Manager alive.
        telemetry.install_sigusr2()
        self._watchdog = telemetry.StepWatchdog(on_stall=self._on_stall)
        # the diagnosis plane: the Python stack sampler runs always-on at
        # TORCHFT_PROF_HZ (0 disarms; the native sampler arms itself when
        # its threads register), and with TORCHFT_DIAG_DIR set an engine
        # turns latch events into bounded deep-capture bundles. The engine
        # subscribes to the process-wide trail and holds no reference to
        # this Manager; shutdown() unsubscribes it.
        PROFILER.ensure_started()
        self._diagnosis: Optional[DiagnosisEngine] = None
        if diag_dir():
            self._diagnosis = DiagnosisEngine(
                replica_id=self._replica_id, lighthouse_addr=self._lighthouse_addr,
            ).install()
        # the step a trail event or span of the step now running names:
        # with a pipelined vote in flight, _step lags that step by one
        self._step_label = 0
        telemetry.TRACER.set_context(replica_id=self._replica_id, step=self._step,
                                     quorum_epoch=-1)
        # the crash-durable black box stamps every mirrored record with the
        # same clock-sync-free coordinates the tracer uses
        telemetry.BLACKBOX.set_context(replica_id=self._replica_id, step=self._step,
                                       quorum_epoch=-1)

    def set_state_dict_fns(
        self, load_state_dict: Callable[[T], None], state_dict: Callable[[], T]
    ) -> None:
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict

    def set_heal_warmup(self, fn: Callable[[Any], None]) -> None:
        """Register the heal warm-up: during a heal, ``fn(spec_tree)`` runs
        on a daemon thread as soon as the incoming state's header is known,
        while the bulk bytes still stream. ``spec_tree`` mirrors the state
        dict with ``serialization.TensorSpec`` leaves (a sharded leaf's
        global shape). Best-effort: a failing warm-up never fails the
        heal."""
        self._heal_warmup = fn

    def _heal_header_cb(self, header: bytes) -> None:
        """The transport's header hook (on the quorum thread, mid-receive):
        start the registered warm-up on its own thread, so the receive goes
        on streaming."""
        fn = self._heal_warmup
        if fn is None:
            return

        def run() -> None:
            try:
                from torchft_tpu_torch.checkpointing.serialization import spec_tree_from_header

                fn(spec_tree_from_header(header))
            except Exception:  # noqa: BLE001 — the warm-up is best-effort
                self._logger.exception("heal warmup failed")

        threading.Thread(target=run, daemon=True, name="tft_heal_warmup").start()

    def _start_history_thread(self) -> None:
        """The history plane's poll loop (rank 0, ``TORCHFT_REGRESSION_MONITOR=1``):
        one ``/timeseries.json`` fetch every ``TORCHFT_REGRESSION_POLL_S``
        feeds the regression sentinel and the critical-path monitor, each
        past its own cursor. The loop holds the monitors, never the
        Manager, so a dropped Manager is freed."""
        addr = self._lighthouse_addr
        stop = self._history_stop
        consumers = (self._regression_monitor, self._critical_path_monitor)
        try:
            poll_s = float(os.environ.get(REGRESSION_POLL_ENV, "2.0"))
        except ValueError:
            poll_s = 2.0

        def run() -> None:
            while not stop.wait(poll_s):
                try:
                    reply = timeseries.poll_timeseries(addr)
                    if not reply:
                        continue
                    for monitor in consumers:
                        monitor.poll_once(reply=reply)
                except Exception:  # noqa: BLE001 — monitoring must not die
                    pass

        self._history_thread = threading.Thread(target=run, daemon=True,
                                                name="tft_history_monitor")
        self._history_thread.start()

    def _on_stall(self, step: int, elapsed_s: float, threshold_s: float) -> None:
        """Step-watchdog callback (its thread): the watchdog has emitted
        ``watchdog_stall`` and dumped the flight recorder. A wedged step
        sends no quorum RPC, so its stuck flag would never reach the
        lighthouse: push one heartbeat carrying the full-JSON report
        (rank 0, which knows the lighthouse), on a thread of its own and
        bounded in time. Never through the delta encoder: the quorum
        thread owns it, and a blob out of order would break the chain; the
        lighthouse takes a JSON row whatever the chain's state."""
        self._logger.warn(
            f"step watchdog: step {step} has run {elapsed_s:.3f} s (threshold "
            f"{threshold_s:.3f} s); flight recorder dumped to {telemetry.FLIGHT.dump_dir()}"
        )
        if self._lighthouse_addr is None or self._shutting_down:
            return
        payload = self._telemetry_payload_json()
        if not payload:
            return
        addr, replica_id = self._lighthouse_addr, self._replica_id

        def push() -> None:
            from torchft_tpu_torch.coordination import LighthouseClient

            try:
                client = LighthouseClient(addr, connect_timeout=timedelta(seconds=5))
                try:
                    client.heartbeat(replica_id, timeout=timedelta(seconds=5),
                                     telemetry_payload=payload)
                finally:
                    client.close()
            except Exception:  # noqa: BLE001 — best effort
                pass

        threading.Thread(target=push, daemon=True, name="tft_stall_push").start()

    def _delta_encoder(self) -> fleetdelta.DeltaEncoder:
        """The Manager's one delta encoder (quorum thread only)."""
        if self._tdelta_encoder is None:
            self._tdelta_encoder = fleetdelta.DeltaEncoder()
        return self._tdelta_encoder

    def _telemetry_report(self) -> Dict[str, Any]:
        """The nested report the delta encoder flattens: health scalars,
        the counters digest, the anatomy, the mergeable log2 histograms
        and the time-series samples. Its keys are the vocabulary the
        lighthouse rebuilds ``/cluster.json`` from."""
        report: Dict[str, Any] = {
            "step": self._step,
            "epoch": self._quorum_id,
            "stuck": bool(self._watchdog.stalled),
            "slo_breach": bool(self._slo.breached()),
            "local_step_p50_s": float(telemetry.LEDGER.local_p50() or 0.0),
            "last_heal_ts": float(self._last_heal_ts),
            "summary": telemetry.summary(),
            "anatomy": telemetry.LEDGER.summary(),
            "hist": fleetdelta.collect_hists(),
        }
        report.update(_diag_fields(self))
        series = timeseries.build_series(slo_breach=bool(self._slo.breached()),
                                         stuck=bool(self._watchdog.stalled),
                                         divergence=bool(self._divergence_latched))
        if series:
            report["series"] = series
        return report

    def _telemetry_payload_delta(self) -> Optional[Dict[str, Any]]:
        """The delta piggyback: the report's fields that changed since the
        lighthouse's last ack. Spans ride outside the blob as the lowest
        tier: when blob and spans would pass the cap, the spans are
        requeued for a lighter round."""
        t0 = time.perf_counter()
        try:
            blob = self._delta_encoder().encode(self._telemetry_report())
            payload: Dict[str, Any] = {"tdelta": blob}
            telemetry.TELEMETRY_BYTES.labels(channel="piggyback").inc(len(blob))
            spans = telemetry.TRACER.drain_chrome_fragment()
            if spans:
                if len(blob) + len(spans) <= fleetdelta.max_blob_bytes():
                    payload["spans"] = spans
                    telemetry.TELEMETRY_BYTES.labels(channel="spans").inc(len(spans))
                else:
                    telemetry.TRACER.requeue_last_batch()
            return payload
        except Exception:  # noqa: BLE001 — observability must not fail quorum
            return None
        finally:
            # the plane meters itself: the build and encode are a phase
            telemetry.LEDGER.record("telemetry", time.perf_counter() - t0)

    def _telemetry_payload(self) -> Optional[Dict[str, Any]]:
        """The report piggybacked on the quorum RPC, delta-encoded unless
        ``TORCHFT_TELEMETRY_DELTA=0``; None under
        ``TORCHFT_TELEMETRY_PIGGYBACK=0``. Never fails the quorum."""
        if os.environ.get(PIGGYBACK_ENV, "1") == "0":
            return None
        if fleetdelta.delta_enabled():
            return self._telemetry_payload_delta()
        return self._telemetry_payload_json()

    def _telemetry_payload_json(self) -> Optional[Dict[str, Any]]:
        """The self-contained full-JSON row: the ``TORCHFT_TELEMETRY_DELTA=0``
        piggyback, and the stall push's payload in either mode (the push
        runs on its own thread; the lighthouse's ingest takes either
        format). An anatomy digest past the lighthouse's 64 KiB cap is
        replaced by a ``{"_oversized_bytes": n}`` marker, with one warning
        an episode."""
        import json

        if os.environ.get(PIGGYBACK_ENV, "1") == "0":
            return None
        try:
            anatomy = json.dumps(telemetry.LEDGER.summary(), separators=(",", ":"), default=str)
            if len(anatomy) > ANATOMY_CAP_BYTES:
                if not self._anatomy_oversize_warned:
                    self._anatomy_oversize_warned = True
                    self._logger.warn(
                        f"anatomy digest {len(anatomy)} bytes exceeds the 64KiB piggyback "
                        "cap; sending an oversize marker instead (warned once per episode)"
                    )
                anatomy = json.dumps({"_oversized_bytes": len(anatomy)})
            else:
                self._anatomy_oversize_warned = False
            payload: Dict[str, Any] = {
                "summary": json.dumps(telemetry.summary(), separators=(",", ":"), default=str),
                "anatomy": anatomy,
                "local_step_p50_s": float(telemetry.LEDGER.local_p50() or 0.0),
                "slo_breach": bool(self._slo.breached()),
                "step": self._step,
                "epoch": self._quorum_id,
                "stuck": bool(self._watchdog.stalled),
                "last_heal_ts": float(self._last_heal_ts),
                "spans": telemetry.TRACER.drain_chrome_fragment(),
                **_diag_fields(self),
            }
            series = timeseries.build_series(slo_breach=bool(self._slo.breached()),
                                             stuck=bool(self._watchdog.stalled),
                                             divergence=bool(self._divergence_latched))
            if series:
                payload["series"] = series
            return payload
        except Exception:  # noqa: BLE001 — observability must not fail quorum
            return None

    def _trace_id(self) -> str:
        """Trace identity of the step in flight: replica, step and quorum
        epoch are agreed values, so spans of different replicas for one
        step and epoch correlate without clock sync."""
        return f"{self._replica_id}:{self._step_label}:{self._quorum_id}"

    def shutdown(self, wait: bool = True) -> None:
        """Shut down the manager server, checkpoint transport and data plane."""
        self._shutting_down = True
        self._watchdog.stop()
        if self._diagnosis is not None:
            self._diagnosis.remove()  # the process-wide trail holds it otherwise
        for monitor in (self._fleet_monitor, self._regression_monitor):
            if monitor is not None:
                monitor.stop()
        self._history_stop.set()
        if self._history_thread is not None:
            self._history_thread.join(timeout=5.0)
            self._history_thread = None
        # release a quorum thread parked on the speculation fence
        with self._spec_cond:
            self._pending_commit = None
            self._spec_cond.notify_all()
        self._checkpoint_transport.shutdown(wait=wait)
        if self._manager is not None:
            self._manager.shutdown()
        self._executor.shutdown(wait=wait)
        if self._commit_executor is not None:
            self._commit_executor.shutdown(wait=wait)
        self._collectives.shutdown()
        if self._commit_client is not None:
            self._commit_client.close()
        self._client.close()
        self._store.close()

    # ------------------------------------------------------------------
    # quorum
    # ------------------------------------------------------------------

    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: Optional[timedelta] = None,
    ) -> None:
        """Start this step's quorum on the quorum thread and ready the
        manager for a new step. Call before the forward pass: with async
        quorum the RPC (and a heal's transfer) overlaps compute; with sync
        quorum this waits for it and applies a heal before returning.

        Every replica group must pass the same ``allow_heal``. With
        ``shrink_only`` the quorum can only lose members.

        A sync quorum first resolves a pipelined vote still in flight (so a
        veto rolls back before the forward pass): the main thread would
        otherwise block here while the quorum thread waits on the
        speculation fence for it."""
        if not self._use_async_quorum and self._pending_commit is not None:
            self.resolve_pending_commit()
        if self._heal_trail is not None:
            # with a vote in flight the user's state_dict serves the
            # rollback snapshot: the committed state at current_step
            self._record_commit_trail()
        self._errored = None
        self._healing = False
        self._group_healing = False
        self._step_epochs = set()
        self._step_n = None
        # the step this physical step's trail events and trace ids name:
        # with a pipelined vote still in flight _step lags it by one
        self._step_label = self._step + (1 if self._pending_commit is not None else 0)
        telemetry.TRACER.set_context(replica_id=self._replica_id, step=self._step_label,
                                     quorum_epoch=self._quorum_id)
        telemetry.BLACKBOX.set_context(replica_id=self._replica_id, step=self._step_label,
                                       quorum_epoch=self._quorum_id)
        self._watchdog.arm(self._step_label)
        telemetry.emit("quorum_start", step=self._step_label, allow_heal=allow_heal,
                       shrink_only=shrink_only)
        # the stream that trains: the heal's device work runs on it
        stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        # Replace under the lock, wait outside it. A future is replaced only
        # once it is seen done under the lock, so a death-watch submission
        # is never overwritten unobserved; and the wait must not hold the
        # lock, or an early re-quorum's long-poll would block the death
        # watch's eviction reports for up to the quorum timeout.
        while True:
            with self._qf_lock:
                prev = self._quorum_future
                if prev is None or prev.done():
                    try:
                        exc = prev.exception() if prev is not None else None
                    except concurrent.futures.CancelledError as e:
                        exc = e
                    if exc is not None:
                        # the failure already reached the caller through
                        # wait_quorum/allreduce/should_commit; this call IS
                        # the retry
                        self._logger.warn(f"previous quorum attempt failed ({exc}); retrying")
                    self._last_quorum_args = (allow_heal, shrink_only, timeout)
                    early = self._reusable_early_quorum(prev, exc)
                    self._early_future = None
                    if early is not None:
                        # the death watch's re-quorum delivered this epoch under
                        # the doomed step; members that were between steps took
                        # the same epoch as their next quorum and now wait in
                        # its first op, so asking again would leave them there
                        # until the op timeout (and the quorum formed without
                        # them then repeats the pattern)
                        self._logger.info(
                            f"taking the early re-quorum's quorum_id={early.quorum_id} "
                            f"for this step"
                        )
                        self._quorum_future = self._executor.submit(
                            self._apply_quorum, early, allow_heal, stream
                        )
                    else:
                        self._quorum_future = self._executor.submit(
                            self._async_quorum,
                            pending=self._pending_commit,
                            allow_heal=allow_heal,
                            shrink_only=shrink_only,
                            quorum_timeout=timeout or self._quorum_timeout,
                            stream=stream,
                        )
                    break
            # a previous attempt is in flight: wait it out with the lock
            # released, then look again (a death-watch submission landing
            # in between is seen, not overwritten, on the next pass)
            try:
                prev.result()
            except Exception:  # noqa: BLE001 — reported on the next pass
                pass
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # the forward pass then runs from the received state
                self._apply_pending_state_dict()
                self._healing = False
            # every rank healed before the forward pass: the whole group
            # contributes real gradients
            self._group_healing = False

    def _reusable_early_quorum(self, prev, exc) -> Optional[Any]:
        """The quorum an early re-quorum delivered, when the step about to
        start may take it as its own (call under ``_qf_lock``): the doomed
        step it ran under did not commit (this group retries the step it
        reported), no flush is requested, no vote is in flight, and the
        plane is still on that epoch."""
        if prev is None or prev is not self._early_future or exc is not None:
            return None
        quorum, step = prev.result()
        if (
            self._pending_commit is not None
            or step != self._step
            or self._commit_failures
            or quorum.quorum_id != self._quorum_id
        ):
            return None
        return quorum

    def wait_quorum(self) -> None:
        """Block until the in-flight quorum completes; the data plane is
        configured for the new membership after this returns."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before wait_quorum")
        if self._quorum_future.done():
            self._quorum_future.result()
            return
        # step anatomy: the time the main thread blocked on the quorum (the
        # RPC itself overlaps compute under async quorum; only the tail the
        # trainer waits out is the step's cost)
        t0 = time.perf_counter()
        try:
            self._quorum_future.result()
        finally:
            telemetry.LEDGER.record("quorum_wait", time.perf_counter() - t0)

    def _reported_step(self, pending: Optional[_PendingCommit]) -> int:
        """The step this group reports to the quorum. While a pipelined vote
        is in flight the committed count lags one vote behind a group that
        voted synchronously (a healing or errored step never speculates),
        and the quorum would then heal this group from it, and the other
        from this one at the next step, turn by turn. So the quorum thread
        waits for the vote's decision (not for the main thread to resolve
        it) and reports the step as the decision leaves it."""
        if pending is None or pending.future is None:
            return self._step
        try:
            return pending.step + (1 if pending.future.wait() else 0)
        except Exception:  # noqa: BLE001 — a lost vote restores the snapshot
            return pending.step

    def _async_quorum(
        self,
        pending: Optional[_PendingCommit],
        allow_heal: bool,
        shrink_only: bool,
        quorum_timeout: timedelta,
        stream: Optional["torch.cuda.Stream"] = None,
    ) -> Tuple[Any, int]:
        """One quorum RPC and its application; returns the quorum and the
        step this group reported in it."""
        t_quorum = time.perf_counter()
        step = self._reported_step(pending)
        with telemetry.TRACER.span("quorum", trace_id=self._trace_id(), rank=self._rank) as span:
            try:
                quorum = self._client._quorum(
                    rank=self._rank,
                    step=step,
                    checkpoint_metadata=self._checkpoint_transport.metadata(),
                    shrink_only=shrink_only,
                    timeout=quorum_timeout,
                    # latched data-plane errors request a flush: quorum_id
                    # bumps so every group (healthy ones too) re-rendezvouses
                    commit_failures=self._commit_failures,
                    # this replica's telemetry report, for the lighthouse
                    telemetry_payload=self._telemetry_payload(),
                )
            except BaseException:
                # the drained span batch never reached the lighthouse: keep
                # it for the next report (an outage is what /trace is for)
                telemetry.TRACER.requeue_last_batch()
                raise
            span.set(quorum_id=quorum.quorum_id, heal=quorum.heal)
        # the lighthouse's ack of the delta chain: the next report sends
        # only what changed since, or the full state when it lost the chain
        if quorum.telemetry_ack and self._tdelta_encoder is not None:
            try:
                self._tdelta_encoder.on_ack(quorum.telemetry_ack)
            except Exception:  # noqa: BLE001 — never fail the quorum
                pass
        self._apply_quorum(quorum, allow_heal, stream, t_quorum)
        return quorum, step

    def _apply_quorum(
        self, quorum, allow_heal: bool, stream: Optional["torch.cuda.Stream"] = None,
        t_quorum: Optional[float] = None,
    ) -> None:
        """The quorum thread's use of a delivered quorum: the participant
        ranks, the plane's reconfiguration on a new epoch, and the heal.
        ``t_quorum``: when its RPC started (the trail's duration)."""
        # async quorum overlaps the forward pass, so a healing replica can't
        # contribute this step (its state is in flight): the max-step cohort
        # participates. Sync quorum heals first, so every group does.
        self._participating_rank, self._participating_world_size = (
            (quorum.max_rank, quorum.max_world_size)
            if self._use_async_quorum or not allow_heal
            else (quorum.replica_rank, quorum.replica_world_size)
        )
        # if ANY local rank of this group heals, every rank contributes zeros
        self._group_healing = allow_heal and quorum.group_heal
        if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            # the groups past min_replica_size are spares contributing zeros
            self._participating_world_size = min(
                self._participating_world_size, self._min_replica_size
            )
            if (
                self._participating_rank is not None
                and self._participating_rank >= self._min_replica_size
            ):
                self._participating_rank = None
        with self._evict_lock:
            prev_participants = self._participant_ids
            self._participant_ids = quorum.participant_ids
            self._evicted.clear()

        telemetry.PARTICIPANTS.set(self._participating_world_size)
        # before the first quorum there is no membership: joining is not churn
        if prev_participants and set(quorum.participant_ids) != set(prev_participants):
            telemetry.MEMBERSHIP_CHANGES.inc()
        telemetry.emit(
            "quorum_ready",
            quorum_id=quorum.quorum_id,
            step=self._step_label,
            participants=list(quorum.participant_ids),
            num_participants=self._participating_world_size,
            heal=quorum.heal,
            reconfigure=quorum.quorum_id != self._quorum_id,
            duration_s=round(time.perf_counter() - t_quorum, 4) if t_quorum is not None else 0.0,
        )

        if quorum.quorum_id != self._quorum_id:
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}/{self._rank}"
            )
            self._logger.info(
                f"reconfiguring for quorum_id={quorum.quorum_id} store={store_prefixed_addr}"
            )
            self._collectives.configure(
                store_prefixed_addr, quorum.replica_rank, quorum.replica_world_size
            )
            if hasattr(self._collectives, "plane_generation"):
                # published after configure: a callback from the new ring
                # that races this store is dropped as stale, which is safe
                # (the lease still lapses on its own)
                self._death_watch_snapshot = (
                    self._collectives.plane_generation(),
                    list(quorum.participant_ids),
                )
            self._quorum_id = quorum.quorum_id
            telemetry.TRACER.set_context(quorum_epoch=quorum.quorum_id)
            telemetry.BLACKBOX.set_context(quorum_epoch=quorum.quorum_id)
            telemetry.QUORUM_RECONFIGURES.inc()
            self.step_timer.mark_quorum()
            self._commit_failures = 0  # the flush request has been honored
            if self._rank == 0:
                self._sweep_stale_epochs(quorum.quorum_id)

        if not allow_heal:
            return
        # the heal's device work (copying a served state to the host,
        # placing a transfer on the device plane) runs on the training
        # stream, after the updates (and a rollback) it has enqueued
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            self._heal(quorum)

    def _heal(self, quorum) -> None:
        """The quorum thread's share of a heal: serve this group's state to
        ``recover_dst_ranks`` or as a stripe source, or receive and stage a
        state to heal from."""
        # While anyone heals, every max-step cohort member a healer may
        # contact stages, not only the assigned sources, so the healer can
        # pull a stripe from each. Members past the healer's source cap are
        # never contacted and skip the flatten; a member that cannot find
        # itself in the cohort list stages anyway (an address that reads
        # differently must cost a wasted staging, never an unserved healer).
        limit = heal_sources_limit()
        stage_for_stripes = (
            quorum.heal_pending
            and not quorum.heal
            and quorum.max_rank is not None
            and limit > 1
            and (
                self._manager_addr in quorum.recover_src_addresses[:limit]
                or self._manager_addr not in quorum.recover_src_addresses
            )
        )
        if (
            quorum.recover_dst_ranks or quorum.heal or stage_for_stripes
        ) and not self._await_speculation_settled():
            # a speculative update is still outstanding on the main thread:
            # the state served now would be the snapshot, one update behind
            # the step this quorum reported, and a received state would race
            # the rollback. Skip the heal traffic and fail the step; the
            # next quorum asks for the heal again.
            self.report_error(
                RuntimeError("speculation fence timed out; heal traffic skipped")
            )
            return
        if quorum.recover_dst_ranks or stage_for_stripes:
            self._logger.info(
                f"peers need recovery from us {quorum.recover_dst_ranks}"
                + (" (stripe source)" if stage_for_stripes else "")
            )
            with telemetry.TRACER.span("heal_send", trace_id=self._trace_id(),
                                       dst_ranks=list(quorum.recover_dst_ranks),
                                       step=quorum.max_step):
                self._checkpoint_transport.send_checkpoint(
                    dst_ranks=quorum.recover_dst_ranks,
                    step=quorum.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout,
                )
            telemetry.HEALS_TOTAL.labels(role="send").inc(len(quorum.recover_dst_ranks))
        if quorum.heal:
            self._healing = True
            t_heal = time.perf_counter()
            # the rejoin-to-commit SLO's clock: the next committed vote reads it
            self._rejoin_t0 = t_heal
            telemetry.emit("heal_begin", step=quorum.max_step,
                           src=quorum.recover_src_manager_address)
            self._logger.info(
                f"healing: fetching checkpoint metadata from "
                f"{quorum.recover_src_manager_address} at step {quorum.max_step}"
            )
            if quorum.recover_src_rank is None:
                # a protocol invariant, not a retryable transfer failure
                raise RuntimeError("quorum asked us to heal without naming a source")
            try:
                sources = self._heal_sources(quorum)
                if not sources:
                    raise ConnectionError("no heal source answered the checkpoint-metadata RPC")
                multi = getattr(self._checkpoint_transport, "recv_checkpoint_multi", None)
                # the user state is applied on the main thread; stage it here
                with telemetry.TRACER.span("heal_recv", trace_id=self._trace_id(),
                                           src=quorum.recover_src_manager_address,
                                           sources=len(sources), step=quorum.max_step):
                    if multi is not None:
                        own = self._heal_own_digest()
                        state = multi(
                            [m for _, m in sources],
                            step=quorum.max_step,
                            timeout=self._timeout,
                            since_step=self._step if own is not None else None,
                            own=own,
                            header_cb=self._heal_header_cb,
                        )
                    else:
                        state = self._checkpoint_transport.recv_checkpoint(
                            src_rank=quorum.recover_src_rank,
                            metadata=sources[0][1],
                            step=quorum.max_step,
                            timeout=self._timeout,
                        )
                self._pending_state_dict = cast(Dict[str, object], state)
            except Exception as e:  # noqa: BLE001 — a heal must be retryable
                # the quorum and plane are fine, only the state fetch failed:
                # stay un-healed, latch the error so the step aborts at the
                # commit barrier, and let the next quorum re-request the heal
                self._healing = False
                self._pending_state_dict = None
                self._logger.exception(f"heal transfer failed; retrying next quorum: {e}")
                telemetry.emit("heal_failed", step=quorum.max_step, error=str(e))
                self.report_error(e)
                return
            stats = getattr(self._checkpoint_transport, "last_heal_stats", None)
            if isinstance(stats, dict) and stats:
                self._logger.info(
                    f"healed: mode={stats.get('mode')} nsources={stats.get('nsources')} "
                    f"bytes={stats.get('bytes')} stages={stats.get('stages')}"
                )
            self.load_state_dict(cast(Dict[str, int], self._pending_state_dict["torchft"]))
            self._step = max(self._step, quorum.max_step)
            heal_s = time.perf_counter() - t_heal
            nbytes = getattr(self._checkpoint_transport, "last_recv_bytes", 0)
            if not isinstance(nbytes, int):  # a transport that does not count
                nbytes = 0
            telemetry.HEALS_TOTAL.labels(role="recv").inc()
            telemetry.HEAL_DURATION.observe(heal_s)
            self._last_heal_ts = time.time()
            self.step_timer.mark_heal()
            telemetry.emit(
                "heal_end", step=quorum.max_step, bytes=nbytes, duration_s=round(heal_s, 4),
                **({"heal_stats": stats} if isinstance(stats, dict) and stats else {}),
            )

    def _heal_sources(self, quorum) -> List[Tuple[str, str]]:
        """The striped heal's sources: the lighthouse-named primary first,
        then the rest of the max-step cohort, each resolved to its
        transport's metadata by ``mgr.checkpoint_metadata``, at most
        ``heal_sources_limit()``. A peer whose RPC fails is dropped (it may
        be dying; the stripes would route around it anyway). Returns
        ``[(manager_addr, transport_metadata), ...]``."""
        addrs = [quorum.recover_src_manager_address]
        for a in quorum.recover_src_addresses:
            if a and a not in addrs:
                addrs.append(a)
        addrs = addrs[: heal_sources_limit()]
        found: Dict[str, str] = {}
        lock = threading.Lock()

        def resolve(addr: str) -> None:
            try:
                client = ManagerClient(addr, connect_timeout=self._connect_timeout)
                try:
                    meta = client._checkpoint_metadata(self._rank, timeout=self._timeout)
                finally:
                    client.close()
            except Exception as e:  # noqa: BLE001 — drop the source
                self._logger.warn(f"heal source {addr} metadata fetch failed: {e}")
                return
            with lock:
                found[addr] = meta

        if len(addrs) == 1:
            resolve(addrs[0])
        else:
            threads = [threading.Thread(target=resolve, args=(a,), name="tft_heal_meta")
                       for a in addrs]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        # the primary stays first: every healer derives the same plan
        return [(a, found[a]) for a in addrs if a in found]

    def _record_commit_trail(self) -> None:
        """Record the committed state's per-leaf digests at the current step
        (main thread, at the step boundary: the state here is what a heal
        at this step serves). The flatten copies the state to the host on
        the current stream, after the work that wrote it; it syncs that
        stream only, never the device."""
        assert self._heal_trail is not None
        if self._user_state_dict is None or self._step in self._heal_trail.steps():
            return
        try:
            _header, buffers = flatten_state(self._manager_state_dict())
            self._heal_trail.record(self._step, buffers)
        except Exception:  # noqa: BLE001 — the trail must never fail a step
            self._logger.exception("commit-trail record failed")

    def _heal_own_digest(self) -> Optional[Tuple[List[np.ndarray], str]]:
        """This replica's flattened state and tree digest at its last
        committed step, the differential heal's credentials; None when it
        cannot apply (the feature off, no state callbacks, step 0)."""
        if self._heal_trail is None or self._user_state_dict is None or self._step <= 0:
            return None
        try:
            _header, buffers = flatten_state(self._manager_state_dict())
            return buffers, delta.tree_digest(delta.leaf_digests(buffers))
        except Exception:  # noqa: BLE001 — degrade to a full heal
            self._logger.exception("own-state digest failed")
            return None

    def _sweep_stale_epochs(self, current_qid: int) -> None:
        """Delete rendezvous keys of epochs older than the previous one from
        this group's store (each epoch writes keys nothing else deletes).
        Best effort: a failed sweep never fails the quorum."""
        try:
            for key in self._store.keys("torchft/"):
                if isinstance(key, bytes):
                    key = key.decode()
                parts = key.split("/")
                if len(parts) < 2 or parts[0] != "torchft":
                    continue
                try:
                    qid = int(parts[1])
                except ValueError:
                    continue
                if qid < current_qid - 1:
                    self._store.delete(key)
        except Exception as ex:  # noqa: BLE001 — GC must never fail a step
            self._logger.warn(f"epoch GC failed: {ex}")

    def _apply_pending_state_dict(self) -> None:
        self.wait_quorum()
        if self._pending_state_dict is None or self._load_state_dict is None:
            raise RuntimeError("healing without a staged checkpoint or load_state_dict")
        self._logger.info("applying pending state dict")
        t0 = time.perf_counter()
        self._load_state_dict(cast(T, self._pending_state_dict["user"]))
        dur = time.perf_counter() - t0
        # step anatomy's `heal`: the main thread's share of a heal (the
        # apply; the transfer rides the quorum thread and shows as
        # quorum_wait), also the heal-stage view's `device_put`
        telemetry.LEDGER.record("heal", dur)
        telemetry.LEDGER.record_heal_stage("device_put", dur)
        self._pending_state_dict = None

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def device_data_plane(self) -> bool:
        """True when the collectives move tensors on the device
        (:class:`~torchft_tpu_torch.collectives_device.CollectivesDevice`):
        gradient averaging then skips the host round trip."""
        return bool(getattr(self._collectives, "device_arrays", False))

    def wire_codec(self) -> str:
        """The codec the configured data plane ships large float32
        allreduces with (``"f32"`` = exact). Error feedback turns on
        automatically from it: a lossy wire without residual compensation
        drifts."""
        fn = getattr(self._collectives, "wire_codec", None)
        return fn() if callable(fn) else "f32"

    def allreduce(self, array: Any) -> Future:
        """Fault-tolerant cross-replica-group allreduce of one buffer, scaled
        by ``1 / num_participants()``; see :meth:`allreduce_many`."""
        return self.allreduce_many([array]).then(lambda f: f.value()[0])

    def allreduce_many(self, arrays: List[Any]) -> Future:
        """Fault-tolerant cross-replica-group allreduce, scaled by
        ``1 / num_participants()``: of host buffers (numpy, averaged in
        place), or on the device plane of tensors (averaged on the device
        into new tensors; the caller's are never written).

        On error the future still completes (with the possibly-corrupt
        arrays) and the error is latched — the step fails at the commit
        barrier. Healing replicas contribute zeros so the participants'
        average is unperturbed."""
        if not arrays or self.errored():
            return Future.completed(arrays)
        if self._pending_commit is not None:
            # the previous step's vote is in flight: on a veto these inputs
            # (gradients of speculative params) are garbage, and waiting on
            # the quorum here could deadlock against its speculation fence
            raise RuntimeError(
                "pipelined commit: resolve_pending_commit() before issuing "
                "collectives for the next step"
            )
        self.wait_quorum()
        if self.errored():
            # the quorum thread latched a failure (e.g. a failed heal) during
            # the wait: the step is doomed, don't park in a ring whose peers
            # aborted
            return Future.completed(arrays)
        # the plane epoch this op rides: a death-watch re-quorum can land
        # mid-step, and a step whose ops span two epochs mixes divisors
        self._step_epochs.add(self._quorum_id)
        # the participant count at issue time (the commit accounting uses
        # the same snapshot): an op never spans epochs (configure tears its
        # executor down), so the membership it reduces over is today's
        n_at_issue = self._participating_world_size
        self._step_n = n_at_issue
        # branch on the configured plane, not on the input type: the device
        # plane turns numpy inputs into tensors
        device = self.device_data_plane()
        if not self.is_participating():
            if device:
                arrays = [torch.zeros_like(torch.as_tensor(a)) for a in arrays]
            else:
                for a in arrays:
                    a[...] = 0  # in place: the buffers are bucket views
        # this epoch's rank -> replica map: an op can fail after the next
        # quorum renumbered the ranks, and a PeerGoneError mapped through
        # the new list would accuse an innocent replica
        with self._evict_lock:
            ids_snapshot = list(self._participant_ids)
        epoch = self._quorum_id

        try:
            work = self._collectives.allreduce(arrays, ReduceOp.SUM)

            def normalize(fut: Future) -> List[Any]:
                try:
                    reduced = fut.value()
                except BaseException as e:  # noqa: BLE001 — annotated, re-raised
                    e._tft_participants = ids_snapshot
                    e._tft_epoch = epoch
                    raise
                if n_at_issue > 1:
                    if device:
                        # runs with the issuing stream current (see
                        # collectives_device): one division per tensor
                        reduced = [(t / n_at_issue).to(t.dtype) for t in reduced]
                    else:
                        for a in reduced:
                            np.divide(a, n_at_issue, out=a)
                if self._divergence_sentinel:
                    self._digest_reduced(reduced)
                return reduced

            fut = self.wrap_future(work.get_future().then(normalize), arrays)
            # a death-watch reconfigure that slid in between the epoch read
            # above and the submission shows as a second epoch: vetoed
            self._step_epochs.add(self._quorum_id)
            return fut
        except Exception as e:  # noqa: BLE001 — latch and continue
            self._logger.exception(f"exception in allreduce, skipping remaining: {e}")
            self.report_error(e)
            return Future.completed(arrays)

    def _digest_reduced(self, reduced: List[Any]) -> None:
        """The divergence sentinel's fold of one op's reduced outputs into
        this step's ordered digest list (op thread; ops resolve in issue
        order, so the list is the same in every group that reduced the same
        bytes). Tensors are copied to the host first (the op's stream is
        current here). A digest that fails means no digest this step, never
        a failed op."""
        try:
            bufs = [_tensor_to_host(t) if isinstance(t, torch.Tensor) else np.asarray(t)
                    for t in reduced]
            self._step_digests.append(delta.tree_digest(delta.leaf_digests(bufs)))
        except Exception:  # noqa: BLE001 — the sentinel must not fail the op
            self._logger.exception("divergence digest failed")

    def _note_divergence(self, step: int) -> None:
        """A vote's reply carried the lighthouse's divergence latch: record
        it once a process (the lighthouse's latch never clears, so every
        later vote reports it again)."""
        if self._divergence_latched:
            return
        self._divergence_latched = True
        telemetry.DIVERGENCE_TOTAL.inc()
        telemetry.emit("divergence_detected", step=step, fence=self._divergence_fence)
        self._logger.warn(
            f"divergence sentinel latched at step {step}: post-reduce state digests "
            "disagreed across the cohort"
            + (" (the fence vetoed the commit)" if self._divergence_fence else "")
        )

    def report_error(self, e: Exception) -> None:
        """Latch an error: the current step will not commit and the data
        plane reconfigures on the next quorum. If the error names a dead
        peer (:class:`~torchft_tpu_torch.collectives.PeerGoneError`), its
        replica is reported to the lighthouse for eviction, so the
        re-quorum does not wait out the heartbeat lease."""
        self._errored = e
        # the epoch of the plane that failed: a failed op names the one it
        # was issued on, which a death-watch re-quorum may already have
        # replaced (then the current plane is not suspect, and no flush)
        self._errored_epoch = getattr(e, "_tft_epoch", self._quorum_id)
        self._maybe_evict(e)

    def _on_peer_death(self, ring_rank: int, plane_gen: Optional[int] = None) -> None:
        """Death-watch callback (the collectives' monitor thread): a peer's
        socket closed mid-epoch. Report the eviction now (the lighthouse
        probes the victim first, so a false report is harmless) and, if no
        quorum RPC is in flight, start one: by the time the trainer ends
        the doomed step, the smaller quorum is usually delivered and the
        plane reconfigured.

        ``plane_gen`` tags the ring the rank belongs to: a late POLLHUP
        delivered while ``_async_quorum`` replaces membership would
        otherwise map an old ring rank through the new participant list
        and accuse a live replica."""
        if self._shutting_down:
            return
        snap = self._death_watch_snapshot
        if plane_gen is not None and snap is not None:
            snap_gen, snap_ids = snap
            if plane_gen != snap_gen:
                self._logger.info(
                    f"dropping stale death-watch callback for ring rank "
                    f"{ring_rank} (plane gen {plane_gen} != armed {snap_gen})"
                )
                return
        else:
            snap_ids = None
        err = PeerGoneError(ring_rank, f"death watch: peer {ring_rank} socket closed")
        if snap_ids is not None:
            # map the ring rank through this generation's snapshot, never
            # through whatever _participant_ids holds now
            err._tft_participants = list(snap_ids)
        self._maybe_evict(err)
        with self._qf_lock:
            if self._shutting_down:
                return
            fut = self._quorum_future
            if fut is None or not fut.done():
                # a quorum RPC is in flight; it sees the eviction when the
                # lighthouse forms the quorum
                return
            # re-quorum early only when the surviving members can form a
            # quorum without a restart: otherwise the long-poll would park
            # the trainer's wait_quorum on a quorum that cannot form yet
            with self._evict_lock:
                alive = len([p for p in self._participant_ids if p not in self._evicted])
            if alive < max(1, self._min_replica_size):
                return
            _, shrink_only, timeout = self._last_quorum_args
            self._logger.info(f"death watch: peer {ring_rank} gone; starting early re-quorum")
            # allow_heal=False, and no stream: this quorum only shrinks the
            # membership and rebuilds the plane under the doomed step. A
            # heal here would read the trainer's state on a thread it does
            # not synchronise with; a rejoiner heals at the next
            # start_quorum instead.
            self._quorum_future = self._executor.submit(
                self._async_quorum,
                pending=self._pending_commit,
                allow_heal=False,
                shrink_only=shrink_only,
                quorum_timeout=timeout or self._quorum_timeout,
            )
            self._early_future = self._quorum_future

    def _maybe_evict(self, e: BaseException) -> None:
        """Fire-and-forget eviction report for a PeerGoneError's peer, on a
        daemon thread: the report only saves the lease's wait, so it must
        never block or fail the caller."""
        peer: Optional[int] = None
        participants = None
        seen = 0
        cause: Optional[BaseException] = e
        while cause is not None and seen < 8:  # unwrap chained causes
            if participants is None:
                participants = getattr(cause, "_tft_participants", None)
            peer = getattr(cause, "peer_rank", None)
            if peer is not None:
                break
            cause = cause.__cause__ or cause.__context__
            seen += 1
        with self._evict_lock:
            if participants is None:
                participants = list(self._participant_ids)
            if peer is None or not (0 <= peer < len(participants)):
                return
            victim = participants[peer]
            if victim in self._evicted:
                # reported already this epoch: report_error and the death
                # watch race here for the same victim
                return
            self._evicted.add(victim)
        # the trail's record of the death lives here, where the death
        # watch and a failed op naming the peer converge on one dedup point
        telemetry.PEER_DEATHS.inc()
        telemetry.emit("peer_death", ring_rank=peer, replica=victim, step=self._step)
        threading.Thread(
            target=self._report_eviction, args=(victim,), daemon=True, name="tft_evict"
        ).start()

    def _report_eviction(self, victim: str) -> Optional[bool]:
        """Send one eviction report; returns whether the lighthouse evicted
        ``victim`` (None when the report failed). A fresh client: the
        shared one serialises calls on one socket, so the report would
        otherwise queue behind an in-flight quorum long-poll, the very
        wait eviction exists to skip."""
        try:
            client = ManagerClient(self._manager_addr, connect_timeout=timedelta(seconds=5))
            try:
                evicted = client.evict(victim, timeout=timedelta(seconds=5))
            finally:
                client.close()
        except Exception as ex:  # noqa: BLE001 — best effort
            telemetry.EVICTIONS_REPORTED.labels(result="failed").inc()
            self._logger.warn(f"evict report for {victim} failed: {ex}")
            return None
        telemetry.EVICTIONS_REPORTED.labels(result="evicted" if evicted else "rejected").inc()
        telemetry.emit("eviction", victim=victim, evicted=evicted)
        self._logger.info(f"reported dead peer {victim}: evicted={evicted}")
        return evicted

    def errored(self) -> Optional[Exception]:
        return self._errored

    def wrap_future(
        self, fut: Future, default: Any, timeout: Optional[timedelta] = None
    ) -> Future:
        """Deadline + error-swallowing wrapper: a failure completes the
        future with ``default`` and latches the error on the manager."""
        fut = future_timeout(fut, timeout or self._timeout)

        def callback(f: Future) -> Any:
            try:
                return f.value()
            except Exception as e:  # noqa: BLE001
                self._logger.exception(f"exception in future, skipping remaining: {e}")
                self.report_error(e)
                return default

        out = fut.then(callback)
        self._pending_work.append(out)
        return out

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------

    def commit_pipeline_enabled(self) -> bool:
        """Whether this manager was opted into the pipelined commit."""
        return self._commit_pipeline

    def pending_commit(self) -> Optional[Future]:
        """The in-flight pipelined vote's future, or None (a peek; use
        :meth:`resolve_pending_commit` to consume it)."""
        rec = self._pending_commit
        return rec.future if rec is not None else None

    def speculation_allowed(self) -> bool:
        """Whether the trainer may apply this step's update speculatively
        and vote through :meth:`should_commit_async`: never when the step
        is already doomed (an error latched, too few replicas), and never
        on a healing replica (its heal lands at the commit barrier)."""
        if not self._commit_pipeline or self._quorum_future is None:
            return False
        if self._pending_commit is not None:
            return False  # at most one speculative step outstanding
        self.wait_quorum()
        if self._healing or self._group_healing or self._errored is not None:
            return False
        if len(self._step_epochs) > 1:
            return False  # a mixed-epoch step is vetoed: do not speculate on it
        n = self._step_n if self._step_n is not None else self._participating_world_size
        return n >= self._min_replica_size

    def _await_speculation_settled(self) -> bool:
        """Quorum-thread fence: block (bounded) until no speculative commit
        is outstanding; False if the bound ran out. The main thread resolves
        the vote early in every step; the bound keeps a misbehaving caller
        from wedging the quorum."""
        cap = min(self._timeout.total_seconds(), 10.0)
        with self._spec_cond:
            settled = self._spec_cond.wait_for(
                lambda: self._pending_commit is None or self._shutting_down,
                timeout=cap,
            )
        if not settled:
            self._logger.warn(
                "speculation fence timed out (resolve_pending_commit() is "
                "overdue on the trainer)"
            )
        return settled

    def _prepare_commit(self) -> _PendingCommit:
        """The pre-vote half of the commit barrier: drain the step's pending
        work, land a staged heal, and record what the post-vote accounting
        needs."""
        # the injection window right after the drain's start: a kill here
        # dies with the step's work contributed and the vote not cast
        fault_point("commit.vote", match="prepare", step=self._step)
        t0 = time.perf_counter()
        for work in self._pending_work:
            if self._errored is not None:
                break
            try:
                work.wait()
            except Exception:  # noqa: BLE001 — wrap_future already latched it
                pass
        self._pending_work = []
        if self._healing:
            self._apply_pending_state_dict()

        rec = _PendingCommit()
        rec.step = self._step
        # membership as of the step's ops (issue-time snapshot)
        rec.n_step = self._step_n if self._step_n is not None else self.num_participants()
        rec.enough_replicas = rec.n_step >= self._min_replica_size
        # a step whose ops spanned two plane epochs (a death-watch re-quorum
        # mid-step) mixed divisors. The span is a local observation, but
        # the vote is a global conjunction: one rank's veto aborts the step
        # everywhere
        rec.mixed_epochs = len(self._step_epochs) > 1
        rec.errored = self._errored
        rec.local_vote = (
            rec.enough_replicas and self._errored is None and not rec.mixed_epochs
        )
        # the divergence sentinel: fold the step's per-op digests into one
        # for the vote and clear them for the next step. A step that will
        # not commit cleanly abstains ("-"): it still completes the cohort,
        # so no peer's fence waits on it, but its partial digest never
        # enters the compare (only committing states must agree)
        rec.epoch = self._quorum_id
        if self._divergence_sentinel:
            rec.digest = (delta.tree_digest(self._step_digests)
                          if rec.local_vote and self._step_digests else "-")
        self._step_digests = []
        if self._errored is not None and self._errored_epoch == self._quorum_id:
            # the data plane is suspect: request a flush so the next quorum
            # moves every group to a fresh rendezvous epoch
            self._commit_failures += 1
        rec.prepare_s = time.perf_counter() - t0
        return rec

    def _finish_commit(
        self, rec: _PendingCommit, should_commit: bool, barrier_s: float,
        disallow: bool = True,
    ) -> None:
        """The post-vote half (main thread only): the step counters, the
        trail's commit or abort, the step timer and the anatomy row.
        ``barrier_s``: what the commit cost the main thread."""
        self._watchdog.disarm()
        telemetry.COMMIT_BARRIER.observe(barrier_s)
        self._logger.info(
            f"should_commit={should_commit} enough_replicas={rec.enough_replicas} "
            f"mixed_epochs={rec.mixed_epochs} errored={rec.errored}"
        )
        if disallow:
            # close the checkpoint-serving window: after the commit the
            # staged state is stale
            self._checkpoint_transport.disallow_checkpoint()
        # the trail names the step that ran (before the increment), so every
        # record of one step joins on one value
        if should_commit:
            telemetry.COMMITS_TOTAL.labels(outcome="committed").inc()
            telemetry.emit("commit", step=rec.step, participants=rec.n_step)
            self._step += 1
            self._batches_committed += rec.n_step
            telemetry.CURRENT_STEP.set(self._step)
        else:
            telemetry.COMMITS_TOTAL.labels(outcome="aborted").inc()
            telemetry.emit("abort", step=rec.step, enough_replicas=rec.enough_replicas,
                           mixed_epochs=rec.mixed_epochs,
                           errored=str(rec.errored) if rec.errored else None)
        # quorum and heal steps are tagged outliers: an FT event's cost is
        # read from the trail instead of denting the rolling rate
        dur = self.step_timer.tick()
        if dur is not None and self.step_timer.last_tags:
            telemetry.emit("step_outlier", step=rec.step, duration_s=round(dur, 4),
                           tags=list(self.step_timer.last_tags), committed=should_commit)
        # the barrier joins this step's anatomy row; then the row is closed
        # (idle is the wall clock's residual) and the SLOs see the step's
        # wall and a rejoin's time to its commit
        telemetry.LEDGER.record("commit_barrier", barrier_s)
        row = telemetry.LEDGER.tick(step=rec.step)
        if row is not None:
            self._slo.observe_step(row["wall_s"])
        if should_commit and self._rejoin_t0 is not None:
            self._slo.observe_rejoin(time.perf_counter() - self._rejoin_t0)
            self._rejoin_t0 = None

    def should_commit(self, timeout: Optional[timedelta] = None) -> bool:
        """Per-step commit barrier: True iff every rank in the quorum had a
        clean step. Call after backward; step the optimizer only on True."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before should_commit")
        if self._pending_commit is not None:
            # a stray vote of the previous step (a caller mixing pipelined
            # and sync paths, e.g. a LocalSGD sync): resolve it first
            self.resolve_pending_commit()
        t_commit = time.perf_counter()
        rec = self._prepare_commit()
        with telemetry.TRACER.span("should_commit", trace_id=self._trace_id(),
                                   vote=rec.local_vote) as span:
            should_commit = self._client.should_commit(
                self._rank, rec.step, rec.local_vote, timeout=timeout or self._timeout,
                digest=rec.digest, epoch=rec.epoch, fence=self._divergence_fence,
            )
            span.set(decision=should_commit)
        # getattr: a test double may not carry the flag
        if getattr(self._client, "last_divergence", False) is True:
            self._note_divergence(rec.step)
        self._finish_commit(rec, should_commit, time.perf_counter() - t_commit)
        return should_commit

    def should_commit_async(
        self,
        timeout: Optional[timedelta] = None,
        on_resolved: Optional[Callable[[bool], None]] = None,
    ) -> Future:
        """Pipelined commit barrier: issue this step's vote on the vote
        thread and return at once, so the next step's compute overlaps it.

        The caller applies the update speculatively before this call,
        keeping a rollback snapshot, and calls
        :meth:`resolve_pending_commit` before the next step's collectives
        or commit. ``on_resolved(committed)`` runs on the main thread
        inside that resolution, before the speculation fence lifts: restore
        the snapshot there on a veto. Returns the vote's future."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before should_commit_async")
        if self._pending_commit is not None:
            raise RuntimeError("at most one speculative commit may be outstanding")
        if self._healing:
            raise RuntimeError("a healing replica must not speculate")

        rec = self._prepare_commit()
        rec.on_resolved = on_resolved
        # close the serving window at issue time: the vote resolves after
        # the next step's quorum, which may stage a fresh checkpoint
        self._checkpoint_transport.disallow_checkpoint()
        if self._commit_executor is None:
            self._commit_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="commit_vote"
            )
        if self._commit_client is None:
            self._commit_client = ManagerClient(
                self._manager_addr, connect_timeout=self._connect_timeout
            )
        client = self._commit_client
        vote_timeout = timeout or self._timeout
        trace_id = self._trace_id()

        def vote() -> bool:
            with telemetry.TRACER.span("should_commit", trace_id=trace_id, vote=rec.local_vote,
                                       pipelined=True) as span:
                decision = client.should_commit(self._rank, rec.step, rec.local_vote,
                                                timeout=vote_timeout, digest=rec.digest,
                                                epoch=rec.epoch, fence=self._divergence_fence)
                span.set(decision=decision)
            if getattr(client, "last_divergence", False) is True:
                self._note_divergence(rec.step)
            return decision

        rec.future = run_in_executor(self._commit_executor, vote)
        # publish under the fence lock: the quorum thread reads it to decide
        # whether heal traffic must wait
        with self._spec_cond:
            self._pending_commit = rec
        return rec.future

    def resolve_pending_commit(self, rearm: bool = True) -> Optional[bool]:
        """Resolve the in-flight pipelined vote (main thread only): wait
        for it, count the step, run ``on_resolved`` (which restores the
        snapshot on a veto) and lift the speculation fence. Returns the
        decision, or None when no vote was outstanding. If the vote RPC
        fails, the snapshot is restored (the step counts as not applied, as
        in the sync path, where the error comes before the update) and the
        error is raised.

        ``rearm`` re-arms the step watchdog for the step in flight (the
        vote's accounting disarmed it); pass False after the last step,
        when no step runs and a re-armed watchdog would fire on an idle
        process."""
        rec = self._pending_commit
        if rec is None:
            return None
        t0 = time.perf_counter()
        try:
            decision = rec.future.wait()
        except BaseException as e:  # noqa: BLE001 — restore, then re-raise
            self._rollback(rec, error=e)
            self._lift_fence()
            raise
        # the commit's cost to the main thread: the drain at issue and the
        # wait here, near zero when the next step's compute hid the RPC
        self._finish_commit(rec, decision, rec.prepare_s + time.perf_counter() - t0,
                            disallow=False)
        if not decision:
            self._rollback(rec)
        elif rec.on_resolved is not None:
            try:
                rec.on_resolved(True)
            except Exception:  # noqa: BLE001
                self._logger.exception("on_resolved callback failed")
        self._lift_fence()
        if rearm:
            self._watchdog.arm(self._step_label)
        return decision

    def _lift_fence(self) -> None:
        with self._spec_cond:
            self._pending_commit = None
            self._spec_cond.notify_all()

    def _rollback(self, rec: _PendingCommit, error: Optional[BaseException] = None) -> None:
        """Run the caller's snapshot restore for a vetoed (or lost) vote."""
        telemetry.COMMIT_PIPELINE_ROLLBACKS.inc()
        telemetry.emit("commit_rollback", step=rec.step,
                       errored=str(error) if error is not None else None)
        why = "vetoed" if error is None else f"lost ({error})"
        self._logger.warn(
            f"pipelined commit {why} at step {rec.step}; rolling back the "
            "speculative update"
        )
        if rec.on_resolved is not None:
            try:
                rec.on_resolved(False)
            except Exception:  # noqa: BLE001
                self._logger.exception("rollback callback failed")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        """Restore the manager's progress counters."""
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def _manager_state_dict(self) -> Dict[str, object]:
        if self._user_state_dict is None:
            raise RuntimeError("user state_dict not set")
        return {"user": self._user_state_dict(), "torchft": self.state_dict()}

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def current_step(self) -> int:
        """Committed steps; all participants agree on it."""
        return self._step

    def batches_committed(self) -> int:
        """Batches committed across all replica groups and steps."""
        return self._batches_committed

    def num_participants(self) -> int:
        """Replica groups participating in the current step (0 before the
        first ``start_quorum``)."""
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        return self._participating_world_size

    def participating_rank(self) -> Optional[int]:
        """This group's rank among the participating groups, or None for a
        healing replica and before the first ``start_quorum``."""
        if self._quorum_future is None:
            return None
        self.wait_quorum()
        return self._participating_rank

    def is_participating(self) -> bool:
        """Whether this replica's contributions count this step."""
        if self._quorum_future is None:
            return False
        self.wait_quorum()
        if self._participating_rank is None:
            return False
        return not (self._healing or self._group_healing)
