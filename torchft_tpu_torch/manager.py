"""Manager — the per-replica fault-tolerance runtime, the port's copy of
``torchft_tpu/manager.py`` trimmed to the core protocol:

* ``start_quorum`` runs the quorum RPC on a worker thread so it overlaps
  the forward pass; a new ``quorum_id`` reconfigures the collectives;
* the single-source heal: the quorum thread serves a checkpoint to
  ``recover_dst_ranks`` or receives one when ``quorum.heal``, and stages it
  for the main thread, which applies it at the commit barrier;
* ``allreduce_many`` averages host buffers across replica groups in place;
  healing replicas contribute zeros and the divisor is the issue-time
  participant count, not the world size;
* ``should_commit`` is the per-step commit barrier: drain pending work,
  apply staged state, vote; the optimizer steps only on a unanimous True.

Left out (ROADMAP): telemetry, tracing, the step watchdog, the pipelined
commit, the divergence sentinel, striped / differential heal, eviction
reports from the data plane, and ``WorldSizeMode.FIXED_WITH_SPARES``.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import socket
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, TypeVar, cast

import numpy as np

from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collectives, ReduceOp
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer
from torchft_tpu_torch.futures import Future, future_timeout
from torchft_tpu_torch.store import StoreClient

T = TypeVar("T")

MANAGER_ADDR_KEY: str = "manager/addr"
REPLICA_ID_KEY: str = "manager/replica_id"
MANAGER_PORT_ENV: str = "TORCHFT_MANAGER_PORT"
LIGHTHOUSE_ENV: str = "TORCHFT_LIGHTHOUSE"
STORE_ADDR_ENV: str = "TORCHFT_STORE_ADDR"

__all__ = ["Manager"]


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
        timeout: timedelta = timedelta(seconds=60),
        quorum_timeout: timedelta = timedelta(seconds=60),
        connect_timeout: timedelta = timedelta(seconds=60),
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        port: Optional[int] = None,
        hostname: Optional[str] = None,
        checkpoint_transport: Optional[CheckpointTransport[Dict[str, T]]] = None,
    ) -> None:
        """
        Args:
            collectives: the reconfigurable cross-replica-group collectives
                (unconfigured; the Manager configures it each quorum change)
            load_state_dict / state_dict: user snapshot/restore callbacks for
                live recovery (or later via :meth:`set_state_dict_fns`)
            min_replica_size: minimum replica groups for a step to commit
            timeout: deadline for collectives, commit votes and transfers
            quorum_timeout: deadline for quorum formation
            rank / world_size: this rank within the replica group (env RANK /
                WORLD_SIZE fallback)
            store_addr: ``host:port`` of the group's KV store
                (TORCHFT_STORE_ADDR fallback)
            lighthouse_addr: rank 0 only; TORCHFT_LIGHTHOUSE fallback
            replica_id: rank 0 only; a uuid4 suffix is always appended so a
                restarted group is a distinct lighthouse member
            port: rank-0 manager server port (TORCHFT_MANAGER_PORT fallback,
                else ephemeral)
            checkpoint_transport: defaults to an :class:`HTTPTransport`
                that lands received tensors on the CPU
        """
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        # staged by the quorum thread during a heal, applied on the main
        # thread strictly after wait_quorum()
        self._pending_state_dict: Optional[Dict[str, object]] = None
        self._timeout = timeout
        self._quorum_timeout = quorum_timeout
        self._connect_timeout = connect_timeout
        self._min_replica_size = min_replica_size

        store_addr = store_addr or os.environ[STORE_ADDR_ENV]
        self._rank: int = rank if rank is not None else int(os.environ["RANK"])
        world_size = world_size or int(os.environ["WORLD_SIZE"])

        if checkpoint_transport is None:
            checkpoint_transport = HTTPTransport(timeout=timeout)
        self._checkpoint_transport: CheckpointTransport[Dict[str, T]] = (
            checkpoint_transport
        )
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="async_quorum")
        self._quorum_future: Optional[concurrent.futures.Future] = None

        self._store = StoreClient(store_addr, connect_timeout=connect_timeout)
        self._collectives = collectives
        self._manager: Optional[ManagerServer] = None
        if self._rank == 0:
            if port is None:
                port = int(os.environ.get(MANAGER_PORT_ENV, 0))
            lighthouse_addr = lighthouse_addr or os.environ[LIGHTHOUSE_ENV]
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

        # written by the quorum thread during a heal; wait_quorum() orders
        # those writes before main-thread reads
        self._step = 0
        self._quorum_id = -1
        self._commit_failures = 0  # pending data-plane flush request
        # error latch: any thread may latch, the commit barrier reads it
        # after draining pending work
        self._errored: Optional[Exception] = None
        self._errored_epoch = -1  # quorum_id whose plane produced _errored
        self._step_n: Optional[int] = None  # issue-time participant count
        self._healing = False
        self._group_healing = False
        self._pending_work: List[Future] = []
        self._batches_committed = 0
        self._participating_rank: Optional[int] = None
        self._participating_world_size: int = 0

    def set_state_dict_fns(
        self, load_state_dict: Callable[[T], None], state_dict: Callable[[], T]
    ) -> None:
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict

    def shutdown(self, wait: bool = True) -> None:
        """Shut down the manager server, checkpoint transport and data plane."""
        self._checkpoint_transport.shutdown(wait=wait)
        if self._manager is not None:
            self._manager.shutdown()
        self._executor.shutdown(wait=wait)
        self._collectives.shutdown()
        self._client.close()
        self._store.close()

    # ------------------------------------------------------------------
    # quorum
    # ------------------------------------------------------------------

    def start_quorum(self) -> None:
        """Start this step's quorum on the quorum thread and ready the
        manager for a new step. Call before the forward pass: the RPC (and
        a heal's transfer) overlaps compute."""
        self._errored = None
        self._healing = False
        self._group_healing = False
        self._step_n = None
        prev = self._quorum_future
        if prev is not None:
            try:
                prev.result()
            except Exception as e:  # noqa: BLE001 — surfaced on its own step
                # the failure already reached the caller through
                # wait_quorum/allreduce/should_commit; this call IS the retry
                self._logger.warn(f"previous quorum attempt failed ({e}); retrying")
        self._quorum_future = self._executor.submit(self._async_quorum)

    def wait_quorum(self) -> None:
        """Block until the in-flight quorum completes; the data plane is
        configured for the new membership after this returns."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before wait_quorum")
        self._quorum_future.result()

    def _async_quorum(self) -> None:
        quorum = self._client._quorum(
            rank=self._rank,
            step=self._step,
            checkpoint_metadata=self._checkpoint_transport.metadata(),
            timeout=self._quorum_timeout,
            # latched data-plane errors request a flush: quorum_id bumps so
            # every group (healthy ones too) re-rendezvouses
            commit_failures=self._commit_failures,
        )
        # the quorum overlaps the forward pass, so a healing replica can't
        # contribute this step (its state is in flight): the max-step cohort
        # participates
        self._participating_rank = quorum.max_rank
        self._participating_world_size = quorum.max_world_size
        # if ANY local rank of this group heals, every rank contributes zeros
        self._group_healing = quorum.group_heal

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
            self._quorum_id = quorum.quorum_id
            self._commit_failures = 0  # the flush request has been honored
            if self._rank == 0:
                self._sweep_stale_epochs(quorum.quorum_id)

        if quorum.recover_dst_ranks:
            self._logger.info(f"peers need recovery from us {quorum.recover_dst_ranks}")
            self._checkpoint_transport.send_checkpoint(
                dst_ranks=quorum.recover_dst_ranks,
                step=quorum.max_step,
                state_dict=self._manager_state_dict(),
                timeout=self._timeout,
            )
        if quorum.heal:
            self._healing = True
            self._logger.info(
                f"healing: fetching checkpoint metadata from "
                f"{quorum.recover_src_manager_address} at step {quorum.max_step}"
            )
            if quorum.recover_src_rank is None:
                # a protocol invariant, not a retryable transfer failure
                raise RuntimeError("quorum asked us to heal without naming a source")
            try:
                client = ManagerClient(
                    quorum.recover_src_manager_address,
                    connect_timeout=self._connect_timeout,
                )
                try:
                    metadata = client._checkpoint_metadata(self._rank, timeout=self._timeout)
                finally:
                    client.close()
                # the user state is applied on the main thread; stage it here
                self._pending_state_dict = cast(
                    Dict[str, object],
                    self._checkpoint_transport.recv_checkpoint(
                        src_rank=quorum.recover_src_rank,
                        metadata=metadata,
                        step=quorum.max_step,
                        timeout=self._timeout,
                    ),
                )
            except Exception as e:  # noqa: BLE001 — a heal must be retryable
                # the quorum and plane are fine, only the state fetch failed:
                # stay un-healed, latch the error so the step aborts at the
                # commit barrier, and let the next quorum re-request the heal
                self._healing = False
                self._pending_state_dict = None
                self._logger.exception(f"heal transfer failed; retrying next quorum: {e}")
                self.report_error(e)
                return
            self.load_state_dict(cast(Dict[str, int], self._pending_state_dict["torchft"]))
            self._step = max(self._step, quorum.max_step)

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
        self._load_state_dict(cast(T, self._pending_state_dict["user"]))
        self._pending_state_dict = None

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def allreduce_many(self, arrays: List[np.ndarray]) -> Future:
        """Fault-tolerant cross-replica-group allreduce of host buffers
        (numpy, averaged in place), scaled by ``1 / num_participants()``.

        On error the future still completes (with the possibly-corrupt
        arrays) and the error is latched — the step fails at the commit
        barrier. Healing replicas contribute zeros so the participants'
        average is unperturbed."""
        if not arrays or self.errored():
            return Future.completed(arrays)
        self.wait_quorum()
        if self.errored():
            # the quorum thread latched a failure (e.g. a failed heal) during
            # the wait: the step is doomed, don't park in a ring whose peers
            # aborted
            return Future.completed(arrays)
        # the participant count at issue time (the commit accounting uses
        # the same snapshot)
        n_at_issue = self._participating_world_size
        self._step_n = n_at_issue
        if not self.is_participating():
            for a in arrays:
                a[...] = 0  # in place: the buffers are bucket views

        try:
            work = self._collectives.allreduce(arrays, ReduceOp.SUM)

            def normalize(fut: Future) -> List[np.ndarray]:
                reduced = fut.value()
                if n_at_issue > 1:
                    for a in reduced:
                        np.divide(a, n_at_issue, out=a)
                return reduced

            return self.wrap_future(work.get_future().then(normalize), arrays)
        except Exception as e:  # noqa: BLE001 — latch and continue
            self._logger.exception(f"exception in allreduce, skipping remaining: {e}")
            self.report_error(e)
            return Future.completed(arrays)

    def report_error(self, e: Exception) -> None:
        """Latch an error: the current step will not commit and the data
        plane reconfigures on the next quorum."""
        self._errored = e
        self._errored_epoch = self._quorum_id

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

    def should_commit(self, timeout: Optional[timedelta] = None) -> bool:
        """Per-step commit barrier: True iff every rank in the quorum had a
        clean step. Call after backward; step the optimizer only on True."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before should_commit")
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

        # membership as of the step's ops (issue-time snapshot)
        n_step = self._step_n if self._step_n is not None else self.num_participants()
        enough_replicas = n_step >= self._min_replica_size
        local_vote = enough_replicas and self._errored is None
        if self._errored is not None and self._errored_epoch == self._quorum_id:
            # the data plane is suspect: request a flush so the next quorum
            # moves every group to a fresh rendezvous epoch
            self._commit_failures += 1

        should_commit = self._client.should_commit(
            self._rank, self._step, local_vote, timeout=timeout or self._timeout
        )
        self._logger.info(
            f"should_commit={should_commit} enough_replicas={enough_replicas} "
            f"errored={self._errored}"
        )
        # close the checkpoint-serving window: after the commit the staged
        # state is stale
        self._checkpoint_transport.disallow_checkpoint()
        if should_commit:
            self._step += 1
            self._batches_committed += n_step
        return should_commit

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

    def num_participants(self) -> int:
        """Replica groups participating in the current step (0 before the
        first ``start_quorum``)."""
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        return self._participating_world_size

    def is_participating(self) -> bool:
        """Whether this replica's contributions count this step."""
        if self._quorum_future is None:
            return False
        self.wait_quorum()
        if self._participating_rank is None:
            return False
        return not (self._healing or self._group_healing)
