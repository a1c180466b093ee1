"""The death path of the port against the JAX package's: the collectives'
death watch, the eviction reports, the early re-quorum and the
mixed-epoch commit veto.

Each case runs one script on both packages and compares their answers:

* the data plane: a rank vanishing mid-allreduce gives ``PeerGoneError``
  naming ring rank 1 (the TCP case of ``tests/test_collectives.py``'s
  attribution test; the port has no CMA), and the death watch calls
  ``cb(rank, gen)`` once when a peer's socket closes and never for a
  generation a reconfigure retired;
* the Manager, with a patched ``ManagerClient`` (the harness of
  ``tests/test_manager.py``): the local votes of a step whose ops spanned
  two epochs and of one that did not, a stale death-watch callback
  dropped, a failed op's peer evicted through the op's own participant
  snapshot, the early re-quorum's alive-count gate, and the step after an
  early re-quorum (the port takes its quorum where the JAX Manager asks
  again: the one answer that differs, ROADMAP queue 3);
* three threaded groups with one straggler (a real lighthouse, the TCP
  plane, numpy state): no step fails on the port, two groups abort on
  the op timeout on the JAX package;
* the eviction guards against a real lighthouse
  (``tests/test_coordination.py``'s ``TestEviction``), on both packages'
  clients;
* the slice as a whole (the thread harness of
  ``tests/test_torch_ft_slice.py``): two groups train the tiny
  transformer, group 1's collectives and manager server shut down
  abruptly mid-step, the survivor carries on alone, and a fresh group 1
  joins and heals. The survivor's (step, committed, issue-time
  participants) sequence equals the JAX package's under the same script,
  its losses agree within rtol 1e-4 (float32 throughout), the healed
  group's params equal the survivor's bit for bit, and the survivor's
  eviction report comes back accepted. The lighthouse's lease is 20 s
  there, so a blackout below it shows that eviction ended it.
"""

import ast
import hashlib
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from types import SimpleNamespace
from typing import List
from unittest.mock import patch

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.models import transformer as J
from torchft_tpu_torch.collectives import Collectives, CollectivesTcp, PeerGoneError, ReduceOp, Work
from torchft_tpu_torch.manager import MANAGER_ADDR_KEY, REPLICA_ID_KEY, Manager
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves


def _package(name):
    """The classes one script needs, from the port or the JAX package."""
    if name == "port":
        from torchft_tpu_torch import coordination, manager, store

        return SimpleNamespace(
            CollectivesTcp=CollectivesTcp, PeerGoneError=PeerGoneError,
            LighthouseServer=coordination.LighthouseServer,
            LighthouseClient=coordination.LighthouseClient,
            ManagerServer=coordination.ManagerServer,
            ManagerClient=coordination.ManagerClient,
            QuorumResult=coordination.QuorumResult, StoreServer=store.StoreServer,
            StoreClient=store.StoreClient, Manager=manager.Manager,
            manager_module="torchft_tpu_torch.manager",
        )
    from torchft_tpu import collectives, coordination, manager, store

    return SimpleNamespace(
        CollectivesTcp=collectives.CollectivesTcp, PeerGoneError=collectives.PeerGoneError,
        LighthouseServer=coordination.LighthouseServer,
        LighthouseClient=coordination.LighthouseClient,
        ManagerServer=coordination.ManagerServer,
        ManagerClient=coordination.ManagerClient,
        QuorumResult=coordination.QuorumResult, StoreServer=store.StoreServer,
        StoreClient=store.StoreClient, Manager=manager.Manager,
        manager_module="torchft_tpu.manager",
    )


PACKAGES = ("port", "jax")
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


# ---------------------------------------------------------------------------
# the data plane
# ---------------------------------------------------------------------------


def _attribution(pkg):
    """``tests/test_collectives.py::test_peer_death_attribution`` on ``pkg``:
    rank 1 returns at once (its shutdown closes its sockets) while rank 0
    runs a 4 MB allreduce."""
    server = pkg.StoreServer()
    colls = [pkg.CollectivesTcp(timeout=timedelta(seconds=10), hostname="localhost",
                                native_plane=True)
             for _ in range(2)]

    def fn(rank):
        colls[rank].configure(f"{server.address()}/pd", rank, 2)
        try:
            if rank == 1:
                return "died"
            a = np.ones(1 << 20, dtype=np.float32)
            try:
                colls[0].allreduce([a], ReduceOp.SUM).wait(timedelta(seconds=15))
                return "completed"
            except pkg.PeerGoneError as e:
                return ("gone", e.peer_rank)
            except Exception as e:  # noqa: BLE001
                return ("other", type(e).__name__, str(e)[:100])
        finally:
            colls[rank].shutdown()

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return list(ex.map(fn, range(2)))
    finally:
        server.shutdown()


def test_peer_death_attribution(monkeypatch):
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")  # the JAX package's TCP case
    port, ref = _attribution(_package("port")), _attribution(_package("jax"))
    assert port == [("gone", 1), "died"], port
    assert port == ref


def _configure_pair(colls, prefix):
    with ThreadPoolExecutor(max_workers=2) as ex:
        list(ex.map(lambda r: colls[r].configure(prefix, r, 2), range(2)))


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)


def _death_watch_script(pkg):
    """Rank 0 watches. First a peer shuts down: one callback with the armed
    generation. Then rank 0 leaves that epoch (a reconfigure alone) before
    the peer shuts down: no callback."""
    server = pkg.StoreServer()
    make = lambda: pkg.CollectivesTcp(timeout=timedelta(seconds=10), hostname="localhost",
                                native_plane=True)
    got: List[tuple] = []
    c0, c1 = make(), make()
    c0.set_death_watch(lambda rank, gen: got.append((rank, gen)))
    try:
        _configure_pair([c0, c1], f"{server.address()}/dw1")
        armed = c0.plane_generation()
        c1.shutdown()
        _wait_for(lambda: got)
        time.sleep(0.3)  # a second callback for the same rank would land here
        first = [(rank, gen == armed) for rank, gen in got]
        got.clear()
        c1 = make()
        _configure_pair([c0, c1], f"{server.address()}/dw2")
        c0.configure(f"{server.address()}/dw3", 0, 1)  # retires the dw2 watch
        c1.shutdown()
        time.sleep(0.3)
        return first, list(got)
    finally:
        c0.shutdown()
        c1.shutdown()
        server.shutdown()


def test_death_watch_fires_once_and_not_for_a_stale_generation():
    port, ref = _death_watch_script(_package("port")), _death_watch_script(_package("jax"))
    assert port == ([(1, True)], []), port
    assert port == ref


def _teardown_script(pkg):
    """Configure a pair with a death watch bound to an owner (as the Manager
    binds its own), shut both down: returns whether the owner outlived
    them and the acceptor threads still parked."""
    import gc
    import weakref

    class Owner:
        def on_death(self, rank, gen):
            pass

    server = pkg.StoreServer()
    colls = [pkg.CollectivesTcp(timeout=timedelta(seconds=10), hostname="localhost",
                                native_plane=True)
             for _ in range(2)]
    owner = Owner()
    ref = weakref.ref(owner)
    colls[0].set_death_watch(owner.on_death)
    before = {t.ident for t in threading.enumerate() if t.name == "tft_accept"}
    try:
        _configure_pair(colls, f"{server.address()}/td")
    finally:
        for c in colls:
            c.shutdown()
        server.shutdown()
    del owner, colls
    _wait_for(lambda: not [t for t in threading.enumerate()
                           if t.name == "tft_accept" and t.ident not in before], 2.0)
    gc.collect()
    parked = [t for t in threading.enumerate() if t.name == "tft_accept" and t.ident not in before]
    return ref() is not None, len(parked)


def test_teardown_wakes_the_acceptor_and_frees_the_watcher():
    """The port's teardown shuts its listener down, so the acceptor leaves
    accept() and nothing keeps the plane, or the Manager its death watch
    calls, alive. (The JAX package's teardown only closes the listener:
    its acceptors stay parked and hold both; ROADMAP queue 3.)"""
    assert _teardown_script(_package("port")) == (False, 0)


def _never_joined_script(pkg):
    """Ranks 0 and 1 of a three-rank epoch configure their plane with a
    death watch; rank 2, counted in the quorum but dead before it joined,
    never does. Returns each survivor's error, the death watch's calls, and
    whether the survivors waited out the 1 s op timeout."""
    server = pkg.StoreServer()
    colls = [pkg.CollectivesTcp(timeout=timedelta(seconds=1), hostname="localhost",
                                native_plane=True)
             for _ in range(2)]
    got: List[tuple] = []
    for c in colls:
        c.set_death_watch(lambda rank, gen: got.append((rank, gen)))

    def join(rank):
        try:
            colls[rank].configure(f"{server.address()}/nj", rank, 3)
        except Exception as e:  # noqa: BLE001 - the error is the answer
            return f"{type(e).__name__}: {e}"
        return None

    t0 = time.monotonic()
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            errors = list(ex.map(join, range(2)))
        waited = time.monotonic() - t0
        time.sleep(0.3)  # a late death-watch call would land here
        return errors, list(got), waited >= 1.0
    finally:
        for c in colls:
            c.shutdown()
        server.shutdown()


def test_member_dead_before_the_plane_joins_waits_out_the_op_timeout():
    """An open fault of both packages (ROADMAP queue 3), held as it stands:
    a member that dies after the lighthouse counted it in a new epoch (its
    quorum request in, its lease still running) but before it joined that
    epoch's plane leaves no socket to close, so the death watch never
    fires, no eviction is reported, and the survivors wait for it until
    the op timeout. The recovery harness's kill waits for a step of every
    group so that its rows do not land here. When it is repaired, this
    test changes with it."""
    port, ref = _never_joined_script(_package("port")), _never_joined_script(_package("jax"))
    assert port == (["TimeoutError: peers never connected: [2]"] * 2, [], True), port
    assert port == ref


# ---------------------------------------------------------------------------
# the Manager, with a patched ManagerClient
# ---------------------------------------------------------------------------


class _DummyCollectives(Collectives):
    """One group's data plane: every op completes at once, unchanged, or
    fails with ``fail`` (an exception) when it is set."""

    def __init__(self) -> None:
        self.fail = None

    def configure(self, store_addr, rank, world_size):
        pass

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return Work.failed(self.fail) if self.fail is not None else Work.completed(arrays)

    def allgather(self, arr):
        return Work.completed([arr.copy()])

    def broadcast(self, arr, root=0):
        return Work.completed(arr)

    def reduce_scatter(self, arrays, op=ReduceOp.SUM):
        return Work.completed(arrays[0].copy())

    def alltoall(self, arrays):
        return Work.completed([a.copy() for a in arrays])

    def send(self, arr, dst, tag=0):
        return Work.completed()

    def recv(self, arr, src, tag=0):
        return Work.completed(arr)

    def barrier(self):
        return Work.completed()

    def size(self):
        return 1

    def rank(self):
        return 0


def _jax_failing_plane():
    """The JAX package's dummy plane with the same ``fail`` switch."""
    from torchft_tpu.collectives import CollectivesDummy, Work as JWork

    class Failing(CollectivesDummy):
        fail = None

        def allreduce(self, arrays, op=None):
            return JWork.failed(self.fail) if self.fail is not None else JWork.completed(arrays)

    return Failing(rank=0, world_size=1)


class _Harness:
    """One Manager (rank 1 of a group of 2) with a patched ManagerClient, a
    mock checkpoint transport and a dummy data plane, on either package."""

    def __init__(self, name, store_server, **kwargs):
        from unittest.mock import MagicMock

        self.pkg = _package(name)
        self.store = self.pkg.StoreClient(store_server.address())
        self.store.set(MANAGER_ADDR_KEY, "dummy")
        self.store.set(REPLICA_ID_KEY, "dummy_id")
        self.collectives = _DummyCollectives() if name == "port" else _jax_failing_plane()
        transport = MagicMock()
        transport.metadata.return_value = "transport_meta"
        kwargs.setdefault("min_replica_size", 2)
        kwargs.setdefault("timeout", timedelta(seconds=10))
        self._patcher = patch(f"{self.pkg.manager_module}.ManagerClient", autospec=True)
        self._patcher.start()
        self.manager = self.pkg.Manager(
            collectives=self.collectives, load_state_dict=MagicMock(),
            state_dict=lambda: {"user_key": 1}, rank=1, world_size=2,
            store_addr=store_server.address(), checkpoint_transport=transport, **kwargs,
        )
        self.client = self.manager._client

    def quorum(self, participant_ids=("rep_a", "rep_b"), **kw):
        q = self.pkg.QuorumResult()
        q.quorum_id, q.replica_rank, q.replica_world_size = 123, 1, 2
        q.recover_src_manager_address, q.recover_dst_ranks = "manager address", []
        q.store_address, q.max_step = "store_addr/prefix", 20
        q.max_rank, q.max_world_size, q.heal = 1, 2, False
        q.participant_ids = list(participant_ids)
        for k, v in kw.items():
            setattr(q, k, v)
        self.client._quorum.return_value = q

    def shutdown(self):
        self.manager.shutdown(wait=False)
        self._patcher.stop()
        self.store.close()


@pytest.fixture
def harnesses():
    server = StoreServer()
    made = []

    def make(**kwargs):
        pair = {name: _Harness(name, server, **kwargs) for name in PACKAGES}
        made.extend(pair.values())
        return pair

    yield make
    for h in made:
        h.shutdown()
    server.shutdown()


def _reduce(m):
    m.allreduce_many([np.ones(2, dtype=np.float32)]).wait()


def _mixed_epoch_script(h):
    """``tests/test_manager.py::test_mixed_epoch_span_on_one_rank_vetoes_group_wide``:
    a death-watch re-quorum lands between this rank's ops; the next step
    sees one epoch. Returns (epochs spanned, decision, local vote) per step."""
    m = h.manager
    h.quorum()
    h.client.should_commit.return_value = False  # the group's AND
    out = []
    for mid_step_epoch in (True, False):
        m.start_quorum()
        _reduce(m)
        if mid_step_epoch:
            m._quorum_id = 124
        _reduce(m)
        decision = m.should_commit()
        out.append((len(m._step_epochs), decision, h.client.should_commit.call_args.args[2]))
    return out


def test_mixed_epoch_span_on_one_rank_vetoes_group_wide(harnesses):
    got = {name: _mixed_epoch_script(h) for name, h in harnesses().items()}
    assert got["port"] == [(2, False, False), (1, False, True)], got
    assert got["port"] == got["jax"]


def _stale_script(h):
    """``tests/test_manager.py::test_stale_death_watch_callback_dropped``."""
    m = h.manager
    m._death_watch_snapshot = (5, ["rep_a", "rep_b"])
    m._participant_ids = ["rep_x", "rep_y"]  # membership already replaced
    m._on_peer_death(1, plane_gen=4)  # a retired generation: dropped
    stale = set(m._evicted)
    m._on_peer_death(1, plane_gen=5)  # the armed one: maps through its snapshot
    return stale, set(m._evicted)


def test_stale_death_watch_callback_dropped(harnesses):
    got = {name: _stale_script(h) for name, h in harnesses().items()}
    assert got["port"] == (set(), {"rep_b"}), got
    assert got["port"] == got["jax"]


def _failed_op_script(h):
    """An op fails after the quorum renumbered the ranks: the peer is named
    through the op's own participant snapshot, and the step votes False."""
    m = h.manager
    h.quorum(participant_ids=("rep_a", "rep_b"))
    h.client.should_commit.side_effect = lambda rank, step, vote, **kw: vote
    m.start_quorum()
    m.wait_quorum()
    h.collectives.fail = h.pkg.PeerGoneError(1, "peer 1 died mid-op")
    fut = m.allreduce_many([np.ones(2, dtype=np.float32)])
    m._participant_ids = ["rep_x", "rep_y"]  # a later quorum's membership
    fut.wait()
    h.collectives.fail = None
    return set(m._evicted), m.should_commit(), h.client.should_commit.call_args.args[2]


def test_failed_op_evicts_its_peer_and_vetoes(harnesses):
    got = {name: _failed_op_script(h) for name, h in harnesses().items()}
    assert got["port"] == ({"rep_b"}, False, False), got
    assert got["port"] == got["jax"]


def _early_requorum_script(h):
    """The death watch starts an early re-quorum only when the live members
    can form one: returns the quorum RPCs made by then."""
    m = h.manager
    h.quorum(participant_ids=("rep_a", "rep_b"))
    m.start_quorum()
    m.wait_quorum()
    m._on_peer_death(0)
    m.wait_quorum()
    return h.client._quorum.call_count


@pytest.mark.parametrize("min_replica_size", [1, 2])
def test_early_requorum_alive_gate(harnesses, min_replica_size):
    got = {name: _early_requorum_script(h)
           for name, h in harnesses(min_replica_size=min_replica_size).items()}
    # one live member: it re-quorums at once with min 1, never with min 2
    assert got["port"] == (2 if min_replica_size == 1 else 1), got
    assert got["port"] == got["jax"]


def _early_reuse_script(h, doomed_commits):
    """The death watch's re-quorum delivers epoch 124 under a step issued
    on 123. Returns the step's decision, the quorum RPCs made once the next
    step's quorum is in, the plane's epoch and the flush requests."""
    m = h.manager
    h.quorum(quorum_id=123)
    h.client.should_commit.side_effect = lambda rank, step, vote, **kw: vote
    m.start_quorum()
    m.wait_quorum()
    if not doomed_commits:
        h.collectives.fail = h.pkg.PeerGoneError(0, "peer 0 died mid-op")
    _reduce(m)
    h.collectives.fail = None
    h.quorum(quorum_id=124)
    m._on_peer_death(0)
    m.wait_quorum()
    committed = m.should_commit()
    m.start_quorum()
    m.wait_quorum()
    return committed, h.client._quorum.call_count, m._quorum_id, m._commit_failures


@pytest.mark.parametrize("doomed_commits", [False, True], ids=["aborted", "committed"])
def test_step_after_an_early_requorum_takes_its_quorum(harnesses, doomed_commits):
    """When the step under the early re-quorum did not commit, the port's
    next step takes that quorum as its own, with no second RPC: a member
    that was between steps took the same epoch as its next quorum and waits
    in its first op, and a second request would leave it there until the op
    timeout. The failed op's epoch (123), not the plane's (124), decides
    that no flush is due. A step that committed asks again, as the JAX
    Manager always does (ROADMAP queue 3)."""
    got = {name: _early_reuse_script(h, doomed_commits)
           for name, h in harnesses(min_replica_size=1).items()}
    if doomed_commits:
        assert got["port"] == (True, 3, 124, 0), got
        assert got["port"] == got["jax"]
    else:
        assert got["port"] == (False, 2, 124, 0), got
        assert got["jax"] == (False, 3, 124, 0), got


STRAGGLE_AT, STRAGGLE_S, STEP_S, END = 2, 0.6, 0.05, 6
STRAGGLER_TIMEOUT = timedelta(seconds=5)


def _straggler_script(pkg):
    """Three groups as threads on the TCP plane step numpy state, with a
    real lighthouse (join timeout 100 ms). Each step asks for its quorum,
    computes for ``STEP_S`` and averages. After its commit of step
    ``STRAGGLE_AT`` group 2 waits ``STRAGGLE_S`` before asking again, so
    groups 0 and 1 form a quorum without it; their teardown of the old
    epoch fires group 2's death watch, whose early re-quorum waits at the
    lighthouse until 0 and 1 ask for their next step. The step stays below
    the join timeout: with a longer one, a request left waiting through a
    whole step lets the next quorum form at the first arrival after it, on
    either package, and one group is left out of every quorum in turn.
    Returns each group's aborted steps (step, error), its quorum RPCs, its
    step and its state."""
    lighthouse = pkg.LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=100)
    started = threading.Barrier(3, timeout=60)
    out, errors = {}, []

    def group(gid):
        store = pkg.StoreServer()
        kwargs = {}
        if pkg.manager_module.startswith("torchft_tpu_torch"):
            from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

            kwargs["checkpoint_transport"] = HTTPTransport(timeout=STRAGGLER_TIMEOUT,
                                                           hostname="localhost")
        m = pkg.Manager(
            collectives=pkg.CollectivesTcp(timeout=STRAGGLER_TIMEOUT, native_plane=True), load_state_dict=None,
            state_dict=None, min_replica_size=1, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=STRAGGLER_TIMEOUT, **kwargs,
        )
        st = {"w": np.zeros(4, np.float32)}
        m.set_state_dict_fns(lambda state: st.update(w=np.array(state["w"])),
                             lambda: {"w": st["w"].copy()})
        rpcs = m._client._quorum
        calls = []

        def counted(*args, **kwargs):
            calls.append(m.current_step())
            return rpcs(*args, **kwargs)

        m._client._quorum = counted
        aborted = []
        try:
            started.wait()
            time.sleep(0.5)  # every heartbeat reaches the lighthouse first
            straggled = False
            while True:
                m.start_quorum()
                time.sleep(STEP_S)
                (g,) = m.allreduce_many([np.full(4, gid + 1.0, np.float32)]).wait()
                committed = m.should_commit()
                if committed:
                    st["w"] += g
                else:
                    aborted.append((m.current_step(), str(m.errored())[:80]))
                if committed and m.current_step() >= END and m.num_participants() == 3:
                    break
                if gid == 2 and not straggled and m.current_step() >= STRAGGLE_AT:
                    straggled = True
                    time.sleep(STRAGGLE_S)
            out[gid] = dict(aborted=aborted, rpcs=len(calls), step=m.current_step(),
                            w=st["w"].tolist())
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
        finally:
            m.shutdown(wait=False)
            store.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(3)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        lighthouse.shutdown()
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    return out


def test_straggler_rejoins_without_an_op_timeout():
    """A straggler left out of one quorum rejoins at the next without
    failing a step: the port's group 2 takes its early re-quorum's answer
    as its next quorum. Under the same script the JAX package's group 2
    asks again while 0 and 1 wait for it in the new epoch's average, which
    then fails on its op timeout (ROADMAP queue 3). Under load that
    pattern repeated every op timeout, a quorum forming without whichever
    group was still in the failed average."""
    port = _straggler_script(_package("port"))
    assert all(port[g]["aborted"] == [] for g in range(3)), port
    assert len({tuple(port[g]["w"]) for g in range(3)}) == 1, port
    # the JAX package's plane leaves an acceptor thread parked for every
    # epoch (ROADMAP queue 3): its run goes in a process of its own, so the
    # threads do not outlive it in the test process
    code = ("import test_torch_death_path as t; "
            "print(repr(t._straggler_script(t._package('jax'))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert ref[0]["aborted"] and ref[1]["aborted"], ref


# ---------------------------------------------------------------------------
# the eviction guards, against a real lighthouse
# ---------------------------------------------------------------------------


def _quorum_all(pkg, lh, mgrs):
    """One quorum of every manager. Each member heartbeats first, so the
    lighthouse waits for all of them: a request that lands before a slow
    member's first heartbeat would otherwise form a quorum without it."""
    c = pkg.LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
    for i in range(len(mgrs)):
        c.heartbeat(f"rep_{i}")
    c.close()
    results = [None] * len(mgrs)

    def run(i):
        c = pkg.ManagerClient(mgrs[i].address(), connect_timeout=timedelta(seconds=10))
        results[i] = c._quorum(rank=0, step=1, checkpoint_metadata="", shrink_only=False,
                               timeout=timedelta(seconds=10))
        c.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(mgrs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(not t.is_alive() for t in threads)
    return results


def _managers(pkg, lh, n):
    return [pkg.ManagerServer(replica_id=f"rep_{i}", lighthouse_addr=lh.address(),
                              hostname="localhost", bind="[::]:0", store_addr=f"s{i}",
                              world_size=1) for i in range(n)]


@pytest.mark.parametrize("name", PACKAGES)
def test_false_report_does_not_evict_live_peer(name):
    pkg = _package(name)
    lh = pkg.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    mgrs = _managers(pkg, lh, 2)
    try:
        _quorum_all(pkg, lh, mgrs)
        c = pkg.LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
        # rep_1 is alive and listening: the probe succeeds, the report is a no-op
        assert c.evict("rep_0", "rep_1") is False
        res = _quorum_all(pkg, lh, mgrs)
        assert res[0].replica_world_size == 2
        assert sorted(res[0].participant_ids) == ["rep_0", "rep_1"]
        c.close()
    finally:
        for m in mgrs:
            m.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("name", PACKAGES)
def test_dead_peer_evicted_without_lease_wait(name):
    pkg = _package(name)
    # a 60 s lease and join timeout: only eviction explains a quick quorum
    # without the victim
    lh = pkg.LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=60000,
                              heartbeat_timeout_ms=60000)
    mgrs = _managers(pkg, lh, 2)
    try:
        _quorum_all(pkg, lh, mgrs)
        mgrs[1].shutdown()  # a SIGKILL's stand-in: the socket is gone, no goodbye
        c = pkg.LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
        t0 = time.monotonic()
        assert c.evict("rep_0", "rep_1") is True
        mc = pkg.ManagerClient(mgrs[0].address(), connect_timeout=timedelta(seconds=10))
        r = mc._quorum(rank=0, step=2, checkpoint_metadata="", shrink_only=False,
                       timeout=timedelta(seconds=30))
        assert time.monotonic() - t0 < 10.0  # far below the 60 s lease
        assert r.replica_world_size == 1
        assert r.participant_ids == ["rep_0"]
        mc.close()
        c.close()
    finally:
        for m in mgrs:
            m.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("name", PACKAGES)
def test_evict_guards(name):
    pkg = _package(name)
    lh = pkg.LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=100)
    (mgr,) = _managers(pkg, lh, 1)
    try:
        c = pkg.LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))
        with pytest.raises(RuntimeError):  # no quorum yet
            c.evict("rep_0", "rep_1")
        _quorum_all(pkg, lh, [mgr])
        for reporter, victim in (("stranger", "rep_0"),  # reporter not a member
                                 ("rep_0", "stranger"),  # victim not a member
                                 ("rep_0", "rep_0")):  # a self-report
            with pytest.raises(RuntimeError):
                c.evict(reporter, victim)
        c.close()
    finally:
        mgr.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("name", PACKAGES)
def test_manager_forwards_evict(name):
    pkg = _package(name)
    lh = pkg.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    mgrs = _managers(pkg, lh, 2)
    try:
        _quorum_all(pkg, lh, mgrs)
        mgrs[1].shutdown()
        mc = pkg.ManagerClient(mgrs[0].address(), connect_timeout=timedelta(seconds=10))
        assert mc.evict("rep_1") is True
        mc.close()
    finally:
        for m in mgrs:
            m.shutdown()
        lh.shutdown()


# ---------------------------------------------------------------------------
# the slice as a whole: kill mid-step, carry on, rejoin and heal
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
TCFG = T.TransformerConfig(**BASE, dtype=torch.float32, attention_impl="flash")
JCFG = J.TransformerConfig(**BASE, dtype=jnp.float32, attention_impl="flash")
TIMEOUT = timedelta(seconds=30)
LEASE_MS = 20000
JOINT_BEFORE, ALONE, JOINT_AFTER = 2, 2, 2


def _np_init(seed):
    params = J.init_params(jax.random.PRNGKey(seed), J.TransformerConfig(**BASE, dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(gid: int, step: int) -> np.ndarray:
    return np.random.default_rng(1000 + 17 * gid + step).integers(0, 64, (2, 128)).astype(np.int32)


class _Killed(Exception):
    pass


class _PortSide:
    name = "port"

    def lighthouse(self):
        from torchft_tpu_torch.coordination import LighthouseServer

        return LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=60000,
                                heartbeat_timeout_ms=LEASE_MS)

    def store(self):
        return StoreServer()

    def manager(self, gid, lighthouse, store):
        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

        return Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT, native_plane=True), load_state_dict=None,
            state_dict=None, min_replica_size=1, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
            checkpoint_transport=HTTPTransport(timeout=TIMEOUT, hostname="localhost"),
        )

    def trainer(self, manager, np_params):
        from torchft_tpu_torch.parallel.ft import FTTrainer
        from torchft_tpu_torch.parallel.train_step import TrainStep

        trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
        trainer.init(params=T.params_from_jax(np_params, device="cpu"))

        def step(tokens):
            return trainer.step(torch.from_numpy(tokens))

        def digest():
            h = hashlib.sha256()
            for leaf in tree_leaves(trainer.params):
                h.update(leaf.detach().numpy().tobytes())
            return h.hexdigest()

        return step, digest


class _JaxSide:
    name = "jax"

    def lighthouse(self):
        from torchft_tpu.coordination import LighthouseServer

        return LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=60000,
                                heartbeat_timeout_ms=LEASE_MS)

    def store(self):
        from torchft_tpu.store import StoreServer as JStore

        return JStore()

    def manager(self, gid, lighthouse, store):
        from torchft_tpu.collectives import CollectivesTcp as JCollectivesTcp
        from torchft_tpu.manager import Manager as JManager

        return JManager(
            collectives=JCollectivesTcp(timeout=TIMEOUT), load_state_dict=None,
            state_dict=None, min_replica_size=1, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
        )

    def trainer(self, manager, np_params):
        from torchft_tpu.ddp import allreduce_gradients
        from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
        from torchft_tpu.parallel.train_step import TrainStep as JTrainStep

        ts = JTrainStep(JCFG, optax.adamw(3e-4), make_mesh(MeshConfig(), jax.devices()[:1]))
        st = {"params": jax.device_put(np_params, ts._param_shardings)}
        st["opt_state"] = ts.init_opt(st["params"])

        def load(state):
            st["params"] = jax.device_put(state["params"], ts._param_shardings)
            st["opt_state"] = state["opt_state"]

        manager.set_state_dict_fns(load, lambda: dict(st))

        def step(tokens):
            manager.start_quorum()
            loss, grads = ts.grads(st["params"], ts.shard_batch(jnp.asarray(tokens)))
            grads = allreduce_gradients(manager, grads)
            committed = manager.should_commit()
            if committed:
                st["params"], st["opt_state"] = ts.apply(st["params"], st["opt_state"], grads)
            return float(loss), committed

        def digest():
            h = hashlib.sha256()
            for leaf in jax.tree_util.tree_leaves(st["params"]):
                h.update(np.asarray(leaf).tobytes())
            return h.hexdigest()

        return step, digest


def _kill(manager):
    """An abrupt death: the manager server and the data plane's sockets go
    without a goodbye. The server goes first: a SIGKILL closes both at
    once, and a survivor that sees the sockets close must find the server
    gone when the lighthouse probes it."""
    manager._manager.shutdown()
    manager._collectives.shutdown()


def _kill_and_rejoin(side):
    """The script, on one package. Group 0 (the survivor) and group 1 take
    ``JOINT_BEFORE`` steps together; in the next step group 1 dies once
    group 0 has issued its allreduce (its ring then waits on the dead
    peer). Group 0 takes ``ALONE`` more steps, then waits until a fresh
    group 1 has asked for its first quorum (the lighthouse's fast quorum
    would otherwise leave it out of a step at random); the two then take
    ``JOINT_AFTER`` joint steps. Returns the survivor's records, losses,
    kill and commit times, eviction reports and digest, and the joiner's
    digest and step."""
    lighthouse = side.lighthouse()
    started = threading.Barrier(2, timeout=120)
    doomed, s_issued = threading.Event(), threading.Event()
    alone_done, joiner_asked = threading.Event(), threading.Event()
    out = {}

    def survivor():
        store = side.store()
        m = side.manager(0, lighthouse, store)
        reports, commits = [], []
        if side.name == "port":
            report = m._report_eviction

            def recorded(victim):
                evicted = report(victim)
                reports.append((victim, evicted))
                return evicted

            m._report_eviction = recorded
        issue = m.allreduce_many

        def issued(arrays):
            fut = issue(arrays)
            if doomed.is_set():
                s_issued.set()
            return fut

        m.allreduce_many = issued
        records, losses = [], []

        def run():
            loss, committed = step(_tokens(0, m.current_step()))
            records.append((m.current_step(), committed, m._step_n))
            losses.append(loss)
            if committed:
                commits.append(time.monotonic())
            return committed

        try:
            step, digest = side.trainer(m, _np_init(0))
            started.wait()
            time.sleep(0.5)  # both heartbeats reach the lighthouse first
            for _ in range(JOINT_BEFORE):
                run()
            doomed.set()
            run()
            doomed.clear()
            for _ in range(ALONE):
                run()
            alone_done.set()
            if not joiner_asked.wait(120):
                raise TimeoutError("the new group 1 never asked for a quorum")
            time.sleep(0.5)  # its quorum request reaches the lighthouse first
            joint = 0
            while joint < JOINT_AFTER:
                joint += run() and records[-1][2] == 2
            _wait_for(lambda: any(ok for _, ok in reports), 10.0)
            out[0] = dict(records=records, losses=losses, commits=commits,
                          reports=list(reports), digest=digest())
        finally:
            alone_done.set()
            m.shutdown(wait=False)
            store.shutdown()

    def victim():
        store = side.store()
        m = side.manager(1, lighthouse, store)
        out["victim_id"] = m._replica_id

        def die(arrays):
            m.wait_quorum()
            s_issued.wait(60)
            out["t_kill"] = time.monotonic()
            _kill(m)
            raise _Killed()

        try:
            step, _ = side.trainer(m, _np_init(0))
            started.wait()
            time.sleep(0.5)
            for _ in range(JOINT_BEFORE):
                step(_tokens(1, m.current_step()))
            m.allreduce_many = die
            try:
                step(_tokens(1, m.current_step()))
            except _Killed:
                pass
        finally:
            m.shutdown(wait=False)
            store.shutdown()

    def joiner():
        if not alone_done.wait(120):
            raise TimeoutError("the survivor never finished its steps alone")
        store = side.store()
        m = side.manager(1, lighthouse, store)
        ask = m.start_quorum

        def asked(*args, **kwargs):
            ask(*args, **kwargs)
            joiner_asked.set()

        m.start_quorum = asked
        try:
            step, digest = side.trainer(m, _np_init(1))  # another init: the heal must matter
            joint = healed = 0
            while joint < JOINT_AFTER:
                before = m.current_step()
                _, committed = step(_tokens(1, before))
                healed |= m.current_step() > before + 1
                joint += committed and m._step_n == 2
            out[1] = dict(digest=digest(), step=m.current_step(), healed=healed)
        finally:
            joiner_asked.set()
            m.shutdown(wait=False)
            store.shutdown()

    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in (survivor, victim, joiner)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    finally:
        lighthouse.shutdown()
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    return out


def test_kill_and_rejoin_matches_jax():
    port, ref = _kill_and_rejoin(_PortSide()), _kill_and_rejoin(_JaxSide())
    s = port[0]
    k = JOINT_BEFORE
    # the script's shape: the doomed step votes False over the issue-time
    # membership of 2; the survivor then commits alone (the joiner's heal
    # step included: a healing group is not a participant) and together
    expect = ([(i + 1, True, 2) for i in range(k)] + [(k, False, 2)]
              + [(k + 1 + i, True, 1) for i in range(ALONE + 1)]
              + [(k + ALONE + 2 + i, True, 2) for i in range(JOINT_AFTER)])
    assert s["records"] == expect, s["records"]
    assert s["records"] == ref[0]["records"]
    np.testing.assert_allclose(s["losses"], ref[0]["losses"], rtol=1e-4)
    # the healed group holds the survivor's params bit for bit
    assert port[1]["healed"] and port[1]["step"] == s["records"][-1][0]
    assert port[1]["digest"] == s["digest"]
    # the victim was reported and evicted; the survivor's next commit came
    # well inside the lease, so the eviction (not the lease) ended the wait
    assert (port["victim_id"], True) in s["reports"], s["reports"]
    first_after = next(t for t in s["commits"] if t > port["t_kill"])
    assert first_after - port["t_kill"] < LEASE_MS / 1000
