"""The divergence sentinel on the port: every case of
``tests/test_divergence.py`` over the port's lighthouse, manager server and
clients (the native ``lh.digest`` compare, the fence's veto through
``mgr.should_commit``) and on the port's Manager with a patched
``ManagerClient`` (the commit-pipeline harness): the post-reduce digest
flows into the vote, a doomed step abstains, the fence implies the
sentinel, off sends no digest, a divergent reply latches once.

Against the JAX package on the same numpy buffers: the digest the port's
Manager sends for a reduced tree equals the JAX Manager's byte for byte,
in float32 and bfloat16, on the host and the device plane (the pipelined
vote's too); a doomed step abstains with ``"-"`` on both.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from datetime import timedelta
from unittest.mock import MagicMock, patch

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu_torch import telemetry
from torchft_tpu_torch.checkpointing import delta
from torchft_tpu_torch.collectives import CollectivesDummy
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
    QuorumResult,
)
from torchft_tpu_torch.manager import MANAGER_ADDR_KEY, REPLICA_ID_KEY, Manager
from torchft_tpu_torch.store import StoreClient, StoreServer


def _get_json(addr: str, path: str):
    if "://" not in addr:
        addr = "http://" + addr
    with urllib.request.urlopen(f"{addr}{path}", timeout=5) as resp:
        return json.loads(resp.read().decode())


def _lh_client(lh) -> LighthouseClient:
    return LighthouseClient(lh.address(), connect_timeout=timedelta(seconds=5))


class TestLighthouseDigestCompare:
    def test_match_then_mismatch_latches(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            c = _lh_client(lh)
            r = c.digest("gA", epoch=1, step=5, digest="aaaa")
            assert r["match"] is True and r["divergence"] is False
            r = c.digest("gB", epoch=1, step=5, digest="aaaa")
            assert r["match"] is True and r["divergence"] is False
            # same epoch, the next step, one perturbed digest: the latch
            c.digest("gA", epoch=1, step=6, digest="cccc")
            r = c.digest("gB", epoch=1, step=6, digest="dddd")
            assert r["match"] is False and r["divergence"] is True
            # global and sticky: a later clean round still reports it
            r = c.digest("gA", epoch=1, step=7, digest="e")
            assert r["match"] is True and r["divergence"] is True
            c.close()
        finally:
            lh.shutdown()

    def test_abstain_never_enters_comparison(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            c = _lh_client(lh)
            # one group aborts (abstains), one commits: only committing
            # states must agree
            c.digest("gA", epoch=2, step=1, digest="-")
            r = c.digest("gB", epoch=2, step=1, digest="real")
            assert r["match"] is True and r["divergence"] is False
            assert r["reports"] == 2  # the abstention completed the round
            c.close()
        finally:
            lh.shutdown()

    def test_fence_wait_blocks_until_cohort(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            out = {}

            def report(name, digest):
                c = _lh_client(lh)
                out[name] = c.digest(name, epoch=3, step=1, digest=digest, wait=True, cohort=2,
                                     timeout=timedelta(seconds=20))
                c.close()

            t = threading.Thread(target=report, args=("gA", "x"))
            t.start()
            time.sleep(0.2)
            assert "gA" not in out, "the fence wait returned before the cohort"
            report("gB", "y")
            t.join(timeout=20)
            assert out["gA"]["match"] is False
            assert out["gB"]["match"] is False
        finally:
            lh.shutdown()

    def test_scrape_surfaces(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            addr = lh.address()
            c = _lh_client(lh)
            c.digest("gA", epoch=4, step=1, digest="p")
            c.digest("gB", epoch=4, step=1, digest="q")
            c.close()
            status = _get_json(addr, "/status.json")
            assert status["divergence_detected"] is True
            assert status["divergence_total"] == 1
            cluster = _get_json(addr, "/cluster.json")
            assert cluster["divergence_detected"] is True
            assert cluster["divergence_total"] == 1
            with urllib.request.urlopen(f"{addr}/metrics", timeout=5) as r:
                text = r.read().decode()
            assert "torchft_divergence_total 1" in text
            assert "torchft_divergence_detected 1" in text
        finally:
            lh.shutdown()

    def test_missing_fields_rejected(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1)
        try:
            c = _lh_client(lh)
            with pytest.raises(RuntimeError):
                c.digest("", epoch=0, step=0, digest="x")
            c.close()
        finally:
            lh.shutdown()


class TestManagerSrvFence:
    def _setup(self):
        lh = LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=100)
        mgr = ManagerServer(replica_id="rep_0", lighthouse_addr=lh.address(),
                            hostname="localhost", bind="[::]:0", store_addr="s", world_size=1)
        client = ManagerClient(mgr.address(), connect_timeout=timedelta(seconds=10))
        # one quorum, so the fence's cohort (the quorum's size, 1) is known
        client._quorum(rank=0, step=0, checkpoint_metadata="m", shrink_only=False,
                       timeout=timedelta(seconds=10))
        return lh, mgr, client

    @staticmethod
    def _conflict(lh, step):
        """A conflicting report in the (epoch 1, step) round before the vote:
        the other group in miniature."""
        lhc = _lh_client(lh)
        lhc.digest("rep_other", epoch=1, step=step, digest="other")
        lhc.close()

    def test_clean_digest_commits(self):
        lh, mgr, client = self._setup()
        try:
            decision = client.should_commit(0, 0, True, timeout=timedelta(seconds=10),
                                            digest="d0", epoch=1, fence=True)
            assert decision is True
            assert client.last_divergence is False
        finally:
            client.close()
            mgr.shutdown()
            lh.shutdown()

    def test_fence_vetoes_on_mismatch(self):
        lh, mgr, client = self._setup()
        try:
            self._conflict(lh, step=1)
            decision = client.should_commit(0, 1, True, timeout=timedelta(seconds=10),
                                            digest="mine", epoch=1, fence=True)
            # every rank voted True, the compare disagreed: the fence turns
            # the commit into an abort and the reply carries the flag
            assert decision is False
            assert client.last_divergence is True
        finally:
            client.close()
            mgr.shutdown()
            lh.shutdown()

    def test_sentinel_without_fence_reports_but_commits(self):
        lh, mgr, client = self._setup()
        try:
            self._conflict(lh, step=2)
            decision = client.should_commit(0, 2, True, timeout=timedelta(seconds=10),
                                            digest="mine", epoch=1, fence=False)
            assert decision is True  # detection alone never vetoes
            assert client.last_divergence is True
        finally:
            client.close()
            mgr.shutdown()
            lh.shutdown()


def _quorum_result():
    return QuorumResult(quorum_id=9, replica_rank=1, replica_world_size=2, max_rank=1,
                        max_world_size=2, max_step=0, store_address="store/prefix")


class _Harness:
    """A port Manager (rank 1 of 2) over a stub data plane, its
    ``ManagerClient`` patched (autospec: the vote client is the same mock)."""

    def __init__(self, monkeypatch, sentinel=True, fence=False, collectives=None, **kwargs):
        for var in ("TORCHFT_DIVERGENCE_SENTINEL", "TORCHFT_DIVERGENCE_FENCE"):
            monkeypatch.delenv(var, raising=False)
        if sentinel:
            monkeypatch.setenv("TORCHFT_DIVERGENCE_SENTINEL", "1")
        if fence:
            monkeypatch.setenv("TORCHFT_DIVERGENCE_FENCE", "1")
        self.store_server = StoreServer()
        store = StoreClient(self.store_server.address())
        store.set(MANAGER_ADDR_KEY, "dummy")
        store.set(REPLICA_ID_KEY, "dummy_id")
        store.close()
        self._patcher = patch("torchft_tpu_torch.manager.ManagerClient", autospec=True)
        self._patcher.start()
        transport = MagicMock()
        transport.metadata.return_value = "meta"
        self.manager = Manager(
            collectives=collectives or CollectivesDummy(rank=0, world_size=1),
            load_state_dict=lambda s: None, state_dict=lambda: {"w": 1},
            min_replica_size=2, rank=1, world_size=2,
            store_addr=self.store_server.address(), checkpoint_transport=transport,
            timeout=timedelta(seconds=10), **kwargs)
        self.client = self.manager._client
        self.client._quorum.return_value = _quorum_result()

    def shutdown(self):
        self.manager.shutdown(wait=False)
        self._patcher.stop()
        self.store_server.shutdown()


@pytest.fixture
def harness(monkeypatch):
    made = []

    def make(**kwargs):
        h = _Harness(monkeypatch, **kwargs)
        made.append(h)
        return h

    yield make
    for h in made:
        h.shutdown()


class TestManagerSentinel:
    def test_digest_flows_into_vote(self, harness):
        h = harness()
        m = h.manager
        h.client.should_commit.return_value = True
        m.start_quorum()
        t = np.array([2.0, 4.0], dtype=np.float32)
        m.allreduce(t).wait()
        assert m.should_commit()
        kwargs = h.client.should_commit.call_args.kwargs
        digest = kwargs["digest"]
        assert isinstance(digest, str) and digest != "-"
        assert kwargs["epoch"] == 9
        assert kwargs["fence"] is False
        # the same reduced bytes fold to the same digest (this equality is
        # the cross-group invariant)
        assert digest == delta.tree_digest([delta.tree_digest(delta.leaf_digests([t]))])

    def test_doomed_step_abstains(self, harness):
        h = harness()
        m = h.manager
        h.client.should_commit.return_value = False
        m.start_quorum()
        m.allreduce(np.array([1.0], dtype=np.float32)).wait()
        m.report_error(RuntimeError("boom"))
        assert m.should_commit() is False
        assert h.client.should_commit.call_args.kwargs["digest"] == "-"

    def test_fence_implies_sentinel_and_flag(self, harness):
        h = harness(sentinel=False, fence=True)
        m = h.manager
        assert m._divergence_sentinel is True
        h.client.should_commit.return_value = True
        m.start_quorum()
        m.allreduce(np.array([1.0], dtype=np.float32)).wait()
        assert m.should_commit()
        assert h.client.should_commit.call_args.kwargs["fence"] is True

    def test_sentinel_off_sends_no_digest(self, harness):
        h = harness(sentinel=False)
        m = h.manager
        h.client.should_commit.return_value = True
        m.start_quorum()
        assert m.should_commit()
        assert h.client.should_commit.call_args.kwargs["digest"] is None

    def test_divergence_reply_emits_once(self, harness):
        h = harness()
        m = h.manager
        h.client.should_commit.return_value = True
        h.client.last_divergence = True
        telemetry.EVENTS.clear()
        before = telemetry.DIVERGENCE_TOTAL.value
        for _ in range(2):
            m.start_quorum()
            m.allreduce(np.array([1.0], dtype=np.float32)).wait()
            m.should_commit()
        assert len(telemetry.EVENTS.recent(event="divergence_detected")) == 1
        assert telemetry.DIVERGENCE_TOTAL.value == before + 1
        # the latch feeds the time series' flag
        assert m._telemetry_report()["series"]["flag.divergence"] == 1.0


# -- against the JAX package ---------------------------------------------------


class _PortDevicePlane(CollectivesDummy):
    """A one-rank device plane: tensors in, the same tensors out."""

    device_arrays = True


def _jax_manager(monkeypatch, store_server, device_plane, fence=False, pipeline=False):
    """The JAX Manager in the same harness: rank 1 of 2, patched client."""
    from torchft_tpu import manager as jm
    from torchft_tpu.collectives import CollectivesDummy as JDummy
    from torchft_tpu.coordination import QuorumResult as JQ

    class JDevice(JDummy):
        device_arrays = True

    store = StoreClient(store_server.address())
    store.set(jm.MANAGER_ADDR_KEY, "dummy")
    store.set(jm.REPLICA_ID_KEY, "dummy_id")
    store.close()
    patcher = patch("torchft_tpu.manager.ManagerClient", autospec=True)
    patcher.start()
    transport = MagicMock()
    transport.metadata.return_value = "meta"
    m = jm.Manager(
        collectives=JDevice(rank=0, world_size=1) if device_plane else JDummy(rank=0, world_size=1),
        load_state_dict=lambda s: None, state_dict=lambda: {"w": 1}, min_replica_size=2,
        rank=1, world_size=2, store_addr=store_server.address(),
        checkpoint_transport=transport, timeout=timedelta(seconds=10),
        commit_pipeline=pipeline)
    q = JQ()
    q.quorum_id, q.replica_rank, q.replica_world_size = 9, 1, 2
    q.max_rank, q.max_world_size, q.max_step, q.store_address = 1, 2, 0, "store/prefix"
    m._client._quorum.return_value = q
    return m, patcher


def _buffers(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(shape).astype(np.float32).astype(np_dtype)
            for shape in ((64, 33), (7,), (3, 5, 2))]


def _as_port(buffers, device_plane):
    if not device_plane:
        return [b.copy() for b in buffers]
    out = []
    for b in buffers:
        if b.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(b.copy()))
    return out


def _run_step(m, arrays, pipeline, error=False):
    """One step: quorum, two ops (the arrays split in two), the vote."""
    m.start_quorum()
    m.allreduce_many(arrays[:2]).wait()
    m.allreduce_many(arrays[2:]).wait()
    if error:
        m.report_error(RuntimeError("boom"))
    if pipeline:
        m.should_commit_async()
        m.resolve_pending_commit(rearm=False)
    else:
        m.should_commit()


# a doomed step never speculates, so the pipelined vote is issued clean only
@pytest.mark.parametrize("pipeline,error", [(False, False), (False, True), (True, False)],
                         ids=["sync", "sync-doomed", "pipelined"])
@pytest.mark.parametrize("device_plane", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_digest_equals_the_jax_managers(monkeypatch, harness, dtype, device_plane,
                                             pipeline, error):
    """The same numpy buffers through both Managers (the reduce is the
    identity of one rank, divided by the two participants): the vote's
    digest is the same string, and a doomed step abstains on both."""
    import jax.numpy as jnp

    monkeypatch.setenv("TORCHFT_DIVERGENCE_SENTINEL", "1")
    buffers = _buffers(dtype, seed=3)

    store_server = StoreServer()
    jm, patcher = _jax_manager(monkeypatch, store_server, device_plane, pipeline=pipeline)
    try:
        jm._client.should_commit.return_value = not error
        arrays = [jnp.asarray(b) for b in buffers] if device_plane else [b.copy() for b in buffers]
        _run_step(jm, arrays, pipeline, error)
        jax_digest = jm._client.should_commit.call_args.kwargs["digest"]
    finally:
        jm.shutdown(wait=False)
        patcher.stop()
        store_server.shutdown()

    h = harness(collectives=_PortDevicePlane(rank=0, world_size=1) if device_plane else None,
                commit_pipeline=pipeline)
    h.client.should_commit.return_value = not error
    _run_step(h.manager, _as_port(buffers, device_plane), pipeline, error)
    port_digest = h.client.should_commit.call_args.kwargs["digest"]

    assert port_digest == jax_digest
    assert (port_digest == "-") == error
