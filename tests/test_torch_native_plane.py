"""The port's CollectivesTcp on the native striped plane, CMA and the wire
codecs, ranks on threads (``tests/test_wire_codec.py:376-415`` and
``tests/test_collectives.py:541-731`` on the port), and held bitwise
against the JAX package's CollectivesTcp given the same arrays.

Threads of one process share a pid, so the CMA probe passes and the
default plane is ``cma``; ``TORCHFT_DP_CMA=0`` forces ``tcp-striped`` and
``native_plane=False`` the Python ring. Also here: the peer-death
attribution on both native transports against the JAX package's, the
point-to-point CMA path (large frames, a stashed descriptor, a heal over
CollectivesTransport, the quarantine, the latch), the teardown's threads
and sockets, and ``allreduce_gradients`` reusing its staging buffers.

Arrays are at most 64 KB (but the 4 MB attribution case the JAX test
uses); every wait is bounded; every plane is shut down. Tolerances:
exact where both sides run the same arithmetic; the lossy codecs'
averages lie within the JAX tests' bounds of the exact mean (rtol = atol
= 0.01 for bfloat16, 0.02 for int8).
"""

import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torchft_tpu_torch.collectives as C
from torchft_tpu_torch.collectives import CollectivesTcp, PeerGoneError, ReduceOp
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.futures import Future
from torchft_tpu_torch.store import StoreServer

WAIT = timedelta(seconds=15)
N = 16001  # 64 KB of float32
BOUND = {"bfloat16": 0.01, "int8": 0.02}


def _package(name):
    if name == "port":
        return CollectivesTcp, StoreServer
    from torchft_tpu.collectives import CollectivesTcp as JCollectivesTcp
    from torchft_tpu.store import StoreServer as JStoreServer

    return JCollectivesTcp, JStoreServer


def _run_world(world, fn, pkg="port", timeout=timedelta(seconds=10), **kw):
    """Configure ``world`` CollectivesTcp of ``pkg`` on one store, run
    ``fn(coll, rank)`` on a thread each, shut all down; the results in
    rank order."""
    Tcp, Store = _package(pkg)
    store = Store()
    colls = [Tcp(timeout=timeout, hostname="localhost", **kw) for _ in range(world)]

    def run(rank):
        try:
            colls[rank].configure(f"{store.address()}/w", rank, world)
            return fn(colls[rank], rank)
        finally:
            colls[rank].shutdown()

    try:
        with ThreadPoolExecutor(max_workers=world) as ex:
            futs = [ex.submit(run, r) for r in range(world)]
            return [f.result(timeout=60) for f in futs]
    finally:
        store.shutdown()


def _inputs(world, seed=0, n=N):
    return [np.random.default_rng(seed + r).standard_normal(n).astype(np.float32)
            for r in range(world)]


def _allreduce(inputs, op=ReduceOp.SUM):
    def fn(c, rank):
        a = inputs[rank].copy()
        # the op as the rank's own package names it
        pkg_op = sys.modules[type(c).__module__].ReduceOp[op.name]
        c.allreduce([a], pkg_op).wait(WAIT)
        return c.plane_info(), c.wire_codec(), a

    return fn


def test_plane_info_modes(monkeypatch):
    fn = lambda c, rank: (c.plane_info(), c.wire_codec())
    assert set(_run_world(2, fn)) == {("cma", "f32")}
    assert set(_run_world(2, fn, native_plane=False)) == {("python-ring", "f32")}
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")
    assert set(_run_world(2, fn)) == {("tcp-striped", "f32")}
    assert set(_run_world(2, fn, wire_dtype="int8")) == {("tcp-striped", "int8")}
    monkeypatch.setenv("TORCHFT_NATIVE_PLANE", "0")
    assert set(_run_world(2, fn)) == {("python-ring", "f32")}
    assert set(_run_world(2, fn, native_plane=True)) == {("tcp-striped", "f32")}


@pytest.mark.parametrize("world", [2, 3])
def test_tcp_striped_matches_python_ring(monkeypatch, world):
    """The C++ ring's sum equals the Python ring's: bitwise at world 2
    (a + b either way), within rtol 1e-6 at world 3 (the stripes split the
    array into other ring chunks, so three operands are added in another
    order); every rank holds the same bytes; AVG is within 1e-6 of the
    mean."""
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")
    inputs = _inputs(world, seed=5)
    striped = _run_world(world, _allreduce(inputs))
    ring = _run_world(world, _allreduce(inputs), native_plane=False)
    assert {s[:2] for s in striped} == {("tcp-striped", "f32")}
    assert {s[:2] for s in ring} == {("python-ring", "f32")}
    for (_, _, got), (_, _, want) in zip(striped, ring):
        assert got.tobytes() == striped[0][2].tobytes()
        if world == 2:
            assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    avg = _run_world(world, _allreduce(inputs, ReduceOp.AVG))
    for _, _, got in avg:
        np.testing.assert_allclose(got, np.mean(inputs, axis=0), rtol=1e-6, atol=1e-6)
        assert got.tobytes() == avg[0][2].tobytes()


@pytest.mark.parametrize("native", [True, False], ids=["tcp-striped", "python-ring"])
@pytest.mark.parametrize("codec", ["bfloat16", "int8"])
def test_lossy_wire_bitwise_across_ranks(monkeypatch, codec, native):
    """``TestCompressedWireSmoke`` on the port, on its inputs (10007
    normals a rank, seeds 100 + rank) and bounds."""
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")
    inputs = _inputs(3, seed=100, n=10007)
    outs = _run_world(3, _allreduce(inputs, ReduceOp.AVG), wire_dtype=codec, native_plane=native)
    plane = "tcp-striped" if native else "python-ring"
    for p, c, got in outs:
        assert (p, c) == (plane, codec)
        assert got.tobytes() == outs[0][2].tobytes()
    tol = BOUND[codec]
    np.testing.assert_allclose(outs[0][2], np.mean(inputs, axis=0), rtol=tol, atol=tol)


def test_cma_bypasses_codec():
    inputs = _inputs(2, seed=7)
    outs = _run_world(2, _allreduce(inputs, ReduceOp.AVG), wire_dtype="int8")
    assert {o[:2] for o in outs} == {("cma", "f32")}
    ring = _run_world(2, _allreduce(inputs, ReduceOp.AVG), native_plane=False)
    for (_, _, got), (_, _, want) in zip(outs, ring):
        assert got.tobytes() == want.tobytes()  # exact: (a + b) / 2 either way


def test_wire_dtype_default_and_argument(monkeypatch):
    """The wire is exact float32 unless ``wire_dtype`` names a codec, on
    the Python ring and on the striped plane alike."""
    fn = lambda c, rank: (c.plane_info(), c.wire_codec())
    assert set(_run_world(2, fn, native_plane=False)) == {("python-ring", "f32")}
    assert set(_run_world(2, fn, native_plane=False, wire_dtype="int8")) == {("python-ring", "int8")}
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")
    assert set(_run_world(2, fn)) == {("tcp-striped", "f32")}
    assert set(_run_world(2, fn, wire_dtype="int8")) == {("tcp-striped", "int8")}


def test_max_min_and_non_float32_take_the_python_ring():
    def fn(c, rank):
        a = np.array([rank, -rank, 7], dtype=np.float32)
        mx = c.allreduce([a.copy()], ReduceOp.MAX).wait(WAIT)[0]
        mn = c.allreduce([a.copy()], ReduceOp.MIN).wait(WAIT)[0]
        i = c.allreduce([np.full(5, rank + 1, np.int64)], ReduceOp.SUM).wait(WAIT)[0]
        d = c.allreduce([np.full(5, rank + 0.5)], ReduceOp.SUM).wait(WAIT)[0]  # float64
        assert not c._dp_eligible(d) and not c._dp_eligible(np.ones((4, 4), np.float32).T)
        return mx, mn, i, d

    for mx, mn, i, d in _run_world(3, fn):
        np.testing.assert_array_equal(mx, [2.0, 0.0, 7.0])
        np.testing.assert_array_equal(mn, [0.0, -2.0, 7.0])
        np.testing.assert_array_equal(i, np.full(5, 6))
        np.testing.assert_array_equal(d, np.full(5, 4.5))


PLANES = {
    "python-ring": ({"native_plane": False}, "1"),
    "tcp-striped": ({}, "0"),
    "cma": ({}, "1"),
}


@pytest.mark.parametrize("codec", ["f32", "bfloat16", "int8"])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_results_bitwise_equal_jax(monkeypatch, plane, codec):
    """Three port ranks and three JAX ranks, each ring on its own package,
    given the same arrays: the same bytes on every rank of both."""
    kw, cma = PLANES[plane]
    monkeypatch.setenv("TORCHFT_DP_CMA", cma)
    world = 3 if plane != "cma" else 2
    inputs = _inputs(world, seed=31)
    port = _run_world(world, _allreduce(inputs, ReduceOp.AVG), wire_dtype=codec, **kw)
    ref = _run_world(world, _allreduce(inputs, ReduceOp.AVG), pkg="jax", wire_dtype=codec, **kw)
    for (pp, pc, got), (jp, jc, want) in zip(port, ref):
        assert (pp, pc) == (jp, jc) == (plane, "f32" if plane == "cma" else codec)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("cma", ["1", "0"])
def test_peer_death_attribution(monkeypatch, cma):
    """A rank vanishing mid-allreduce surfaces PeerGoneError naming it, on
    the CMA and the striped-TCP transports, as in the JAX package."""
    monkeypatch.setenv("TORCHFT_DP_CMA", cma)

    def script(pkg):
        gone = PeerGoneError if pkg == "port" else _jax_peer_gone()

        def fn(c, rank):
            if rank == 1:
                return "died"  # its shutdown closes its sockets
            a = np.ones(1 << 20, dtype=np.float32)
            try:
                c.allreduce([a], ReduceOp.SUM).wait(WAIT)
                return "completed"
            except gone as e:
                return ("gone", e.peer_rank)
            except Exception as e:  # noqa: BLE001
                return ("other", type(e).__name__)

        return _run_world(2, fn, pkg=pkg)

    port = script("port")
    assert port == [("gone", 1), "died"], port
    assert port == script("jax")


def _jax_peer_gone():
    from torchft_tpu.collectives import PeerGoneError as JPeerGoneError

    return JPeerGoneError


def test_cma_point_to_point(monkeypatch):
    """Frames of ``CMA_P2P_MIN`` bytes or more ship a descriptor and are
    pulled; a descriptor for a tag nobody waits on yet is pulled and
    stashed for the later recv."""
    monkeypatch.setattr(C, "CMA_P2P_MIN", 16 * 1024)
    n = 1 << 14  # 64 KB

    def fn(c, rank):
        assert c.plane_info() == "cma"
        if rank == 0:
            payload = np.arange(n, dtype=np.float32)
            c.send(payload, dst=1, tag=77).wait(WAIT)
            c.send(np.full(n, 7.0, np.float32), dst=1, tag=22).wait(WAIT)
            c.send(np.full(n, 5.0, np.float32), dst=1, tag=11).wait(WAIT)
            return None
        buf = np.zeros(n, dtype=np.float32)
        c.recv(buf, src=0, tag=77).wait(WAIT)
        a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
        wa, wb = c.recv(a, src=0, tag=11), c.recv(b, src=0, tag=22)
        wa.wait(WAIT)
        wb.wait(WAIT)
        return buf, float(a[0]), float(b[0])

    _, (buf, a, b) = _run_world(2, fn)
    np.testing.assert_array_equal(buf, np.arange(n, dtype=np.float32))
    assert (a, b) == (5.0, 7.0)


@pytest.mark.parametrize("cma", ["1", "0"])
def test_collectives_transport_rides_cma(monkeypatch, cma):
    """A heal over CollectivesTransport: pulled by CMA (the descriptor
    path) or streamed over TCP, the same tensors arrive."""
    from torchft_tpu_torch.checkpointing.collectives_transport import CollectivesTransport

    monkeypatch.setattr(C, "CMA_P2P_MIN", 16 * 1024)
    monkeypatch.setenv("TORCHFT_DP_CMA", cma)
    rng = np.random.default_rng(3)
    state = {"w": torch.from_numpy(rng.standard_normal(1 << 14).astype(np.float32)),
             "b": rng.standard_normal(3).astype(np.float32)}
    pulls = []
    real_pull = C._cma_pull
    monkeypatch.setattr(C, "_cma_pull", lambda *a: (pulls.append(len(a[2])), real_pull(*a)))

    def fn(c, rank):
        t = CollectivesTransport(c, timeout=WAIT)
        if rank == 0:
            t.send_checkpoint([1], 0, state, WAIT)
            return c.plane_info()
        got = t.recv_checkpoint(0, t.metadata(), 0, WAIT)
        return c.plane_info(), got

    plane0, (plane1, got) = _run_world(2, fn)
    assert plane0 == plane1 == ("cma" if cma == "1" else "tcp-striped")
    assert torch.equal(got["w"], state["w"])
    np.testing.assert_array_equal(got["b"], state["b"])
    assert (1 << 16 in pulls) == (cma == "1")


def test_ack_timeout_quarantines_and_poisons(monkeypatch):
    """A pull-ack that never arrives keeps the sender's buffer alive for
    the process and fails the send terminally (never a retryable
    timeout that would let the caller reuse the memory)."""
    monkeypatch.setattr(C, "CMA_P2P_MIN", 16 * 1024)
    before = len(C._CMA_QUARANTINE)
    n = 1 << 14

    def fn(c, rank):
        if rank == 1:
            time.sleep(3.0)  # never posts the recv within the timeout
            return "slept"
        try:
            c.send(np.full(n, 3.0, np.float32), dst=1, tag=33).wait(timedelta(seconds=8))
            return "sent"
        except Exception as e:  # noqa: BLE001
            return type(e).__name__

    outs = _run_world(2, fn, timeout=timedelta(seconds=1))
    assert outs[1] == "slept"
    assert outs[0] in ("PeerGoneError", "ConnectionError"), outs
    assert len(C._CMA_QUARANTINE) == before + 1
    assert C._CMA_QUARANTINE[-1].nbytes == n * 4


def test_pull_failure_latches_cma_off(monkeypatch):
    """A pull refused for permission latches CMA off in the process: the
    next epoch's negotiation settles the whole group on TCP, where ops
    work with ``process_vm_readv`` still refused."""
    import torchft_tpu_torch._native as N

    monkeypatch.setattr(C, "CMA_P2P_MIN", 16 * 1024)
    monkeypatch.setattr(C, "_CMA_BROKEN", False)

    def refused(pid, addr, view):
        raise OSError(1, "Operation not permitted")

    monkeypatch.setattr(N, "cma_read_into", refused)
    n = 1 << 14
    store = StoreServer()

    def fn(c, rank):
        assert c.plane_info() == "cma"  # the probe (cma_read) still passes
        failed = False
        try:
            if rank == 0:
                c.send(np.ones(n, np.float32), dst=1, tag=9).wait(WAIT)
            else:
                c.recv(np.zeros(n, np.float32), src=0, tag=9).wait(WAIT)
        except Exception:  # noqa: BLE001
            failed = True
        c.configure(f"{store.address()}/latch2", rank, 2)
        out = c.allreduce([np.full(4, float(rank + 1), np.float32)], ReduceOp.SUM).wait(WAIT)
        return failed, c.plane_info(), float(out[0][0])

    try:
        outs = _run_world(2, fn, timeout=timedelta(seconds=5))
    finally:
        store.shutdown()
    assert C._CMA_BROKEN is True
    assert outs == [(True, "tcp-striped", 3.0)] * 2, outs


def _plane_resources():
    """This process's threads (by name and kernel count) and sockets."""
    names = sorted(t.name for t in threading.enumerate()
                   if t.name.startswith(("tft_dp", "tft_accept", "tft_coll", "tft_ring", "tft_p2p",
                                         "tft_death")))
    tasks = len(os.listdir("/proc/self/task"))
    socks = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            socks += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return names, tasks, socks


@pytest.mark.parametrize("codec", ["f32", "bfloat16"])
def test_shutdown_frees_threads_and_sockets(monkeypatch, codec):
    """After ``shutdown()`` no plane thread (Python or native stripe
    worker) and no plane socket is left: every epoch opens ``DP_STRIPES``
    sockets a peer plus stripe workers, and a test that leaks them loads
    every later test in the worker."""
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")
    store = StoreServer()
    time.sleep(0.2)
    names0, tasks0, socks0 = _plane_resources()
    inputs = _inputs(3)
    colls = [CollectivesTcp(timeout=timedelta(seconds=10), hostname="localhost",
                            wire_dtype=codec) for _ in range(3)]
    try:
        for epoch in range(2):  # a reconfigure frees the old epoch too
            def run(rank):
                colls[rank].configure(f"{store.address()}/h{epoch}", rank, 3)
                return colls[rank].allreduce([inputs[rank].copy()]).wait(WAIT)

            with ThreadPoolExecutor(max_workers=3) as ex:
                list(ex.map(run, range(3)))
            names, tasks, socks = _plane_resources()
            # each rank: DP_STRIPES sockets to each of 2 peers
            assert socks >= socks0 + 3 * 2 * C.DP_STRIPES
    finally:
        for c in colls:
            c.shutdown()
        store.shutdown()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and _plane_resources()[1:] > (tasks0, socks0):
        time.sleep(0.05)
    names, tasks, socks = _plane_resources()
    assert names == names0
    assert tasks <= tasks0 and socks <= socks0, ((tasks0, socks0), (tasks, socks))


class _AveragingManager:
    """A one-peer Manager stand-in: the average is with a fixed peer
    gradient tree."""

    def __init__(self, peer):
        self.peer = peer
        self.error = None
        self.seen = []

    def device_data_plane(self):
        return False

    def errored(self):
        return self.error

    def allreduce_many(self, arrays):
        (buf,) = arrays
        self.seen.append(buf.ctypes.data)
        np.add(buf, self.peer[: buf.size], out=buf)
        np.divide(buf, 2, out=buf)
        return Future.completed(arrays)


def test_allreduce_gradients_reuses_its_staging_buffers():
    """Two steps with different gradients average correctly out of the
    same staging buffers; the first step's result is not changed by the
    second (on the CPU it is a copy); a failed step drops its buffers; a
    new bucket plan replaces the manager's one set."""
    import torchft_tpu_torch.ddp as D

    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5), "b": (17,), "c": (2, 2, 2)}
    n = sum(int(np.prod(s)) for s in shapes.values())
    peer = rng.standard_normal(n).astype(np.float32)
    m = _AveragingManager(peer)

    def step():
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for k, s in shapes.items()}
        flat = torch.cat([grads[k].reshape(-1) for k in sorted(grads)]).numpy()
        out = allreduce_gradients(m, grads)
        want = (flat + peer) / 2
        got = torch.cat([out[k].reshape(-1) for k in sorted(out)]).numpy()
        assert got.tobytes() == want.astype(np.float32).tobytes()
        return out, got.copy()

    out1, got1 = step()
    out2, _ = step()
    assert m.seen[0] == m.seen[1], "the second step allocated new buffers"
    assert D._STAGING[m].bufs[0].data_ptr() == m.seen[0]
    assert torch.cat([out1[k].reshape(-1) for k in sorted(out1)]).numpy().tobytes() == got1.tobytes()
    m.error = RuntimeError("the step failed")
    step()
    assert m not in D._STAGING  # not reused: a timed-out op may still write
    m.error = None
    step()
    assert m.seen[-1] != m.seen[0]
    # another bucket plan: the set is replaced, still one per manager
    g = {"z": torch.from_numpy(rng.standard_normal(9).astype(np.float32))}
    out = allreduce_gradients(m, g)
    np.testing.assert_array_equal(out["z"].numpy(), (g["z"].numpy() + peer[:9]) / 2)
    assert D._STAGING[m].key == ("cpu", ((torch.float32, 9),))
    held = len(D._STAGING)
    del m
    import gc
    gc.collect()
    assert len(D._STAGING) == held - 1  # dropped with its manager


def test_allreduce_gradients_error_feedback_projects_each_bucket():
    """With ``error_feedback`` each staged bucket is compensated and
    projected before it enters the average, under the JAX key
    ``b{ordinal}_{size}``, and its residual stays pending."""
    from torchft_tpu_torch.wire_codec import ErrorFeedback, get_codec

    rng = np.random.default_rng(2)
    grads = [torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(3)]
    m = _AveragingManager(np.zeros(256, np.float32))
    ef = ErrorFeedback(get_codec("bfloat16"))
    out = allreduce_gradients(m, grads, bucket_bytes=2 * 64 * 4, error_feedback=ef)
    assert ef.pending_keys() == ("b0_128", "b1_64")
    codec = get_codec("bfloat16")
    for g, o in zip(grads, out):
        proj = g.numpy().copy()
        codec.roundtrip(proj)
        assert (o.numpy() * 2).tobytes() == proj.tobytes()


def test_crossgroup_pair_on_the_cpu():
    """``benchmarks.crossgroup`` (phase 13's harness) on the CPU, two worker
    processes: the probe, an exact arm on CMA and a bfloat16 arm on the
    striped plane (tiny model), raw allreduces and a heal on both planes.
    Every step commits; the workers agree on the first average and the
    final params; the bf16 average differs from the exact one and its worst
    leaf lies within 2^-8 of that leaf's norm (bf16's unit roundoff; the
    worker's own gradients and zeros both miss it); error feedback holds
    residuals at the vote and none after the commit; the heal's sha256
    matches. Then the JAX harness's matrix as rows."""
    from torchft_tpu_torch.benchmarks.crossgroup import measure_crossgroup, run_pair

    jobs = [{"kind": "probe", "name": "probe"},
            {"kind": "e2e", "name": "exact", "plane": "cma", "codec": None, "warmup": 1,
             "steps": 2, "exact": True},
            {"kind": "e2e", "name": "bf16", "plane": "tcp-striped", "codec": "bfloat16",
             "warmup": 1, "steps": 2, "exact": False},
            {"kind": "raw", "name": "raw", "plane": "tcp-striped", "codec": "int8",
             "nbytes": 1 << 16, "rounds": 2},
            {"kind": "heal", "name": "heal", "plane": "cma", "nbytes": 1 << 16}]
    res = run_pair(jobs, "cpu", timeout_s=240)
    assert [r["result"] for r in res["probe"]] == ["ok", "ok"]
    for name, plane, codec in (("exact", "cma", "f32"), ("bf16", "tcp-striped", "bfloat16")):
        rs = res[name]
        assert [(r["plane"], r["wire_codec"]) for r in rs] == [(plane, codec)] * 2
        assert all(r["committed"] == [True] * 3 for r in rs)
        assert rs[0]["first_avg_digest"] == rs[1]["first_avg_digest"]
        assert rs[0]["final_digest"] == rs[1]["final_digest"]
    assert res["bf16"][0]["first_avg_digest"] != res["exact"][0]["first_avg_digest"]
    for r in res["bf16"]:
        assert 0 < r["first_avg_wire_err"]["leaf"] <= 2.0 ** -8
        assert all(c["leaf"] > 2.0 ** -8 for c in r["first_avg_controls"].values())
    assert all(all(n > 0 for n in r["pending_at_vote"]) and r["pending_after"] == [0] * 3
               for r in res["bf16"])
    assert [r["error_feedback"] for r in res["exact"]] == [False, False]
    assert all(r["correct"] and r["wire_codec"] == "int8" for r in res["raw"])
    assert res["heal"][0]["digest"] == res["heal"][1]["digest"]
    rows = measure_crossgroup(total_mb=0.25, rounds=1, device="cpu")
    assert rows["raw_cma"]["plane"] == "cma" and rows["raw_python_ring"]["plane"] == "python-ring"
    assert rows["pipelined_bf16_wire"]["wire_codec"] == "bfloat16"
    assert rows["heal_tcp"]["plane"] == "tcp-striped"
    for name, n in (("heal_striped_1src", 1), ("heal_striped_2src", 2)):
        row = rows[name]
        assert row["nsources"] == n and set(row["sha256_sources"]) == {row["sha256_healed"]}
        assert {v["route"] for v in row["per_source"].values()} == {"blob"}
    assert rows["heal_striped_speedup"] > 0


def test_wire_error_measures():
    """``crossgroup.wire_error`` (what phase 13 holds the lossy arms by):
    the tree's and the worst leaf's relative norm and the peak ratio, on
    hand-made errors; zeros read 1 on every measure."""
    from torchft_tpu_torch.benchmarks.crossgroup import wire_error

    ref = [torch.tensor([3.0, 4.0]), torch.tensor([0.0, 10.0]), torch.zeros(3)]
    got = [torch.tensor([3.0, 4.5]), torch.tensor([0.0, 10.0]), torch.zeros(3)]
    err = wire_error(got, ref)
    assert err["leaf"] == pytest.approx(0.5 / 5.0, rel=1e-12)
    assert err["tree"] == pytest.approx(0.5 / np.sqrt(125.0), rel=1e-12)
    assert err["peak"] == pytest.approx(0.5 / 10.0, rel=1e-12)
    assert wire_error(ref, ref) == {"tree": 0.0, "leaf": 0.0, "peak": 0.0}
    assert wire_error([torch.zeros_like(r) for r in ref], ref) == {"tree": 1.0, "leaf": 1.0,
                                                                   "peak": 1.0}


# A child process runs one case of test_manager_shutdown_wait_false_joins_native_threads
# (the lighthouses and the store live in the test's process, so the child's
# tasks are the Manager's and the interpreter's alone). A native thread is a
# task that is no Python thread: /proc/self/task less every native_id that
# threading.enumerate() showed around the case.
_SHUTDOWN_CHILD = r"""
import json, os, sys, threading, time
from datetime import timedelta
import numpy as np
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.store import StoreClient, StoreServer

case, lh_one, lh_two, store_addr = sys.argv[1:5]
seen = set()


def native():
    py = {t.native_id for t in threading.enumerate()}
    seen.update(py)
    return {int(t) for t in os.listdir("/proc/self/task")} - py


def comm(tid):
    try:
        with open(f"/proc/self/task/{tid}/comm") as f:
            return f.read().strip()
    except OSError:
        return "gone"


def manager(lighthouse):
    timeout = timedelta(seconds=10)
    return Manager(collectives=CollectivesTcp(timeout=timeout), load_state_dict=lambda s: None,
                   state_dict=lambda: {"w": np.ones(256, np.float32)}, min_replica_size=1,
                   replica_id=f"shutdown_{case}", store_addr=store_addr, rank=0, world_size=1,
                   lighthouse_addr=lighthouse, timeout=timeout)


# the process-wide native sampler starts with the first served connection
warm = StoreServer()
client = StoreClient(warm.address())
client.set("k", b"v")
client.close()
warm.shutdown()
base = native()
made = 0
if case == "steps_and_staged_blob":
    m = manager(lh_one)
    for _ in range(2):
        m.start_quorum()
        m.allreduce_many([np.ones(64, np.float32)]).wait()
        assert m.should_commit()
    m._checkpoint_transport.send_checkpoint([1], 2, {"w": np.ones(256, np.float32)},
                                            timedelta(seconds=5))
    made = len(native() - base)
    m.shutdown(wait=False)
elif case == "quorum_in_flight":
    m = manager(lh_two)  # two replicas wanted, one comes: the quorum waits
    m.start_quorum()
    time.sleep(0.5)
    made = len(native() - base)
    m.shutdown(wait=False)
elif case == "staging_after_shutdown":
    t = HTTPTransport(timeout=timedelta(seconds=5))
    t.shutdown(wait=False)
    t.send_checkpoint([1], 0, {"w": np.ones(256, np.float32)}, timedelta(seconds=5))
elif case == "live_handles_at_exit":
    store = StoreServer()
    plane = _native.NativeDataPlane(0, 2, 2)
    made = len(native() - base)
    foreign = _native.NativeDataPlane(0, 2, 1)
    _native._LIVE[foreign] = (os.getpid() + 1, "close")  # a forked parent's
    _native.close_live()
    assert not foreign._h == 0, "close_live closed another process's handle"
    foreign.close()
left = sorted(native() - base - seen)
print(json.dumps({"made": made, "left": [(t, comm(t)) for t in left]}), flush=True)
"""


@pytest.mark.parametrize("case", ["steps_and_staged_blob", "quorum_in_flight",
                                  "staging_after_shutdown", "live_handles_at_exit"])
def test_manager_shutdown_wait_false_joins_native_threads(case):
    """``Manager.shutdown(wait=False)`` returns with every native thread of
    the manager joined (the manager server's acceptor, heartbeat and
    connection threads, the blob server of a staged checkpoint), after
    committed steps and with a quorum still in flight; a staging that runs
    after the transport's shutdown makes no blob server; and at interpreter
    exit ``_native.close_live`` stops this process's live handles (a store
    server, a data plane) but not another process's. Tasks are named by
    ``/proc/self/task/*/comm``."""
    import json
    import subprocess

    from torchft_tpu_torch.coordination import LighthouseServer

    lh_one = LighthouseServer(bind="[::]:0", min_replicas=1)
    lh_two = LighthouseServer(bind="[::]:0", min_replicas=2)
    store = StoreServer()
    try:
        out = subprocess.run(
            [sys.executable, "-c", _SHUTDOWN_CHILD, case, lh_one.address(), lh_two.address(),
             store.address()],
            env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=120)
    finally:
        store.shutdown()
        lh_two.shutdown()
        lh_one.shutdown()
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if case != "staging_after_shutdown":
        assert res["made"] > 0, res  # the case did run native threads
    assert res["left"] == [], res
