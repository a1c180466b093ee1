"""The port's host data plane: CollectivesTcp's ring allreduce, broadcast,
send/recv and barrier across three ranks on threads, and the error latch
of ErrorSwallowingCollectives. The ring must leave every rank with the
same bytes (the allgather forwards the owner's bytes), which is what
makes the groups' parameters bit-identical after a step."""

import threading
from datetime import timedelta

import numpy as np
import pytest

from torchft_tpu_torch.collectives import (
    CollectivesTcp,
    ErrorSwallowingCollectives,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.store import StoreServer

WORLD = 3


def _on_ranks(fn, prefix):
    """Configure WORLD CollectivesTcp on one store, run ``fn(coll, rank)``
    on a thread per rank, return the results in rank order."""
    store = StoreServer()
    colls = [CollectivesTcp(timeout=timedelta(seconds=10), hostname="localhost")
             for _ in range(WORLD)]
    results, errors = [None] * WORLD, []

    def run(rank):
        try:
            colls[rank].configure(f"{store.address()}/{prefix}", rank, WORLD)
            results[rank] = fn(colls[rank], rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert all(not th.is_alive() for th in threads), "a rank hung"
        if errors:
            raise errors[0]
        return results
    finally:
        for c in colls:
            c.shutdown()
        store.shutdown()


@pytest.mark.parametrize("op,n", [(ReduceOp.SUM, 1001), (ReduceOp.AVG, 7), (ReduceOp.MAX, 64)])
def test_ring_allreduce_identical_on_every_rank(op, n):
    inputs = [np.random.default_rng(r).standard_normal(n).astype(np.float32) for r in range(WORLD)]

    def fn(coll, rank):
        arr = inputs[rank].copy()
        coll.allreduce([arr], op).wait(timedelta(seconds=30))
        return arr

    out = _on_ranks(fn, f"ar{op.value}")
    stacked = np.stack(inputs)
    expect = {ReduceOp.SUM: stacked.sum(0), ReduceOp.AVG: stacked.mean(0),
              ReduceOp.MAX: stacked.max(0)}[op]
    np.testing.assert_allclose(out[0], expect, rtol=1e-6, atol=1e-6)
    for r in range(1, WORLD):
        assert out[r].tobytes() == out[0].tobytes()


def test_broadcast_send_recv_barrier():
    def fn(coll, rank):
        arr = np.full(5, rank, dtype=np.int64)
        coll.broadcast(arr, root=1).wait(timedelta(seconds=30))
        got = np.zeros(3, dtype=np.float32)
        right, left = (rank + 1) % WORLD, (rank - 1) % WORLD
        send = coll.send(np.full(3, rank, dtype=np.float32), right, tag=9)
        coll.recv(got, left, tag=9).wait(timedelta(seconds=30))
        send.wait(timedelta(seconds=30))
        coll.barrier().wait(timedelta(seconds=30))
        return arr, got

    for rank, (arr, got) in enumerate(_on_ranks(fn, "p2p")):
        assert (arr == 1).all()
        assert (got == (rank - 1) % WORLD).all()


def test_allgather_reduce_scatter_alltoall():
    """The ring's allgather, reduce-scatter (SUM and AVG) and alltoall:
    exact on integer-valued inputs, as the JAX package's cases are."""

    def fn(coll, rank):
        ag = coll.allgather(np.full(3, rank, dtype=np.float32)).wait(timedelta(seconds=30))
        ins = [np.full(2, rank * 10 + j, dtype=np.float32) for j in range(WORLD)]
        rs = coll.reduce_scatter(ins, ReduceOp.SUM).wait(timedelta(seconds=30))
        avg = coll.reduce_scatter(ins, ReduceOp.AVG).wait(timedelta(seconds=30))
        a2a = coll.alltoall(ins).wait(timedelta(seconds=30))
        assert all((x == rank * 10 + j).all() for j, x in enumerate(ins))  # untouched
        return ag, rs, avg, a2a

    for rank, (ag, rs, avg, a2a) in enumerate(_on_ranks(fn, "rs")):
        assert [float(x[0]) for x in ag] == [0.0, 1.0, 2.0]
        want = sum(j * 10 + rank for j in range(WORLD))
        assert (rs == want).all() and (avg == np.float32(want) / WORLD).all()
        assert [float(x[0]) for x in a2a] == [j * 10 + rank for j in range(WORLD)]


class _Broken(CollectivesTcp):
    def allreduce(self, arrays, op=ReduceOp.SUM):
        raise ConnectionError("peer gone")


def test_error_swallowing_latches_until_configure():
    coll = ErrorSwallowingCollectives(_Broken())
    arr = np.ones(4, dtype=np.float32)
    assert coll.allreduce([arr]).wait(timedelta(seconds=5)) == [arr]
    assert isinstance(coll.error(), ConnectionError)
    # latched: later ops complete with their default without running
    assert isinstance(coll.barrier(), Work) and coll.barrier().wait() is None
    coll.configure("unused:0", 0, 1)  # world 1 needs no store
    assert coll.error() is None
    # the plane's labels pass through the wrapper
    assert not coll.device_arrays
    assert coll.plane_info() == "python-ring" and coll.wire_codec() == "f32"
    coll.shutdown()


def test_native_build_is_keyed_by_its_sources(tmp_path, monkeypatch):
    """An edit of any native source or the Makefile moves the core's build
    directory, so a stale libtftcore.so is never loaded for new sources."""
    import shutil

    from torchft_tpu_torch import _native

    src = tmp_path / "native"
    shutil.copytree(_native._NATIVE_SRC, src,
                    ignore=shutil.ignore_patterns("*.so", "*.o", "__pycache__"))
    monkeypatch.setattr(_native, "_NATIVE_SRC", str(src))
    before = _native._sources_digest()
    assert _native._sources_digest() == before
    for name in ("coord.cc", "wire.h", "Makefile"):
        path = src / name
        original = path.read_bytes()
        path.write_bytes(original + b"\n")
        assert _native._sources_digest() != before, name
        path.write_bytes(original)
    assert _native._sources_digest() == before
