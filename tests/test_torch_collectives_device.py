"""The port's device data plane against the JAX package's.

Every case of ``tests/test_collectives_device.py`` but the sharded one runs
on both packages: replica groups as threads, the JAX side one virtual CPU
device per group (conftest), the port side ``device="cpu"``, fed the same
numpy inputs. Exact on the integer-valued float32 inputs the JAX tests
use; rtol 1e-6 on standard-normal inputs at world 4, where XLA's psum may
sum in another order than the port's rank order. Both packages raise the
same "collective desync" when two groups hand tensors of different shapes
or dtypes to one allreduce.
"""

import sys
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.collectives import ReduceOp as JReduceOp
from torchft_tpu.collectives_device import CollectivesDevice as JDevice
from torchft_tpu_torch.collectives import ReduceOp
from torchft_tpu_torch.collectives_device import CollectivesDevice

T = timedelta(seconds=5)


def _prefix() -> str:
    # the registry is keyed by the store prefix: a fresh epoch per run
    return f"store:0/torchft/{uuid.uuid4().hex}"


def _world(make, world, fn, timeout_s=10):
    """Configure ``world`` collectives from ``make(timeout)`` on one epoch,
    run ``fn(coll, rank)`` on a thread per rank, return results in rank
    order."""
    prefix = _prefix()
    colls = [make(timedelta(seconds=timeout_s)) for _ in range(world)]

    def start(rank):
        colls[rank].configure(f"{prefix}/{rank}", rank, world)
        try:
            return fn(colls[rank], rank)
        finally:
            colls[rank].shutdown()

    with ThreadPoolExecutor(max_workers=world) as ex:
        return list(ex.map(start, range(world)))


def _port(timeout):
    return CollectivesDevice(timeout=timeout, device="cpu")


def _both(world, jfn, tfn):
    """Run the same case on both packages; results as numpy, rank order."""
    return _world(JDevice, world, jfn), _world(_port, world, tfn)


def _jput(x, rank):
    return jax.device_put(jnp.asarray(x), jax.devices()[rank])


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(x) for x in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def test_allreduce_identity_at_world_1():
    """World-1 fast path on both: the caller's own array back, no copy."""
    prefix = _prefix()
    jc = JDevice(timeout=T)
    jc.configure(f"{prefix}j/0", 0, 1)
    a = jnp.arange(8, dtype=jnp.float32)
    assert jc.allreduce([a], JReduceOp.SUM).wait()[0] is a
    jc.shutdown()
    c = _port(T)
    c.configure(f"{prefix}t/0", 0, 1)
    t = torch.arange(8, dtype=torch.float32)
    before = t.data_ptr()
    out = c.allreduce([t], ReduceOp.SUM).wait()
    assert out[0] is t and t.data_ptr() == before
    c.shutdown()


@pytest.mark.parametrize("world,kind", [(2, "int"), (4, "int"), (4, "normal")])
def test_allreduce_sum(world, kind):
    rng = np.random.default_rng(world)
    if kind == "int":
        inputs = [np.full((6, 3), float(r + 1), np.float32) for r in range(world)]
    else:
        inputs = [rng.standard_normal((64, 33)).astype(np.float32) for _ in range(world)]

    def jfn(c, rank):
        a = _jput(inputs[rank], rank)
        out = c.allreduce([a, a * 2], JReduceOp.SUM).wait()
        assert list(out[0].devices()) == [jax.devices()[rank]]
        return _np(out)

    def tfn(c, rank):
        a = torch.from_numpy(inputs[rank].copy())
        b = a * 2
        out = c.allreduce([a, b], ReduceOp.SUM).wait()
        # inputs untouched; every rank owns its results
        np.testing.assert_array_equal(a.numpy(), inputs[rank])
        assert all(o.data_ptr() not in (a.data_ptr(), b.data_ptr()) for o in out)
        ptrs[rank] = {o.data_ptr() for o in out}
        return _np(out)

    ptrs = {}
    jres, tres = _both(world, jfn, tfn)
    # no two groups share a result tensor
    assert len(set().union(*ptrs.values())) == 2 * world
    for j, t in zip(jres, tres):
        for jx, tx in zip(j, t):
            if kind == "int":
                np.testing.assert_array_equal(tx, jx)
            else:
                np.testing.assert_allclose(tx, jx, rtol=1e-6)
    # the port's groups agree bit for bit: one sum, in rank order
    for t in tres[1:]:
        for x, y in zip(t, tres[0]):
            assert x.tobytes() == y.tobytes()
    if kind == "int":
        np.testing.assert_array_equal(tres[0][0], sum(range(1, world + 1)))


def test_allreduce_avg_max_min():
    def jfn(c, rank):
        a = _jput(np.full((4,), float(rank), np.float32), rank)
        return [_np(c.allreduce([a], op).wait()[0])
                for op in (JReduceOp.AVG, JReduceOp.MAX, JReduceOp.MIN)]

    def tfn(c, rank):
        a = torch.full((4,), float(rank))
        return [_np(c.allreduce([a], op).wait()[0])
                for op in (ReduceOp.AVG, ReduceOp.MAX, ReduceOp.MIN)]

    jres, tres = _both(3, jfn, tfn)
    for j, t in zip(jres, tres):
        for jx, tx in zip(j, t):
            np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(t, [np.full(4, 1.0), np.full(4, 2.0), np.full(4, 0.0)])


def test_allgather_broadcast_alltoall_reduce_scatter_barrier():
    world = 3

    def ins(rank):
        return [np.full((2,), float(rank * 10 + j), np.float32) for j in range(world)]

    def jfn(c, rank):
        a = _jput(np.full((2,), float(rank), np.float32), rank)
        ag = c.allgather(a).wait()
        bc = c.broadcast(a, root=1).wait()
        x = [_jput(v, rank) for v in ins(rank)]
        a2a = c.alltoall(x).wait()
        rs = c.reduce_scatter(x, JReduceOp.SUM).wait()
        c.barrier().wait()
        return _np(ag), _np(bc), _np(a2a), _np(rs)

    def tfn(c, rank):
        a = torch.full((2,), float(rank))
        ag = c.allgather(a).wait()
        bc = c.broadcast(a, root=1).wait()
        x = [torch.from_numpy(v) for v in ins(rank)]
        a2a = c.alltoall(x).wait()
        rs = c.reduce_scatter(x, ReduceOp.SUM).wait()
        c.barrier().wait()
        assert float(a[0]) == rank  # a non-root's input is not overwritten
        return _np(ag), _np(bc), _np(a2a), _np(rs)

    jres, tres = _both(world, jfn, tfn)
    for rank, (j, t) in enumerate(zip(jres, tres)):
        for jx, tx in zip(j, t):
            np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))
        ag, bc, a2a, rs = t
        assert [float(x[0]) for x in ag] == [0.0, 1.0, 2.0]
        assert float(bc[0]) == 1.0
        assert [float(x[0]) for x in a2a] == [j * 10 + rank for j in range(world)]
        assert float(rs[0]) == sum(j * 10 + rank for j in range(world))


def test_send_recv():
    """numpy receive buffers are filled in place; a tensor buffer gets the
    received tensor back."""

    def jfn(c, rank):
        if rank == 0:
            c.send(_jput(np.arange(4, dtype=np.float32), 0), dst=1, tag=7).wait()
            c.send(np.arange(3, dtype=np.int64), dst=1, tag=8).wait()
            c.barrier().wait()
            return None
        got = c.recv(_jput(np.zeros(4, np.float32), 1), src=0, tag=7).wait()
        buf = np.zeros(3, np.int64)
        filled = c.recv(buf, src=0, tag=8).wait()
        assert filled is buf
        c.barrier().wait()
        return _np(got), buf

    def tfn(c, rank):
        if rank == 0:
            src = torch.arange(4, dtype=torch.float32)
            c.send(src, dst=1, tag=7).wait()
            src.zero_()  # a buffered send copied the payload at the call
            c.send(np.arange(3, dtype=np.int64), dst=1, tag=8).wait()
            c.barrier().wait()
            return None
        got = c.recv(torch.zeros(4), src=0, tag=7).wait()
        buf = np.zeros(3, np.int64)
        filled = c.recv(buf, src=0, tag=8).wait()
        assert filled is buf
        c.barrier().wait()
        return _np(got), buf

    jres, tres = _both(2, jfn, tfn)
    for jx, tx in zip(jres[1], tres[1]):
        np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tres[1][0], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(tres[1][1], np.arange(3))


def test_desync_detection():
    """Mismatched op kinds at one SPMD slot fail both groups on both
    packages: the second arriver synchronously, the first via its future."""

    def make_fn(ones, allreduce_op):
        def fn(c, rank):
            a = ones()
            with pytest.raises(RuntimeError, match="desync|reconfigured"):
                c.barrier().wait(T)
                if rank == 0:
                    c.allreduce([a], allreduce_op).wait(T)
                else:
                    c.allgather(a).wait(T)
            return True

        return fn

    jres, tres = _both(2, make_fn(lambda: jnp.ones(2), JReduceOp.SUM),
                       make_fn(lambda: torch.ones(2), ReduceOp.SUM))
    assert all(jres) and all(tres)


@pytest.mark.parametrize("mismatch", ["shape", "dtype"])
def test_incongruent_tensors_desync(mismatch):
    """Two groups' tensors of different shapes or dtypes in one allreduce:
    the same "not congruent" desync error on both packages, in both
    groups."""

    def spec(rank):
        if mismatch == "shape":
            return ((4, 4) if rank == 0 else (2, 8)), np.float32
        return (4, 4), (np.float32 if rank == 0 else np.int32)

    def jfn(c, rank):
        shape, dtype = spec(rank)
        a = _jput(np.ones(shape, dtype), rank)
        with pytest.raises(RuntimeError, match="desync.*congruent"):
            c.allreduce([a]).wait(T)
        return True

    def tfn(c, rank):
        shape, dtype = spec(rank)
        a = torch.from_numpy(np.ones(shape, dtype))
        with pytest.raises(RuntimeError, match="desync.*congruent"):
            c.allreduce([a]).wait(T)
        return True

    jres, tres = _both(2, jfn, tfn)
    assert all(jres) and all(tres)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reconfigure_new_epoch(pkg):
    world = 2
    prefix1, prefix2 = _prefix(), _prefix()
    if pkg == "jax":
        colls = [JDevice(timeout=timedelta(seconds=10)) for _ in range(world)]
    else:
        colls = [_port(timedelta(seconds=10)) for _ in range(world)]

    def run(rank):
        c = colls[rank]
        a = (_jput(np.ones(2, np.float32), rank) if pkg == "jax" else torch.ones(2))
        c.configure(f"{prefix1}/{rank}", rank, world)
        r1 = _np(c.allreduce([a]).wait()[0])
        c.configure(f"{prefix2}/{rank}", rank, world)
        r2 = _np(c.allreduce([a]).wait()[0])
        c.shutdown()
        return r1, r2

    with ThreadPoolExecutor(max_workers=world) as ex:
        for r1, r2 in ex.map(run, range(world)):
            np.testing.assert_array_equal(r1, 2.0)
            np.testing.assert_array_equal(r2, 2.0)


def _pair(pkg, t0, t1):
    """Two collectives joined on one fresh epoch, rank 0 and rank 1."""
    prefix = _prefix()
    make = JDevice if pkg == "jax" else _port
    c0, c1 = make(timedelta(seconds=t0)), make(timedelta(seconds=t1))
    with ThreadPoolExecutor(max_workers=2) as ex:
        list(ex.map(lambda a: a[0].configure(f"{prefix}/{a[1]}", a[1], 2), [(c0, 0), (c1, 1)]))
    ones = jnp.ones(2) if pkg == "jax" else torch.ones(2)
    return c0, c1, ones


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dead_peer_times_out(pkg):
    """A group that never shows up fails the op within the deadline."""
    c0, c1, ones = _pair(pkg, 1, 30)
    work = c0.allreduce([ones])  # rank 1 never calls allreduce
    with pytest.raises(TimeoutError):
        work.wait(T)
    c0.shutdown()
    c1.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reconfigure_fails_pending_ops(pkg):
    """A member leaving resolves the others' in-flight futures with an
    error instead of stranding them."""
    c0, c1, ones = _pair(pkg, 30, 30)
    work = c0.allreduce([ones])
    c1.shutdown()  # leaves the epoch
    with pytest.raises(RuntimeError, match="reconfigured"):
        work.wait(T)
    c0.shutdown()


def test_port_specifics():
    """The plane's labels, its refusal of a missing card, and a healing
    group's zeros leaving the other group's average unperturbed."""
    c = _port(T)
    assert c.device_arrays and c.plane_info() == "device" and c.wire_codec() == "f32"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CollectivesDevice()
    with pytest.raises(RuntimeError, match="configure"):
        c.send(np.zeros(1), dst=0)


def test_many_groups_under_thread_switching():
    """8 groups (more than this box's cores), 40 allreduces each, with the
    interpreter switching threads every microsecond: a lost deposit or a
    result handed to the wrong group breaks the exact sums. The threads the
    test leaves behind are bounded by its own growth: a worker may hold
    threads earlier files left (the JAX package's parked acceptors)."""
    world, rounds = 8, 40
    threads_at_start = threading.active_count()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(c, rank):
            sums = []
            for k in range(rounds):
                out = c.allreduce([torch.full((5,), float(rank * rounds + k))]).wait(T)
                sums.append(float(out[0][0]))
            return sums

        results = _world(_port, world, fn, timeout_s=30)
    finally:
        sys.setswitchinterval(old)
    want = [float(sum(r * rounds + k for r in range(world))) for k in range(rounds)]
    assert all(r == want for r in results)
    # 47: the earlier absolute bound of 50 less the 3 threads a fresh
    # worker holds when this file runs alone (the main thread and the two
    # packages' deadline timers), so the check is as tight on a clean worker
    assert threading.active_count() - threads_at_start < 47
