"""The port's CollectivesTransport against the JAX package's.

* A state tree of mixed dtypes (float32, bfloat16, int64 and a 0-d scalar)
  crosses each package's transport, over CollectivesTcp and over
  CollectivesDevice. The receivers see the same frames: the same data
  bytes under the same per-buffer tags, and headers with the same fields
  (dtype, shape and nbytes of every buffer), but for one: the JAX package
  stages a 0-d leaf through ``np.ascontiguousarray``, which makes it 1-d,
  so its header says shape (1,) where the port's keeps (). The port's
  tree comes back bit for bit.
* The round trip and the windowed fan-out to two destinations of
  ``tests/test_checkpointing.py`` (its CollectivesTransport cases), on the
  port over both planes.
* A receive that dies mid-window, then a retry: the dead attempt's recvs
  stay posted, and the retry's salted tags keep them from claiming its
  frames. Run on both packages' transports over their device planes.
"""

import pickle
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing.collectives_transport import (
    CollectivesTransport as JTransport,
)
from torchft_tpu_torch.checkpointing import CollectivesTransport
from torchft_tpu_torch.checkpointing import collectives_transport as tct
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.collectives_device import CollectivesDevice
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves

T = timedelta(seconds=20)


def _group(pkg, plane, n, timeout=T):
    """``n`` configured collectives of one package and plane, and a
    cleanup function."""
    if plane == "tcp":
        if pkg == "jax":
            from torchft_tpu.collectives import CollectivesTcp as Tcp
            from torchft_tpu.store import StoreServer as Store
        else:
            Tcp, Store = CollectivesTcp, StoreServer
        store = Store()
        addr = f"{store.address()}/{uuid.uuid4().hex}"
        colls = [Tcp(timeout=timeout) for _ in range(n)]
    else:
        store = None
        addr = f"store:0/torchft/{uuid.uuid4().hex}"
        if pkg == "jax":
            from torchft_tpu.collectives_device import CollectivesDevice as JDevice

            colls = [JDevice(timeout=timeout) for _ in range(n)]
        else:
            colls = [CollectivesDevice(timeout=timeout, device="cpu") for _ in range(n)]
    # the Manager's epoch address: `{store}/torchft/{quorum_id}/{local rank}`,
    # local rank 0 in every group here
    with ThreadPoolExecutor(max_workers=n) as pool:
        list(pool.map(lambda i: colls[i].configure(f"{addr}/0", i, n), range(n)))

    def close():
        for c in colls:
            c.shutdown()
        if store is not None:
            store.shutdown()

    return colls, close


class _Recording:
    """Delegates to a collectives; logs ``(tag, bytes)`` of every frame it
    receives into a numpy buffer, as the receive completes."""

    def __init__(self, inner):
        self._inner = inner
        self.frames = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def recv(self, arr, src, tag=0):
        work = self._inner.recv(arr, src, tag)

        def record(f):
            out = f.value()
            self.frames.append((tag, np.asarray(arr).tobytes()))
            return out

        return type(work)(work.get_future().then(record))


def _transfer(pkg, plane, state, receivers=(1,)):
    """Send ``state`` from rank 0 to ``receivers`` over one package's
    transport; returns each receiver's tree and its recorded frames."""
    Transport = JTransport if pkg == "jax" else CollectivesTransport
    colls, close = _group(pkg, plane, 1 + max(receivers))
    try:
        rec = {r: _Recording(colls[r]) for r in receivers}
        sender = Transport(colls[0], timeout=T)
        with ThreadPoolExecutor(max_workers=1 + len(receivers)) as pool:
            fs = pool.submit(sender.send_checkpoint, list(receivers), 5, state, T)
            frs = {r: pool.submit(Transport(rec[r], timeout=T).recv_checkpoint,
                                  0, "<collectives>", 5, T) for r in receivers}
            fs.result(timeout=60)
            outs = {r: f.result(timeout=60) for r, f in frs.items()}
        # the device plane's buffered sends live until the epoch ends: every
        # member leaves only after every receive completed
        with ThreadPoolExecutor(max_workers=len(colls)) as pool:
            list(pool.map(lambda c: c.barrier().wait(T), colls))
        return {r: (outs[r], rec[r].frames) for r in receivers}
    finally:
        close()


def _mixed_trees():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b16 = rng.standard_normal((4, 6)).astype(jnp.bfloat16)
    ids = np.arange(7, dtype=np.int64) * 1_000_000_007
    scalar = np.array(3.25, dtype=np.float32)
    jtree = {"w": w, "b16": np.asarray(b16), "ids": ids, "scalar": scalar}
    ttree = {
        "w": torch.from_numpy(w.copy()),
        "b16": torch.from_numpy(np.asarray(b16).view(np.int16).copy()).view(torch.bfloat16),
        "ids": torch.from_numpy(ids.copy()),
        "scalar": torch.from_numpy(scalar.copy()),
    }
    return jtree, ttree


def _split(frames):
    """(header bytes, {buffer index: bytes}) from a receiver's frames."""
    header, data = None, {}
    for tag, raw in frames:
        if tag & ~0xF == tct._HDR_TAG0:
            header = raw
        elif tag & ~0xFFFF == tct._DATA_TAG0:
            data[tag & 0xFFF] = raw
    return header, data


def _buffer_fields(header):
    _, infos = pickle.loads(header)
    return [tuple(info[1:4]) for info in infos if info[0] in ("arr", "tensor")]


def _assert_bit_equal(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            assert g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.reshape(-1).view(torch.uint8).equal(w.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("plane", ["tcp", "device"])
def test_mixed_tree_frames_equal_jax(plane):
    jtree, ttree = _mixed_trees()
    (jout, jframes), = _transfer("jax", plane, jtree).values()
    (tout, tframes), = _transfer("port", plane, ttree).values()
    _assert_bit_equal(tout, ttree)
    jhdr, jdata = _split(jframes)
    thdr, tdata = _split(tframes)
    fields = [("bfloat16", (4, 6), 48), ("int64", (7,), 56), ("float32", (), 4),
              ("float32", (3, 5), 60)]
    assert _buffer_fields(thdr) == fields
    fields[2] = ("float32", (1,), 4)  # the JAX package's 0-d leaf, made 1-d
    assert _buffer_fields(jhdr) == fields
    assert sorted(tdata) == sorted(jdata) == [0, 1, 2, 3]
    for i in jdata:
        assert tdata[i] == jdata[i], f"buffer {i}"
    # the length frame carries (header length, salt) on the fixed tag
    lens = [raw for tag, raw in tframes if tag == tct._META_TAG]
    assert len(lens) == 1 and np.frombuffer(lens[0], np.int64)[0] == len(thdr)
    np.testing.assert_array_equal(np.asarray(jout["ids"]), ttree["ids"].numpy())


@pytest.mark.parametrize("plane", ["tcp", "device"])
def test_roundtrip(plane):
    """tests/test_checkpointing.py's round trip, on the port."""
    _, state = _mixed_trees()
    state = {"params": state, "step": 3, "opt": {"lr": 0.1, "m": [torch.ones(2, 2)]}}
    (out, _), = _transfer("port", plane, state).values()
    _assert_bit_equal(out, state)
    assert out["step"] == 3 and out["opt"]["lr"] == 0.1


@pytest.mark.parametrize("plane", ["tcp", "device"])
def test_parallel_fanout_windowed(plane):
    """A many-buffer state to two healing replicas at once (at most 3
    buffers in flight per destination, destinations in parallel) lands
    intact on both."""
    state = {f"leaf{i}": torch.full((4096,), float(i)) for i in range(24)}
    outs = _transfer("port", plane, state, receivers=(1, 2))
    for out, frames in outs.values():
        _assert_bit_equal(out, state)
        assert len(_split(frames)[1]) == 24


class _CutAfter:
    """A sender that dies after ``n`` data frames: further sends raise."""

    def __init__(self, inner, n):
        self._inner = inner
        self._left = n

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def send(self, arr, dst, tag=0):
        if tag & ~0xFFFF == tct._DATA_TAG0:
            if self._left == 0:
                raise ConnectionError("sender died mid-transfer")
            self._left -= 1
        return self._inner.send(arr, dst, tag)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_retry_after_a_receive_dies_mid_window(pkg):
    """Attempt 1: the sender dies after 2 of 6 buffers, so the receiver's
    window still has recvs posted (buffers 2-4) when it times out. The
    retry's frames carry a new salt, so those stale recvs cannot claim
    them, and the retry lands the new state whole."""
    Transport = JTransport if pkg == "jax" else CollectivesTransport

    def state(base):
        if pkg == "jax":
            return {f"b{i}": np.full(16, base + i, np.float32) for i in range(6)}
        return {f"b{i}": torch.full((16,), float(base + i)) for i in range(6)}

    colls, close = _group(pkg, "device", 2, timeout=timedelta(seconds=30))
    try:
        recv = Transport(colls[1], timeout=T)
        dead = Transport(_CutAfter(colls[0], 2), timeout=T)
        with pytest.raises(ConnectionError):
            dead.send_checkpoint([1], 1, state(0), T)
        with pytest.raises(TimeoutError):
            recv.recv_checkpoint(0, "<collectives>", 1, timedelta(seconds=0.5))
        Transport(colls[0], timeout=T).send_checkpoint([1], 2, state(100), T)
        got = recv.recv_checkpoint(0, "<collectives>", 2, timedelta(seconds=5))
        for i in range(6):
            np.testing.assert_array_equal(np.asarray(got[f"b{i}"]), np.full(16, 100.0 + i))
        done = threading.Event()
        threading.Thread(target=lambda: (colls[0].barrier().wait(T), done.set()),
                         daemon=True).start()
        colls[1].barrier().wait(T)
        assert done.wait(10)
    finally:
        close()


def test_metadata_and_exports():
    from torchft_tpu_torch import checkpointing

    assert checkpointing.CollectivesTransport is CollectivesTransport
    colls, close = _group("port", "device", 1)
    try:
        assert CollectivesTransport(colls[0], timeout=T).metadata() == "<collectives>"
    finally:
        close()
