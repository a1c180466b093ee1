"""The port's state-tree serialization: bit-exact round trips (bf16
included) and, for trees of numpy leaves, exactly the JAX package's
buffers in exactly its order."""

import io
import struct
from datetime import timedelta

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import serialization as jser
from torchft_tpu_torch.checkpointing import serialization as tser
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.utils.tree import tree_leaves


def _state():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 4, generator=g)
    opt = torch.optim.AdamW([w], lr=1e-3, weight_decay=1e-4)
    w.grad = torch.randn(3, 4, generator=g)
    opt.step()
    return {
        "params": {
            "w": w.detach(),
            "b16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "scalar": torch.tensor(3.25),
            "empty": torch.zeros(0, 4),
        },
        "layers": [torch.randn(2, generator=g), (torch.ones(1, dtype=torch.bool), 7)],
        "opt_state": opt.state_dict(),  # ints, floats, None, nested dicts
        "np": np.arange(4, dtype=np.float32),
    }


def _assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.reshape(-1).view(torch.uint8).equal(y.reshape(-1).view(torch.uint8))
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        else:
            assert x == y


def test_round_trip_bit_exact():
    state = _state()
    header, buffers = tser.flatten_state(state)
    _assert_bit_equal(tser.unflatten_state(header, buffers), state)


def _stream(state) -> bytes:
    """The ``u64 header_len | header | buffers`` stream the transport serves."""
    header, buffers = tser.flatten_state(state)
    parts = [struct.pack("<Q", len(header)), header] + [tser.as_bytes(b) for b in buffers]
    return b"".join(bytes(p) for p in parts)


def test_stream_round_trip_and_truncation():
    state = _state()
    data = _stream(state)
    _assert_bit_equal(tser.load_state(io.BytesIO(data)), state)
    with pytest.raises(EOFError):
        tser.load_state(io.BytesIO(data[:-3]))


def test_flatten_copies_tensors():
    """Staged buffers never alias live parameters (the optimizer updates
    them in place while a checkpoint may still be served)."""
    w = torch.zeros(8)
    _, (buf,) = tser.flatten_state({"w": w})
    w += 1
    assert not buf.any()


def test_numpy_tree_buffers_equal_jax_layout():
    rng = np.random.default_rng(0)
    tree = {
        "z": rng.standard_normal((3, 2)).astype(np.float32),
        "a": {"k": np.arange(5, dtype=np.int32), "b": rng.standard_normal(4)},
        "m": [np.ones((2, 2), np.float16), np.zeros(3, np.uint8)],
    }
    _, jbufs = jser.flatten_state(tree)
    header, tbufs = tser.flatten_state(tree)
    assert len(jbufs) == len(tbufs)
    for j, t in zip(jbufs, tbufs):
        assert j.dtype == t.dtype and j.shape == t.shape
        assert j.tobytes() == t.tobytes()
    _, infos = __import__("pickle").loads(header)
    assert tser.buffer_sizes(infos) == [b.nbytes for b in jbufs]


def test_http_transport_round_trip():
    """Single-source heal path: stage on one transport, fetch from another."""
    state = _state()
    src = HTTPTransport(timeout=timedelta(seconds=10), hostname="localhost")
    dst = HTTPTransport(timeout=timedelta(seconds=10), hostname="localhost")
    try:
        src.send_checkpoint([1], step=3, state_dict=state, timeout=timedelta(seconds=10))
        got = dst.recv_checkpoint(0, src.metadata(), step=3, timeout=timedelta(seconds=10))
        _assert_bit_equal(got, state)
        src.disallow_checkpoint()
    finally:
        src.shutdown()
        dst.shutdown()
