"""Streaming state-tree (de)serialization for checkpoint transfer — the
port's counterpart of ``torchft_tpu/checkpointing/serialization.py``.

A state tree is nested dicts / lists / tuples whose leaves are tensors,
numpy arrays or any picklable object (e.g. a ``torch.optim`` state dict).
The wire layout is the JAX package's::

    u64 header_len | pickle((treedef, leaf_infos)) | raw buffers...

where ``leaf_infos[i]`` is

* ``("arr", dtype_str, shape, nbytes)`` — a numpy leaf, one buffer;
* ``("tensor", dtype_str, shape, nbytes)`` — a torch tensor leaf, one
  buffer of its raw bytes (bfloat16 ships as its two bytes per element;
  CUDA tensors are copied to the host at flatten time);
* ``("obj", pickled_bytes)`` — any other leaf (inline, no buffer).

Leaves are visited in ``jax.tree_util`` order (sorted dict keys), so for a
tree of numpy leaves the buffers are exactly the JAX package's buffers.
Unflattened tensors lie on the host; the receiver's ``load_state_dict``
copies them into its own tensors, on its own device. A tensor leaf
unflattened from a writable buffer (a view into the striped heal's one
receive buffer) shares its memory; only a read-only or misaligned buffer
is copied.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, BinaryIO, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.utils.tree import tree_flatten, tree_unflatten

_LEN = struct.Struct("<Q")

__all__ = [
    "flatten_state",
    "unflatten_state",
    "buffer_sizes",
    "as_bytes",
    "load_state",
    "read_exact",
    "TensorSpec",
    "spec_tree_from_header",
]


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown tensor dtype {name!r} in checkpoint header")
    return dtype


def _tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``'s bytes as a flat uint8 array that owns its
    memory (the staged checkpoint must not alias live parameters)."""
    host = t.detach().to("cpu", copy=True).contiguous()
    return host.reshape(-1).view(torch.uint8).numpy()


def as_bytes(arr: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def flatten_state(state: Any) -> Tuple[bytes, List[np.ndarray]]:
    """Flatten a state tree into ``(header_bytes, host_buffers)``."""
    leaves, treedef = tree_flatten(state)
    infos: List[Tuple] = []
    buffers: List[np.ndarray] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            host = _tensor_to_host(leaf)
            dtype = str(leaf.dtype).removeprefix("torch.")
            infos.append(("tensor", dtype, tuple(leaf.shape), host.nbytes))
            buffers.append(host)
        elif isinstance(leaf, np.ndarray):
            host = np.ascontiguousarray(leaf)
            infos.append(("arr", host.dtype.name, host.shape, host.nbytes))
            buffers.append(host)
        else:
            infos.append(("obj", pickle.dumps(leaf)))
    return pickle.dumps((treedef, infos)), buffers


def buffer_sizes(infos: List[Tuple]) -> List[int]:
    """Byte size of every raw buffer after the header, in stream order."""
    return [info[3] for info in infos if info[0] in ("arr", "tensor")]


def _tensor_from_buffer(buf: Any, dtype: torch.dtype, shape: Tuple[int, ...]) -> torch.Tensor:
    """A host tensor over ``buf``'s bytes: a view when the buffer is
    writable and aligned to the element size, else a copy (torch wants
    writable memory, and a misaligned element is slow or faulty)."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    if not raw.size:
        return torch.empty(shape, dtype=dtype)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    if not raw.flags.writeable or raw.ctypes.data % itemsize:
        raw = raw.copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def unflatten_state(
    header: bytes,
    buffers: List[Union[np.ndarray, bytes, bytearray, memoryview]],
) -> Any:
    """Inverse of :func:`flatten_state`; tensor leaves are host tensors."""
    treedef, infos = pickle.loads(header)
    leaves: List[Any] = []
    it = iter(buffers)
    for info in infos:
        if info[0] == "arr":
            _, dtype, shape, _ = info
            leaves.append(np.frombuffer(next(it), dtype=np.dtype(dtype)).reshape(shape))
        elif info[0] == "tensor":
            _, dtype, shape, _ = info
            leaves.append(_tensor_from_buffer(next(it), _torch_dtype(dtype), shape))
        else:
            leaves.append(pickle.loads(info[1]))
    return tree_unflatten(treedef, leaves)


class TensorSpec(NamedTuple):
    """Shape and torch dtype of a leaf still in transit."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec_tree_from_header(header: bytes) -> Any:
    """The transferred tree's shape from its header alone: a
    :class:`TensorSpec` for every tensor or array leaf (numpy dtypes
    mapped to torch's), the objects themselves for the other leaves. The
    header arrives before the bulk bytes, so a healer can prepare for the
    incoming state (``header_cb``) while the stripes stream."""
    treedef, infos = pickle.loads(header)
    leaves: List[Any] = []
    for info in infos:
        if info[0] == "tensor":
            leaves.append(TensorSpec(tuple(info[2]), _torch_dtype(info[1])))
        elif info[0] == "arr":
            np_dtype = np.dtype(info[1])
            leaves.append(TensorSpec(tuple(info[2]), torch.from_numpy(np.empty(0, np_dtype)).dtype))
        else:
            leaves.append(pickle.loads(info[1]))
    return tree_unflatten(treedef, leaves)


def load_state(f: BinaryIO) -> Any:
    """Read one ``u64 header_len | header | buffers`` stream (what the HTTP
    transport serves) and unflatten it."""
    (header_len,) = _LEN.unpack(f.read(_LEN.size))
    header = f.read(header_len)
    _, infos = pickle.loads(header)
    buffers: List[bytearray] = []
    for nbytes in buffer_sizes(infos):
        buffers.append(read_exact(f, nbytes))
    return unflatten_state(header, buffers)


def read_exact(f: BinaryIO, nbytes: int) -> bytearray:
    """``nbytes`` from ``f`` into a fresh writable buffer (the tensors
    unflattened from it are views, not a second copy); EOFError if the
    stream ends first."""
    out = bytearray(nbytes)
    view = memoryview(out)
    got = 0
    while got < nbytes:
        k = f.readinto(view[got:])
        if not k:
            raise EOFError(f"truncated checkpoint stream ({got}/{nbytes} bytes)")
        got += k
    return out

