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
copies them into its own tensors, on its own device.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, BinaryIO, List, Tuple, Union

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
            raw = np.frombuffer(next(it), dtype=np.uint8)
            if raw.size:
                t = torch.from_numpy(raw.copy()).view(_torch_dtype(dtype)).reshape(shape)
            else:
                t = torch.empty(shape, dtype=_torch_dtype(dtype))
            leaves.append(t)
        else:
            leaves.append(pickle.loads(info[1]))
    return tree_unflatten(treedef, leaves)


def load_state(f: BinaryIO) -> Any:
    """Read one ``u64 header_len | header | buffers`` stream (what the HTTP
    transport serves) and unflatten it."""
    (header_len,) = _LEN.unpack(f.read(_LEN.size))
    header = f.read(header_len)
    _, infos = pickle.loads(header)
    buffers: List[bytes] = []
    for nbytes in buffer_sizes(infos):
        raw = f.read(nbytes)
        if len(raw) != nbytes:
            raise EOFError("truncated checkpoint stream")
        buffers.append(raw)
    return unflatten_state(header, buffers)

