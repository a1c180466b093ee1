"""Wire codecs and error feedback — the port's copy of
``torchft_tpu/wire_codec.py``, the compression layer of the cross-group
gradient plane.

A codec maps a float32 chunk to its wire form and back:

* ``f32``      — identity (4 bytes an element), the exact default;
* ``bfloat16`` — round to nearest even (2 bytes an element);
* ``int8``     — per-chunk symmetric quantization (1 byte an element and a
  4-byte float32 scale header a chunk): ``scale = max|x| / 127``,
  ``q = clip(rint(x / scale), -127, 127)``.

Codecs apply on the wire: the native striped plane (``native/dataplane.cc``
has the same byte formats) and the Python ring (``collectives.py``) ship
codec bytes a hop while reducing in float32. The decoded average is
bitwise identical on every rank by construction: the owner of each fully
reduced chunk encodes it once and decodes those bytes into its own copy,
and the allgather forwards the owner's bytes verbatim.

:class:`ErrorFeedback` keeps a lossy wire honest (Karimireddy et al.,
EF-SGD): each step's quantization residual is added back before the next
quantize, with commit-lineage semantics (``commit()`` promotes the step's
residual, ``rollback()`` drops it) and ``state_dict`` for heals.
:func:`lowrank_basis` is the basis ``Q`` of DiLoCo's PowerSGD-style
rank-r outer step, drawn from a seeded generator so every group derives
the same one; DiLoCo computes ``P = M @ Q`` and ``P @ Q^T`` in torch.

The bfloat16 codec is numpy bit arithmetic (the JAX package casts through
``ml_dtypes``, which the port does not need): its bytes equal that cast's,
NaN included (a quiet NaN of the input's sign, as ``ml_dtypes`` gives; the
native ``f32_to_bf16`` keeps the high payload bits instead). All scratch
is preallocated per codec and grows monotonically.
"""

from __future__ import annotations

import logging
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "WireCodec",
    "F32Codec",
    "Bf16Codec",
    "Int8Codec",
    "get_codec",
    "CODEC_NAMES",
    "ErrorFeedback",
    "ErrorFeedbackBinding",
    "LowRankErrorFeedback",
    "lowrank_basis",
    "lowrank_eligible",
]

_SCALE_HDR = struct.Struct("<f")  # int8 per-chunk scale prefix (LE f32)

CODEC_NAMES = ("f32", "bfloat16", "int8")


class WireCodec:
    """One codec instance per collectives backend; it owns the encode and
    decode scratch (used by one thread, the collective op thread). Lossy
    codecs apply only to float32 arrays."""

    name = "f32"
    lossy = False

    def __init__(self) -> None:
        self._wire: Optional[np.ndarray] = None  # uint8 encode scratch
        self._f32: Optional[np.ndarray] = None   # f32 decode scratch

    def wire_nbytes(self, nelems: int, itemsize: int = 4) -> int:
        raise NotImplementedError

    def ensure_capacity(self, max_elems: int, itemsize: int = 4) -> None:
        """Grow the scratch to hold one chunk of ``max_elems``."""
        need = self.wire_nbytes(max_elems, itemsize)
        if self._wire is None or self._wire.size < need:
            self._wire = np.empty(need, dtype=np.uint8)
        if self.lossy and (self._f32 is None or self._f32.size < max_elems):
            self._f32 = np.empty(max_elems, dtype=np.float32)

    def encode_into(self, src: np.ndarray) -> memoryview:
        """Encode the 1-D chunk ``src`` into the scratch; returns the wire
        bytes (valid until the next ``encode_into``)."""
        raise NotImplementedError

    def decode_into(self, wire: np.ndarray, dst: np.ndarray) -> None:
        """Decode wire bytes into the 1-D chunk ``dst``, overwriting it."""
        raise NotImplementedError

    def decode_tmp(self, wire: np.ndarray, nelems: int) -> np.ndarray:
        """Decode into the codec's own float32 scratch (for the reduce
        steps); valid until the next ``decode_tmp`` or ``encode_into``."""
        raise NotImplementedError

    def roundtrip(self, arr: np.ndarray) -> None:
        """In place ``arr = decode(encode(arr))``: the projection onto the
        wire's grid that error feedback measures its residual against."""
        flat = arr.reshape(-1)
        self.ensure_capacity(flat.size, arr.dtype.itemsize)
        w = self.encode_into(flat)
        self.decode_into(np.frombuffer(w, dtype=np.uint8), flat)


class F32Codec(WireCodec):
    """Identity codec: the array's raw bytes, any dtype."""

    name = "f32"
    lossy = False

    def wire_nbytes(self, nelems: int, itemsize: int = 4) -> int:
        return nelems * itemsize

    def encode_into(self, src: np.ndarray) -> memoryview:
        # zero copy: the chunk's own bytes are the wire form
        return memoryview(np.ascontiguousarray(src)).cast("B")

    def decode_into(self, wire: np.ndarray, dst: np.ndarray) -> None:
        dst.view(np.uint8).reshape(-1)[:] = np.frombuffer(
            wire, dtype=np.uint8, count=dst.nbytes
        )

    def decode_tmp(self, wire: np.ndarray, nelems: int) -> np.ndarray:
        raise NotImplementedError(
            "identity codec callers reduce straight from the typed view"
        )

    def roundtrip(self, arr: np.ndarray) -> None:  # exact: nothing to do
        return


class Bf16Codec(WireCodec):
    """float32 -> bfloat16 by round to nearest even, 2 bytes an element,
    in numpy bit arithmetic: ``(x + 0x7FFF + ((x >> 16) & 1)) >> 16``, and
    a NaN becomes the quiet NaN ``0x7FC0`` with its sign (what an
    ``ml_dtypes`` cast gives)."""

    name = "bfloat16"
    lossy = True

    def __init__(self) -> None:
        super().__init__()
        self._u32: Optional[np.ndarray] = None   # rounding scratch
        self._nan: Optional[np.ndarray] = None   # NaN mask scratch

    def wire_nbytes(self, nelems: int, itemsize: int = 4) -> int:
        return nelems * 2

    def ensure_capacity(self, max_elems: int, itemsize: int = 4) -> None:
        super().ensure_capacity(max_elems, itemsize)
        if self._u32 is None or self._u32.size < max_elems:
            self._u32 = np.empty(max_elems, dtype=np.uint32)
            self._nan = np.empty(max_elems, dtype=bool)

    def encode_into(self, src: np.ndarray) -> memoryview:
        n = src.size
        self.ensure_capacity(n)
        bits = np.ascontiguousarray(src, dtype=np.float32).reshape(-1).view(np.uint32)
        t = self._u32[:n]
        out = self._wire[: n * 2].view(np.uint16)
        np.right_shift(bits, 16, out=t)
        np.bitwise_and(t, 1, out=t)
        np.add(t, 0x7FFF, out=t)
        np.add(t, bits, out=t)  # wraps only for NaNs, which are replaced
        np.right_shift(t, 16, out=t)
        out[:] = t  # casting assignment: the low 16 bits
        nan = self._nan[:n]
        np.isnan(src.reshape(-1), out=nan)
        if nan.any():
            np.right_shift(bits, 16, out=t)
            np.bitwise_and(t, 0x8000, out=t)
            np.bitwise_or(t, 0x7FC0, out=t)
            np.copyto(out, t, casting="unsafe", where=nan)
        return memoryview(self._wire[: n * 2])

    def decode_into(self, wire: np.ndarray, dst: np.ndarray) -> None:
        n = dst.size
        half = np.frombuffer(wire, dtype=np.uint16, count=n)
        d = dst.reshape(-1).view(np.uint32)
        d[:] = half
        np.left_shift(d, 16, out=d)

    def decode_tmp(self, wire: np.ndarray, nelems: int) -> np.ndarray:
        self.ensure_capacity(nelems)
        out = self._f32[:nelems]
        self.decode_into(wire, out)
        return out


class Int8Codec(WireCodec):
    """Per-chunk symmetric int8: a 4-byte float32 scale header, then one
    int8 an element. ``scale = max|x|/127`` adapts per chunk per hop, so
    the reduce-scatter's partial sums re-quantize at their own magnitude.
    A chunk holding a non-finite value encodes ``scale = NaN`` and a zero
    payload, so the NaN reaches the decoded average."""

    name = "int8"
    lossy = True

    def wire_nbytes(self, nelems: int, itemsize: int = 4) -> int:
        return 4 + nelems

    def encode_into(self, src: np.ndarray) -> memoryview:
        n = src.size
        self.ensure_capacity(n)
        wire = self._wire[: 4 + n]
        tmp = self._f32[:n]
        np.abs(src, out=tmp)
        amax = float(tmp.max()) if n else 0.0
        q = wire[4:].view(np.int8)
        if not np.isfinite(amax):
            _SCALE_HDR.pack_into(wire.data, 0, np.float32(np.nan))
            q.fill(0)
            return memoryview(wire)
        scale = np.float32(amax / 127.0) if amax > 0.0 else np.float32(0.0)
        _SCALE_HDR.pack_into(wire.data, 0, scale)
        if scale == 0.0:
            q.fill(0)
            return memoryview(wire)
        np.divide(src, scale, out=tmp)
        np.rint(tmp, out=tmp)
        np.clip(tmp, -127.0, 127.0, out=tmp)
        q[:] = tmp  # casting assignment
        return memoryview(wire)

    def _scale_of(self, wire: np.ndarray) -> float:
        return _SCALE_HDR.unpack_from(
            np.frombuffer(wire, dtype=np.uint8, count=4).tobytes(), 0
        )[0]

    def decode_into(self, wire: np.ndarray, dst: np.ndarray) -> None:
        n = dst.size
        scale = self._scale_of(wire)
        q = np.frombuffer(wire, dtype=np.int8, count=4 + n)[4:]
        dst[:] = q
        np.multiply(dst, np.float32(scale), out=dst)

    def decode_tmp(self, wire: np.ndarray, nelems: int) -> np.ndarray:
        self.ensure_capacity(nelems)
        out = self._f32[:nelems]
        self.decode_into(wire, out)
        return out


def get_codec(name: Optional[str]) -> WireCodec:
    """Codec by wire-dtype name (``None``, "f32" or "float32": identity)."""
    if name in (None, "", "f32", "float32"):
        return F32Codec()
    if name == "bfloat16":
        return Bf16Codec()
    if name == "int8":
        return Int8Codec()
    raise ValueError(f"unknown wire codec {name!r}; expected one of {CODEC_NAMES}")


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------


class ErrorFeedback:
    """Per-bucket quantization residuals with commit-lineage semantics.

    Per step and bucket, ``apply(key, buf)`` adds the committed residual
    into ``buf``, projects ``buf`` onto the codec's grid in place and
    stages the new residual as pending; ``commit()`` promotes it after a
    committed step and ``rollback()`` drops it after an abort or a veto, so
    a discarded step's residual never compensates the next one.

    The residual measures the bucket-level projection. For bf16 (a grid
    per element) the wire's encode of the projected values is exact. For
    int8 the wire re-quantizes per ring chunk (and per native stripe) with
    its own scale, which adds a finer, bounded error that stays
    uncompensated, of the same class as the reduce-scatter's per-hop
    re-quantization. ``state_dict`` carries the committed residuals through
    heals."""

    def __init__(self, codec: WireCodec) -> None:
        if not codec.lossy:
            raise ValueError("error feedback is meaningless on an exact codec")
        self._codec = codec
        self._acc: Dict[str, np.ndarray] = {}       # committed residuals
        self._pending: Dict[str, np.ndarray] = {}   # this step's residuals
        self._pre: Dict[str, np.ndarray] = {}       # reusable pre-quant copies

    @property
    def codec(self) -> WireCodec:
        return self._codec

    def apply(self, key: str, buf: np.ndarray) -> None:
        """Compensate and project ``buf`` (owned, float32, 1-D) in place and
        stage its new residual under ``key`` (stable across steps: bucket
        ordinal and size; a key whose size changed is dropped)."""
        if buf.dtype != np.float32:
            return  # the lossy wire applies only to float32 buffers
        acc = self._acc.get(key)
        if acc is not None:
            if acc.size == buf.size:
                buf += acc
            else:
                del self._acc[key]  # the bucket plan changed: residual stale
        pre = self._pre.get(key)
        if pre is None or pre.size != buf.size:
            pre = np.empty_like(buf)
            self._pre[key] = pre
        pre[:] = buf
        self._codec.roundtrip(buf)  # project onto the wire grid
        np.subtract(pre, buf, out=pre)
        self._pending[key] = pre

    def commit(self) -> None:
        """Promote this step's pending residuals (the step committed)."""
        for key, pre in self._pending.items():
            acc = self._acc.get(key)
            if acc is None or acc.size != pre.size:
                self._acc[key] = pre.copy()
            else:
                acc[:] = pre
        self._pending.clear()

    def rollback(self) -> None:
        """Drop this step's pending residuals (an abort or a veto); the
        committed ones stay, as the retried step needs them."""
        self._pending.clear()

    def pending_keys(self) -> Tuple[str, ...]:
        return tuple(self._pending)

    def state_dict(self) -> Dict[str, Any]:
        # committed residuals only: a pending one belongs to an unresolved
        # lineage and never travels through a heal
        return {
            "codec": self._codec.name,
            "acc": {k: v.copy() for k, v in self._acc.items()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("codec") not in (None, self._codec.name):
            # the residuals measure another grid: start clean
            logger.warning(
                "error-feedback state was recorded for codec %r but the "
                "live codec is %r; dropping accumulators",
                state.get("codec"), self._codec.name,
            )
            self._acc = {}
        else:
            self._acc = {
                k: np.asarray(v, dtype=np.float32).copy()
                for k, v in state.get("acc", {}).items()
            }
        self._pending.clear()


class ErrorFeedbackBinding:
    """Which :class:`ErrorFeedback` applies to a manager's live data plane;
    shared by ``ManagedOptimizer`` and ``LocalSGD`` / ``DiLoCo``.

    ``explicit=None`` is auto mode: the accumulator is made as soon as a
    lossy codec is seen, at construction if the plane reports one, else in
    :meth:`live`. ``live()`` also turns
    compensation off while the transport is exact (CMA): projecting onto
    a codec grid with no lossy wire underneath would add error.
    ``explicit=False`` disables; an :class:`ErrorFeedback` is used as
    given."""

    def __init__(self, manager: Any, explicit: Any = None) -> None:
        self._manager = manager
        self._auto = False
        self.instance: Optional[ErrorFeedback] = None
        if explicit is None:
            self._auto = True
            codec = get_codec(self._codec_name())
            if codec.lossy:
                self.instance = ErrorFeedback(codec)
        elif explicit is not False:
            self.instance = explicit

    def _codec_name(self) -> str:
        fn = getattr(self._manager, "wire_codec", None)
        return fn() if callable(fn) else "f32"

    def live(self) -> Optional[ErrorFeedback]:
        """The error feedback for this step or sync; None while the live
        transport is exact."""
        name = self._codec_name()
        if name == "f32":
            return None
        if self.instance is None and self._auto:
            codec = get_codec(name)
            if codec.lossy:
                self.instance = ErrorFeedback(codec)
        return self.instance

    def ensure_for_state(self, ef_state: Any) -> Optional[ErrorFeedback]:
        """A heal carries EF state that may land before auto mode has made
        the instance: make it from the state's own codec name, so the
        accumulators are adopted, not dropped."""
        if self.instance is None and self._auto and isinstance(ef_state, dict):
            try:
                codec = get_codec(ef_state.get("codec"))
            except ValueError:
                return None  # an unknown codec in foreign state
            if codec.lossy:
                self.instance = ErrorFeedback(codec)
        return self.instance


# ---------------------------------------------------------------------------
# PowerSGD-style low-rank projection (DiLoCo's outer step)
# ---------------------------------------------------------------------------


def lowrank_basis(shape: Tuple[int, int], rank: int, seed: int) -> np.ndarray:
    """Orthonormal basis ``Q`` (n x rank) for the rank-r projection of an
    (m x n) matrix, from ``default_rng(seed)`` and ``np.linalg.qr``: every
    group derives the same ``Q`` from the same (leaf, sync ordinal) without
    shipping it, as long as all run the same numpy and LAPACK build."""
    _m, n = shape
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, rank)).astype(np.float32)
    q, _r = np.linalg.qr(g)
    return np.ascontiguousarray(q, dtype=np.float32)


def lowrank_eligible(shape: Tuple[int, ...], rank: int) -> bool:
    """A leaf is worth projecting when it is a 2-D matrix whose rank-r
    form is much smaller than the dense one."""
    if len(shape) != 2 or rank <= 0:
        return False
    m, n = shape
    return min(m, n) >= 4 * rank


class LowRankErrorFeedback:
    """The residual carry of DiLoCo's low-rank outer step, with
    :class:`ErrorFeedback`'s commit and rollback contract; the residual is
    the projection error ``M - P Q^T`` per leaf. Works on numpy arrays and
    on torch tensors alike (the port keeps them on the backup's device)."""

    def __init__(self) -> None:
        self._acc: Dict[str, Any] = {}
        self._pending: Dict[str, Any] = {}

    def compensate(self, key: str, mat: Any) -> Any:
        acc = self._acc.get(key)
        if acc is not None and tuple(acc.shape) == tuple(mat.shape):
            return mat + acc
        return mat

    def stage(self, key: str, mat: Any, approx: Any) -> None:
        self._pending[key] = mat - approx

    def commit(self) -> None:
        self._acc.update(self._pending)
        self._pending = {}

    def rollback(self) -> None:
        self._pending = {}

    def state_dict(self) -> Dict[str, Any]:
        return {"acc": {k: v.copy() if isinstance(v, np.ndarray) else v.clone()
                        for k, v in self._acc.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._acc = {
            k: np.asarray(v, dtype=np.float32).copy() if isinstance(v, np.ndarray)
            else v.detach().clone()
            for k, v in state.get("acc", {}).items()
        }
        self._pending = {}
