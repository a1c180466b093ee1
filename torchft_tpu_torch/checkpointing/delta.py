"""Differential heal: changed-leaf checkpoint deltas — the port's copy of
``torchft_tpu/checkpointing/delta.py``.

A replica that was absent for a few steps usually still holds a bit-exact
copy of the committed state at its last committed step (every committed
step's state is identical on every group). The serving side keeps a
bounded **commit trail** of per-leaf digests at recent committed steps,
and a healer that reports ``(last_step, tree_digest)`` receives only the
leaves whose digest changed since. It falls back to a full heal when the
trail has no entry for that step (an absence past the horizon), when the
digests disagree (the healer's copy is not the committed lineage), or
when the leaf layout changed.

Safety is digest-anchored end to end: a delta is built only when the
healer's whole-tree digest at ``last_step`` matches the trail's, and an
unchanged leaf is kept from the healer's own buffers only because its
digest matches the server's.

Wire shape of a delta response (one body)::

    u64 manifest_len | pickle(manifest) | changed raw buffers...

with ``manifest = {"mode": "delta", "header": bytes, "changed": [idx...],
"sizes": [nbytes...]}``, or ``{"mode": "full"}`` (no payload) when the
server declines.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from torchft_tpu_torch.checkpointing.serialization import as_bytes

__all__ = [
    "leaf_digests",
    "tree_digest",
    "CommitTrail",
    "diff_enabled",
    "TRAIL_HORIZON",
    "build_delta",
    "apply_delta",
    "pack_delta",
    "unpack_delta",
]

_LEN = struct.Struct("<Q")

# Trail depth in committed steps: an absence longer than this falls back to
# a full heal. The JAX package reads TORCHFT_HEAL_TRAIL; nothing in the
# port sets another value.
TRAIL_HORIZON = 8


def diff_enabled() -> bool:
    """``TORCHFT_HEAL_DIFF=1`` opts into the differential heal. Off by
    default: the trail costs one flatten of the state (a device-to-host
    copy on the card) and one digest per committed step."""
    return os.environ.get("TORCHFT_HEAL_DIFF", "0") == "1"


# Leaves hash on this many threads once the state passes _PARALLEL_MIN
# bytes (hashlib drops the GIL for a large update): a healer's stripe plan
# waits for every source's staging, and with one thread the headline's
# 701.6 MB staged in 1.4-2.2 s on an H100 host (chip_smoke.py phase 15).
_DIGEST_THREADS = 8
_PARALLEL_MIN = 64 << 20


def _digest(buf: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(as_bytes(buf))
    return h.hexdigest()


def leaf_digests(buffers: Sequence[np.ndarray]) -> List[str]:
    """Per-buffer content digest (blake2b, 64 bits: a delta must never skip
    a changed leaf the way a short checksum eventually would), in order."""
    if sum(int(b.nbytes) for b in buffers) < _PARALLEL_MIN:
        return [_digest(b) for b in buffers]
    with ThreadPoolExecutor(max_workers=min(_DIGEST_THREADS, len(buffers)),
                            thread_name_prefix="tft_digest") as pool:
        return list(pool.map(_digest, buffers))


def tree_digest(digests: Sequence[str]) -> str:
    """Whole-tree digest over the ordered per-buffer digests.

    It does not hash the header pickle: pickle is not a canonical encoding
    (its memo makes a freshly built tree and a heal-round-tripped tree
    with the same structure and bytes serialize to headers of different
    lengths; a once-healed survivor was then left out of every stripe
    plan). Both users need buffer identity only: stripes move buffer
    bytes, and the delta path adopts the server's header while reusing
    the healer's digest-matched buffers."""
    h = hashlib.blake2b(digest_size=8)
    for d in digests:
        h.update(d.encode())
    return h.hexdigest()


class CommitTrail:
    """Bounded per-leaf digest trail over recent committed steps.

    Thread-safe: the main thread records at step boundaries while the
    quorum and HTTP threads look entries up mid-heal (the staged buffers
    are guarded by the transport's RWLock; the trail holds digests only)."""

    def __init__(self, horizon: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._horizon = horizon if horizon is not None else TRAIL_HORIZON
        # step -> {"tree": str, "leaves": [str...], "sizes": [int...]}
        self._entries: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()  # guarded-by: _lock

    def record(
        self,
        step: int,
        buffers: Sequence[np.ndarray],
        digests: Optional[List[str]] = None,
    ) -> List[str]:
        """Record (or return the existing) digests for ``step``; evicts the
        entries past the horizon. Returns the per-leaf digests."""
        with self._lock:
            ent = self._entries.get(step)
            if ent is not None:
                return list(ent["leaves"])
        leaves = digests if digests is not None else leaf_digests(buffers)
        ent = {
            "tree": tree_digest(leaves),
            "leaves": leaves,
            "sizes": [int(b.nbytes) for b in buffers],
        }
        with self._lock:
            self._entries[step] = ent
            self._entries.move_to_end(step)
            while len(self._entries) > self._horizon:
                self._entries.popitem(last=False)
        return list(leaves)

    def get(self, step: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            ent = self._entries.get(step)
            return None if ent is None else dict(ent)

    def steps(self) -> List[int]:
        with self._lock:
            return list(self._entries)


def build_delta(
    header: bytes,
    buffers: Sequence[np.ndarray],
    staged_digests: Sequence[str],
    trail_entry: Optional[Dict[str, Any]],
    healer_tree_digest: str,
) -> Optional[Tuple[Dict[str, Any], List[np.ndarray]]]:
    """Server side: the delta manifest and the changed buffers for a healer
    at the trail step ``trail_entry`` describes, or None when only a full
    heal is sound (no trail entry, a tree-digest mismatch, or a leaf count
    that drifted)."""
    if trail_entry is None:
        return None
    if trail_entry["tree"] != healer_tree_digest:
        return None
    then: List[str] = trail_entry["leaves"]
    if len(then) != len(staged_digests) or len(then) != len(buffers):
        return None
    changed = [i for i, (a, b) in enumerate(zip(then, staged_digests)) if a != b]
    manifest = {
        "mode": "delta",
        "header": header,
        "changed": changed,
        "sizes": [int(buffers[i].nbytes) for i in changed],
    }
    return manifest, [buffers[i] for i in changed]


def pack_delta(manifest: Dict[str, Any], changed: Sequence[np.ndarray]) -> List[Any]:
    """A delta (or a bare ``{"mode": "full"}`` refusal) as response body
    parts; the changed buffers go out as views, not copies."""
    blob = pickle.dumps(manifest)
    out: List[Any] = [_LEN.pack(len(blob)), blob]
    out.extend(as_bytes(b) for b in changed)
    return out


def unpack_delta(body: Union[bytes, bytearray]) -> Tuple[Dict[str, Any], memoryview]:
    """Split a response body into (manifest, payload view)."""
    (n,) = _LEN.unpack_from(body, 0)
    manifest = pickle.loads(body[_LEN.size : _LEN.size + n])
    return manifest, memoryview(body)[_LEN.size + int(n) :]


def apply_delta(
    manifest: Dict[str, Any],
    payload: Union[bytes, bytearray, memoryview],
    own_buffers: Sequence[np.ndarray],
) -> Tuple[bytes, List[np.ndarray]]:
    """Healer side: the delta's changed buffers with the healer's own
    (digest-matched) buffers, as the full ``(header, buffers)`` that
    ``unflatten_state`` takes. Raises ``ValueError`` on any layout
    inconsistency; the caller then falls back to a full heal."""
    header: bytes = manifest["header"]
    changed: List[int] = list(manifest["changed"])
    sizes: List[int] = list(manifest["sizes"])
    if len(changed) != len(sizes):
        raise ValueError("delta manifest: changed/sizes length mismatch")
    total = sum(sizes)
    if len(payload) != total:
        raise ValueError(f"delta payload truncated: {len(payload)} != {total}")
    buffers: List[np.ndarray] = [np.frombuffer(as_bytes(b), dtype=np.uint8) for b in own_buffers]
    off = 0
    for idx, nbytes in zip(changed, sizes):
        if idx >= len(buffers):
            raise ValueError(f"delta manifest: leaf index {idx} out of range")
        buffers[idx] = np.frombuffer(payload, dtype=np.uint8, count=nbytes, offset=off)
        off += nbytes
    return header, buffers
