"""Crash-durable per-process black box — the port's copy of
``torchft_tpu/telemetry/blackbox.py``, the forensic substrate.

Everything the live telemetry plane keeps in memory dies with the
process: the flight ring, the anatomy rows and the native breadcrumbs are
gone the instant a worker is SIGKILLed, and those failures are exactly
the ones whose only witness is the dead process. This module mirrors the
live planes into an **mmap'd ring file**: pages dirtied through an mmap
survive any process death (SIGKILL, SIGSEGV, a glibc abort: the kernel
owns the page cache), so a postmortem reader recovers everything written
up to the torn tail with no cooperation from the victim.

**File layout** (``TORCHFT_BLACKBOX_DIR/tft_bb_<pid>.bb``), a contract
shared with the JAX package (each package's reader reads the other's
rings)::

    header (64 B): b"TFTBBPY1" | u32 size | u32 pid | u64 created_ns | pad
    ring   (size - 64 B): 4-byte-aligned frames, written circularly

    frame: u32 magic (0x42425446 "TFBB") | u32 payload_len |
           u32 crc32(payload) | payload (JSON, padded to 4 B)

Each payload is a compact JSON object carrying the clock-sync-free
coordinates ``{"q": seq, "ep": quorum_epoch, "st": step, "ts": wall,
"k": kind, ...fields}``; ``q`` is this process's monotone record counter,
so a reader orders records exactly even after the ring wrapped. Recovery
scans the whole ring: a frame whose CRC fails (the torn tail of a
mid-write death, or a half-overwritten older lap) is skipped, never
trusted, and the reader resynchronizes on the next aligned magic, so one
torn record costs one record.

The native core writes its own sibling ring (``tft_bb_<pid>_native.bb``,
fixed 64-byte binary records, ``native/blackbox.h``; armed by the same
``TORCHFT_BLACKBOX_DIR``, which the C++ core reads itself);
:func:`read_native_blackbox` parses it here. Both are merged by
``python -m torchft_tpu_torch.telemetry.postmortem``.

The event trail, the flight recorder and the step ledger mirror into the
process-wide :data:`BLACKBOX`, armed by ``TORCHFT_BLACKBOX_DIR`` (or
:meth:`BlackBox.configure`); disarmed, :meth:`BlackBox.record` is one
attribute check. Ring bytes: ``TORCHFT_BLACKBOX_SIZE`` (default 1 MiB,
shared with the native ring's sizing). Stdlib-only; never raises on the
record path.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "ENV_BLACKBOX_DIR",
    "ENV_BLACKBOX_SIZE",
    "BlackBox",
    "BLACKBOX",
    "blackbox_dir",
    "read_blackbox",
    "read_native_blackbox",
    "NATIVE_SITES_BB",
]

ENV_BLACKBOX_DIR = "TORCHFT_BLACKBOX_DIR"
ENV_BLACKBOX_SIZE = "TORCHFT_BLACKBOX_SIZE"

_HEADER_MAGIC = b"TFTBBPY1"
_HEADER_SIZE = 64
_FRAME_MAGIC = 0x42425446  # "TFBB" little-endian
_FRAME = struct.Struct("<III")  # magic, payload_len, crc32(payload)
_DEFAULT_SIZE = 1 << 20
_MAX_PAYLOAD = 1 << 16  # one record must never eat the whole ring

# native/blackbox.h record layout (64 B, crc32 over the first 56 B) —
# keep in byte-for-byte lockstep with struct Rec there
_NATIVE_HEADER_MAGIC = b"TFTBBNA1"
_NATIVE_REC = struct.Struct("<IHHQQqqqqII")
_NATIVE_REC_SIZE = 64
assert _NATIVE_REC.size == _NATIVE_REC_SIZE

# native site ids (native/blackbox.h Site enum) -> names; the postmortem
# timeline uses these as record kinds
NATIVE_SITES_BB = {
    1: "dp.hop",
    2: "dp.stripe",
    3: "rpc.serve",
    4: "quorum.publish",
    5: "quorum.deliver",
    6: "commit.decision",
    7: "divergence",
}


def blackbox_dir() -> Optional[str]:
    """The armed black-box directory, or None when the plane is off."""
    return os.environ.get(ENV_BLACKBOX_DIR) or None


def _ring_size() -> int:
    try:
        size = int(os.environ.get(ENV_BLACKBOX_SIZE, str(_DEFAULT_SIZE)))
    except ValueError:
        size = _DEFAULT_SIZE
    return max(4096, size)


class BlackBox:
    """Crash-durable mmap'd record ring (see module docstring).

    One process-wide instance (:data:`BLACKBOX`) mirrors the event
    trail, the flight recorder and the anatomy ledger; the Manager keeps
    its ``(replica_id, step, quorum_epoch)`` context current via
    :meth:`set_context` so every record carries the coordinates the
    postmortem merge orders by."""

    def __init__(self, path: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._mm: Optional[mmap.mmap] = None
        self._size = 0
        self._off = _HEADER_SIZE
        self._seq = 0
        self._env_checked = False
        self._replica_id = ""
        self._step = -1
        self._epoch = -1
        self.path: Optional[str] = None
        if path:
            self.configure(path)

    # -- arming ----------------------------------------------------------

    def configure(self, path: Optional[str]) -> bool:
        """Open (or reopen) the ring at ``path``; ``None`` disarms.
        Returns whether the box is armed afterwards."""
        with self._lock:
            self._close_locked()
            self._env_checked = True  # explicit config wins over env
            if path is None:
                return False
            return self._open_locked(path)

    def _maybe_open_from_env(self) -> None:
        # called under self._lock
        if self._env_checked:
            return
        self._env_checked = True
        d = blackbox_dir()
        if not d:
            return
        self._open_locked(os.path.join(d, f"tft_bb_{os.getpid()}.bb"))

    def _open_locked(self, path: str) -> bool:
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            size = _ring_size()
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            header = _HEADER_MAGIC + struct.pack(
                "<IIQ", size, os.getpid(), time.time_ns()
            )
            self._mm[0:_HEADER_SIZE] = header.ljust(_HEADER_SIZE, b"\0")
            self._size = size
            self._off = _HEADER_SIZE
            self.path = path
            return True
        except (OSError, ValueError):
            # forensics must never take down training
            self._mm = None
            self.path = None
            return False

    def enabled(self) -> bool:
        with self._lock:
            self._maybe_open_from_env()
            return self._mm is not None

    # -- context ---------------------------------------------------------

    def set_context(
        self,
        replica_id: Optional[str] = None,
        step: Optional[int] = None,
        quorum_epoch: Optional[int] = None,
    ) -> None:
        """Update the coordinates stamped on subsequent records; a
        replica change additionally writes a ``ctx`` record so the
        postmortem reader can attribute the box to a replica."""
        emit_ctx = False
        with self._lock:
            if replica_id is not None and replica_id != self._replica_id:
                self._replica_id = replica_id
                emit_ctx = True
            if step is not None:
                self._step = int(step)
            if quorum_epoch is not None:
                self._epoch = int(quorum_epoch)
        if emit_ctx:
            self.record("ctx", replica=replica_id)

    def context(self) -> Dict[str, Any]:
        """The current clock-sync-free coordinates (replica, epoch, step,
        seq) — the diagnosis engine stamps bundles with these so capture
        evidence merges onto the same timeline as everything else."""
        with self._lock:
            return {
                "replica_id": self._replica_id,
                "epoch": self._epoch,
                "step": self._step,
                "seq": self._seq,
            }

    # -- producer --------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one record; silently drops on any failure (a full disk
        or a serialization surprise must never fail a step)."""
        # disarmed fast path, no lock: this rides every collective-op
        # record. The unsynchronized read is safe — worst case a racing
        # configure() costs one early record, never corruption (all real
        # state changes happen under the lock below).
        if self._mm is None and self._env_checked:
            return
        try:
            with self._lock:
                self._maybe_open_from_env()
                mm = self._mm
                if mm is None:
                    return
                self._seq += 1
                payload = json.dumps(
                    {
                        "q": self._seq,
                        "ep": self._epoch,
                        "st": self._step,
                        "ts": round(time.time(), 6),
                        "k": kind,
                        **fields,
                    },
                    separators=(",", ":"),
                    default=str,
                ).encode()
                if len(payload) > _MAX_PAYLOAD:
                    payload = payload[:_MAX_PAYLOAD]  # torn JSON: reader skips
                pad = (-len(payload)) % 4
                frame_len = _FRAME.size + len(payload) + pad
                if frame_len > self._size - _HEADER_SIZE:
                    return
                if self._off + frame_len > self._size:
                    # wrap: zero the stub so the reader's magic scan can't
                    # resurrect a stale frame header at the old offset
                    mm[self._off : self._size] = b"\0" * (
                        self._size - self._off
                    )
                    self._off = _HEADER_SIZE
                off = self._off
                # payload first, CRC+magic last: a death mid-write leaves
                # a frame whose CRC cannot validate — torn-tail tolerance
                # is by construction, not by luck
                mm[off + _FRAME.size : off + _FRAME.size + len(payload)] = (
                    payload
                )
                if pad:
                    mm[
                        off + _FRAME.size + len(payload) :
                        off + _FRAME.size + len(payload) + pad
                    ] = b"\0" * pad
                _FRAME.pack_into(
                    mm, off, _FRAME_MAGIC, len(payload),
                    zlib.crc32(payload) & 0xFFFFFFFF,
                )
                self._off = off + frame_len
        except Exception:  # noqa: BLE001 — never fail the caller
            pass

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except (OSError, ValueError):
                pass
        self._mm = None
        self.path = None


# Process-wide box: events.py, flight.py and anatomy.py mirror into it.
BLACKBOX = BlackBox()


def read_blackbox(path: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Recover a Python black box: returns ``(records, meta)``.

    Records are CRC-valid payloads in ``q`` order (the ring may have
    wrapped, so file order is not record order). ``meta`` carries
    ``pid``, ``torn`` (number of invalid/garbage regions skipped — a
    SIGKILL mid-write shows up here, never as a corrupt record) and
    ``replica`` (from the latest ``ctx`` record)."""
    with open(path, "rb") as f:
        raw = f.read()
    meta: Dict[str, Any] = {"path": path, "pid": None, "torn": 0,
                            "replica": ""}
    records: List[Dict[str, Any]] = []
    if len(raw) < _HEADER_SIZE or raw[:8] != _HEADER_MAGIC:
        meta["torn"] = 1
        return records, meta
    size, pid, _created = struct.unpack_from("<IIQ", raw, 8)
    meta["pid"] = pid
    size = min(size, len(raw))
    off = _HEADER_SIZE
    in_garbage = False
    while off + _FRAME.size <= size:
        magic, plen, crc = _FRAME.unpack_from(raw, off)
        if (
            magic == _FRAME_MAGIC
            and 0 < plen <= _MAX_PAYLOAD
            and off + _FRAME.size + plen <= size
        ):
            payload = raw[off + _FRAME.size : off + _FRAME.size + plen]
            if zlib.crc32(payload) & 0xFFFFFFFF == crc:
                try:
                    rec = json.loads(payload.decode())
                except ValueError:
                    rec = None
                if isinstance(rec, dict):
                    records.append(rec)
                    off += _FRAME.size + plen + ((-plen) % 4)
                    in_garbage = False
                    continue
        # invalid frame: count one torn region per contiguous run and
        # resynchronize on the next aligned candidate magic
        if not in_garbage and magic != 0:
            meta["torn"] += 1
        in_garbage = magic != 0
        off += 4
    records.sort(key=lambda r: r.get("q", 0))
    for rec in records:
        if rec.get("k") == "ctx" and rec.get("replica"):
            meta["replica"] = rec["replica"]
    return records, meta


def read_native_blackbox(
    path: str,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Recover a native breadcrumb ring (``native/blackbox.h`` format):
    fixed 64-byte records, CRC32 over the first 56 bytes, ordered by the
    lock-free global ``seq``. Same ``(records, meta)`` contract as
    :func:`read_blackbox`; each record gets a ``k`` from the native site
    id so the postmortem merge treats both formats uniformly."""
    with open(path, "rb") as f:
        raw = f.read()
    meta: Dict[str, Any] = {"path": path, "pid": None, "torn": 0,
                            "replica": "", "native": True}
    records: List[Dict[str, Any]] = []
    if len(raw) < _HEADER_SIZE or raw[:8] != _NATIVE_HEADER_MAGIC:
        meta["torn"] = 1
        return records, meta
    _cap, pid = struct.unpack_from("<II", raw, 8)
    meta["pid"] = pid
    off = _HEADER_SIZE
    while off + _NATIVE_REC_SIZE <= len(raw):
        (magic, site, _flags, seq, ts_ns, epoch, step, a, b, crc,
         _pad) = _NATIVE_REC.unpack_from(raw, off)
        if magic == 0x4242544E:  # "NTBB"
            if zlib.crc32(raw[off : off + 56]) & 0xFFFFFFFF == crc:
                records.append(
                    {
                        "q": seq,
                        "ep": epoch,
                        "st": step,
                        "ts": ts_ns / 1e9,
                        "k": NATIVE_SITES_BB.get(site, f"native.{site}"),
                        "a": a,
                        "b": b,
                        "native": True,
                    }
                )
            else:
                meta["torn"] += 1
        off += _NATIVE_REC_SIZE
    records.sort(key=lambda r: r.get("q", 0))
    return records, meta
