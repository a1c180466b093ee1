"""Delta-encoded telemetry piggyback and the fleet rollup client — the
port's copy of ``torchft_tpu/telemetry/fleetdelta.py``.

Each quorum RPC carries the replica's telemetry report (health scalars,
counters digest, step anatomy, log2 histograms, time-series samples) to
the lighthouse. Between two steps a few counters move and one or two
histogram buckets, so the report ships as a binary delta of what changed:

* :func:`flatten` / :func:`unflatten` — the nested report becomes a flat
  ``{path: leaf}`` map (segments joined by ``\\x1f``, list indices as
  ``\\x1e<i>`` segments, so key names with dots never collide with the
  path syntax).
* :class:`DeltaEncoder` — the replica side: a versioned blob with
  dictionary-interned keys (a key's bytes travel once an incarnation) and
  only the changed fields. A new encoder (a random 8-byte incarnation) or
  a resync the lighthouse asks for sends the full state.
* :class:`DeltaDecoder` — the receiver, the oracle the tests hold the C++
  decoder (``native/telemetry_delta.h``) against.
* :func:`collect_hists` — this process's mergeable log2 histograms.
* :func:`poll_fleet` — one ``GET /fleet.json``: fleet-folded histograms
  with their p50/p95/p99 and the reporting, stuck and breach counts.

Wire format v1 (unsigned LEB128 varints unless noted), which the C++
lighthouse decodes (``native/coord.cc`` ``ingest_tdelta``)::

    byte  0      magic 0xD7
    byte  1      format version (1)
    byte  2      flags (bit0 = FULL: receiver resets dictionary + state)
    bytes 3..10  incarnation (8 random bytes, fixed per encoder lifetime)
    varint       version       (this blob's state version, starts at 1)
    varint       base_version  (version this delta applies on top of;
                                0 and ignored when FULL)
    varint       entry count
    entries:
      varint     keyref = (id << 1) | define
                 define=1: varint key byte length + UTF-8 key bytes
      byte       type: 0 DEL, 1 F64 (8 bytes LE), 2 I64 (zigzag
                 varint), 3 BOOL (1 byte), 4 STR (varint len + UTF-8),
                 5 BYTES (varint len + raw)
      value      per type; DEL carries none

A receiver applies a delta only when ``(incarnation, base_version)``
matches its state; a mismatch is dropped and answered with a resync in
the quorum reply's ack (``tack``), which makes the next blob full.

Under the byte cap (:data:`MAX_BLOB_BYTES`, the lighthouse's 64 KiB) the
blob degrades field by field in priority order (:func:`tier_of`): latches
and health scalars, then summary counters and series, then anatomy and
histogram digests; spans ride outside the blob and are dropped first by
the Manager. Deferred entries stay dirty and ship on a later step.

``TORCHFT_TELEMETRY_DELTA=0`` sends the full-JSON payload instead (the
contrast leg of ``benchmarks/quorum_scale.py``). The cap is a module
constant that tests patch; the lighthouse's rollup cadence is read by the
C++ core itself.
"""

from __future__ import annotations

import json
import os
import struct
import urllib.request
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = [
    "SEP",
    "IDX",
    "MAGIC",
    "FMT_VERSION",
    "DEFAULT_MAX_BYTES",
    "T_DEL",
    "T_F64",
    "T_I64",
    "T_BOOL",
    "T_STR",
    "T_BYTES",
    "delta_enabled",
    "max_blob_bytes",
    "flatten",
    "unflatten",
    "tier_of",
    "DeltaEncoder",
    "DeltaDecoder",
    "collect_hists",
    "poll_fleet",
]

SEP = "\x1f"  # path-segment joiner (unit separator: never in key names)
IDX = "\x1e"  # list-index segment prefix; IDX + "#" is the length marker

MAGIC = 0xD7
FMT_VERSION = 1
FLAG_FULL = 0x01

T_DEL = 0
T_F64 = 1
T_I64 = 2
T_BOOL = 3
T_STR = 4
T_BYTES = 5

DEFAULT_MAX_BYTES = 1 << 16  # the lighthouse's piggyback cap
# the encoder's blob cap; tests patch it
MAX_BLOB_BYTES = DEFAULT_MAX_BYTES

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def delta_enabled() -> bool:
    """``TORCHFT_TELEMETRY_DELTA=0`` sends the full-JSON piggyback instead
    (also the ``quorum_scale`` contrast leg)."""
    return os.environ.get("TORCHFT_TELEMETRY_DELTA", "1") != "0"


def max_blob_bytes() -> int:
    return MAX_BLOB_BYTES


# ---------------------------------------------------------------- flatten

def flatten(obj: Any, _prefix: str = "", _out: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Nested dict/list → flat ``{path: leaf}``. Leaves are bool / int /
    float / str / bytes; ``None`` leaves are skipped (absence IS the
    encoding); anything else degrades to ``str(v)`` (the same contract
    as the legacy path's ``json.dumps(default=str)``)."""
    if _out is None:
        _out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = str(k)
            _flatten_child(v, _prefix + key if not _prefix
                           else _prefix + SEP + key, _out)
    elif isinstance(obj, (list, tuple)):
        _out[(_prefix + SEP if _prefix else "") + IDX + "#"] = len(obj)
        for i, v in enumerate(obj):
            _flatten_child(v, (_prefix + SEP if _prefix else "")
                           + IDX + str(i), _out)
    else:
        _flatten_child(obj, _prefix, _out)
    return _out


def _flatten_child(v: Any, path: str, out: Dict[str, Any]) -> None:
    if v is None:
        return
    if isinstance(v, (dict, list, tuple)):
        flatten(v, path, out)
    elif isinstance(v, bool):
        out[path] = v
    elif isinstance(v, int):
        out[path] = v if _I64_MIN <= v <= _I64_MAX else float(v)
    elif isinstance(v, (float, str, bytes)):
        out[path] = v
    else:
        out[path] = str(v)


def unflatten(flat: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten` (modulo ``None`` leaves and non-JSON
    types, which flatten degrades by design)."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        segs = path.split(SEP)
        node = root
        for seg in segs[:-1]:
            node = node.setdefault(seg, {})
            if not isinstance(node, dict):  # leaf/subtree collision
                break
        else:
            if segs[-1] == IDX + "#":
                node.setdefault(IDX + "#", leaf)
            else:
                node[segs[-1]] = leaf
    return _rebuild(root)


def _rebuild(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if any(k.startswith(IDX) for k in node):
        n = node.get(IDX + "#")
        if not isinstance(n, int):
            n = 1 + max(
                (int(k[len(IDX):]) for k in node
                 if k.startswith(IDX) and k != IDX + "#"),
                default=-1,
            )
        out_list: List[Any] = [None] * int(n)
        for k, v in node.items():
            if not k.startswith(IDX) or k == IDX + "#":
                continue
            i = int(k[len(IDX):])
            if 0 <= i < len(out_list):
                out_list[i] = _rebuild(v)
        return out_list
    return {k: _rebuild(v) for k, v in node.items()}


# ------------------------------------------------------------ varint core

def _wv(out: bytearray, n: int) -> None:  # unsigned LEB128
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _rv(buf: bytes, off: int) -> Tuple[int, int]:
    n = 0
    shift = 0
    while True:
        if off >= len(buf):
            raise ValueError("truncated varint")
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _zz(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1


def _unzz(n: int) -> int:
    return (n >> 1) if not n & 1 else -((n + 1) >> 1)


# ------------------------------------------------------------------ tiers

def tier_of(path: str) -> int:
    """Degradation tier under the byte cap (lower survives longer):
    0 = latches + health scalars, 1 = summary counters / series /
    diagnosis pointers, 2 = anatomy + histogram digests. (Spans are
    tier 3 but ride outside the blob — the Manager drops them first.)"""
    top = path.split(SEP, 1)[0]
    if top in ("step", "epoch", "stuck", "slo_breach",
               "local_step_p50_s", "last_heal_ts"):
        return 0
    if path.startswith("series" + SEP + "flag."):
        return 0  # detector latches as 0/1 series
    if top in ("anatomy", "hist"):
        return 2
    return 1


def _leaf_differs(a: Any, b: Any) -> bool:
    # type-sensitive: 1 and 1.0 and True compare equal in Python but
    # decode to different wire types on the far side
    return type(a) is not type(b) or a != b


def _encode_leaf(out: bytearray, v: Any) -> None:
    if isinstance(v, bool):
        out.append(T_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.append(T_I64)
        _wv(out, _zz(v))
    elif isinstance(v, float):
        out.append(T_F64)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(T_STR)
        _wv(out, len(b))
        out += b
    elif isinstance(v, bytes):
        out.append(T_BYTES)
        _wv(out, len(v))
        out += v
    else:  # pragma: no cover — flatten never emits other leaves
        raise TypeError(f"unencodable leaf: {type(v)}")


class DeltaEncoder:
    """Replica-side stateful encoder. One instance per process telemetry
    chain; the incarnation is fixed at construction so a respawn is a
    NEW chain by construction. Thread-compatible, not thread-safe — the
    Manager calls it from the quorum path only."""

    # a chain whose acks lag this many versions has lost its reply
    # channel (e.g. a lighthouse failover that kept state_ but not our
    # RPC replies) — resync defensively rather than delta forever
    MAX_UNACKED = 32

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        self.incarnation: bytes = os.urandom(8)
        self.version = 0  # version of the last emitted blob
        self.acked_version = 0
        self._need_full = True
        self._key_ids: Dict[str, int] = {}
        self._shadow: Dict[str, Any] = {}
        self._max_bytes = max_bytes
        self.truncated_total = 0  # entries skipped under the cap, ever
        self.last_truncated = 0   # ... by the most recent encode
        self.fulls_total = 0
        self.blobs_total = 0
        self.bytes_total = 0

    @property
    def cap(self) -> int:
        return self._max_bytes if self._max_bytes is not None \
            else max_blob_bytes()

    def on_ack(self, ack: Optional[Dict[str, Any]]) -> None:
        """Feed the ``tack`` map from a quorum reply:
        ``{incarnation_hex: {"ver": int, "resync": bool}}``. Entries for
        other incarnations (other local ranks, or our own previous life
        relayed late) are ignored."""
        if not isinstance(ack, dict):
            return
        mine = ack.get(self.incarnation.hex())
        if not isinstance(mine, dict):
            return
        if mine.get("resync"):
            self._need_full = True
        try:
            self.acked_version = max(self.acked_version,
                                     int(mine.get("ver", 0)))
        except (TypeError, ValueError):
            pass

    def force_full(self) -> None:
        """Next blob re-sends full state — the recovery lever for any
        caller that knows the receiver lost the chain (e.g. a respawn
        re-basing after a parked resync)."""
        self._need_full = True

    def encode(self, report: Dict[str, Any]) -> bytes:
        """One blob for this step's report. Always succeeds; under the
        byte cap lower-priority entries are deferred (see module doc)."""
        if (self.version - self.acked_version) > self.MAX_UNACKED:
            self._need_full = True
        flat = flatten(report)
        full = self._need_full
        if full:
            self._key_ids = {}
            self._shadow = {}
        # the changed set, most-critical tier first, stable within a tier
        changed: List[Tuple[int, str, Any]] = [
            (tier_of(k), k, v) for k, v in flat.items()
            if full or k not in self._shadow
            or _leaf_differs(self._shadow[k], v)
        ]
        deleted: Set[str] = set(self._shadow) - set(flat)
        changed += [(tier_of(k), k, None) for k in deleted]
        changed.sort(key=lambda t: (t[0], t[1]))

        out = bytearray()
        out.append(MAGIC)
        out.append(FMT_VERSION)
        out.append(FLAG_FULL if full else 0)
        out += self.incarnation
        version = self.version + 1
        _wv(out, version)
        _wv(out, 0 if full else self.version)
        cap = self.cap
        entries = bytearray()
        n_entries = 0
        skipped = 0
        # header + worst-case count varint headroom
        budget = cap - len(out) - 5
        for _tier, key, val in changed:
            e = bytearray()
            kid = self._key_ids.get(key)
            if kid is None:
                kid = len(self._key_ids)
                kb = key.encode("utf-8")
                _wv(e, (kid << 1) | 1)
                _wv(e, len(kb))
                e += kb
                new_key = True
            else:
                _wv(e, kid << 1)
                new_key = False
            if val is None:
                e.append(T_DEL)
            else:
                _encode_leaf(e, val)
            if len(entries) + len(e) > budget:
                skipped += 1
                continue  # stays dirty: shadow not advanced for it
            if new_key:
                self._key_ids[key] = kid
            entries += e
            n_entries += 1
            if val is None:
                self._shadow.pop(key, None)
            else:
                self._shadow[key] = val
        _wv(out, n_entries)  # landed in the headroom reserved above
        out += entries
        self.version = version
        self._need_full = False
        self.last_truncated = skipped
        self.truncated_total += skipped
        self.fulls_total += 1 if full else 0
        self.blobs_total += 1
        self.bytes_total += len(out)
        return bytes(out)


class DeltaDecoder:
    """Receiver-side state for ONE incarnation chain — the Python oracle
    for ``native/telemetry_delta.h`` and the unit under round-trip
    tests. ``apply`` returns an outcome dict instead of raising: the
    real receiver must degrade (request resync), never fail a quorum."""

    def __init__(self) -> None:
        self.incarnation: Optional[bytes] = None
        self.version = 0
        self.keys: List[str] = []
        self.flat: Dict[str, Any] = {}
        self.resync = False

    def state(self) -> Any:
        """The current nested view (tests compare against the sender's
        report)."""
        return unflatten(self.flat)

    def apply(self, blob: bytes) -> Dict[str, Any]:
        out = {"ok": False, "full": False, "resync_wanted": False,
               "changed": [], "error": ""}
        try:
            if len(blob) < 11 or blob[0] != MAGIC:
                raise ValueError("bad magic")
            if blob[1] != FMT_VERSION:
                raise ValueError(f"format version {blob[1]} != "
                                 f"{FMT_VERSION}")
            full = bool(blob[2] & FLAG_FULL)
            inc = blob[3:11]
            off = 11
            version, off = _rv(blob, off)
            base, off = _rv(blob, off)
            if not full:
                if self.incarnation != inc or self.version != base:
                    self.resync = True
                    out["resync_wanted"] = True
                    out["error"] = "incarnation/base mismatch"
                    return out
            n, off = _rv(blob, off)
            if full:
                self.incarnation = inc
                self.keys = []
                self.flat = {}
            changed: List[str] = []
            for _ in range(n):
                ref, off = _rv(blob, off)
                if ref & 1:
                    klen, off = _rv(blob, off)
                    key = blob[off:off + klen].decode("utf-8")
                    off += klen
                    if (ref >> 1) != len(self.keys):
                        raise ValueError("non-dense key id")
                    self.keys.append(key)
                else:
                    key = self.keys[ref >> 1]
                if off >= len(blob):
                    raise ValueError("truncated entry")
                t = blob[off]
                off += 1
                if t == T_DEL:
                    self.flat.pop(key, None)
                elif t == T_F64:
                    (self.flat[key],) = struct.unpack_from("<d", blob, off)
                    off += 8
                elif t == T_I64:
                    zz, off = _rv(blob, off)
                    self.flat[key] = _unzz(zz)
                elif t == T_BOOL:
                    self.flat[key] = bool(blob[off])
                    off += 1
                elif t in (T_STR, T_BYTES):
                    slen, off = _rv(blob, off)
                    raw = blob[off:off + slen]
                    off += slen
                    self.flat[key] = (raw.decode("utf-8") if t == T_STR
                                      else bytes(raw))
                else:
                    raise ValueError(f"unknown leaf type {t}")
                changed.append(key)
            self.version = version
            self.resync = False
            out.update(ok=True, full=full, changed=changed)
            return out
        except (ValueError, IndexError, UnicodeDecodeError,
                struct.error) as e:
            self.resync = True
            out["resync_wanted"] = True
            out["error"] = str(e)
            return out


# -------------------------------------------------------- hist collection

def collect_hists() -> Dict[str, Dict[str, int]]:
    """This replica's mergeable log2 histograms for the fleet rollup:
    raw (non-cumulative) per-bucket counts on the shared 28-bucket grid
    (``LOG2_BUCKETS`` == ``native/lathist.h``), keyed by bucket index as
    a string so only the 1-2 buckets a step actually moves ride the
    delta. Sources: the step wall/local/per-phase registry histograms
    and the native lathist ops. Zero buckets are omitted (the fold
    treats absence as zero). Never raises."""
    out: Dict[str, Dict[str, int]] = {}
    try:
        from torchft_tpu_torch import telemetry as T

        def sparse(counts: List[int]) -> Dict[str, int]:
            return {str(i): int(c) for i, c in enumerate(counts) if c}

        for name, hist in (("wall", T.STEP_WALL_SECONDS),
                           ("local", T.STEP_LOCAL_SECONDS)):
            s = sparse(hist.raw_counts())
            if s:
                out[name] = s
        from torchft_tpu_torch.telemetry.anatomy import PHASES

        for phase in PHASES:
            s = sparse(T.STEP_PHASE_SECONDS.labels(phase=phase)
                       .raw_counts())
            if s:
                out[f"phase.{phase}"] = s
        try:
            from torchft_tpu_torch.telemetry.native import native_latency_snapshot

            for op, h in (native_latency_snapshot() or {}).items():
                s = sparse(list(h.get("counts") or ()))
                if s:
                    out[f"lat.{op}"] = s
        except Exception:  # noqa: BLE001 — native plane optional
            pass
    except Exception:  # noqa: BLE001 — observability must not fail quorum
        return {}
    return out


# ------------------------------------------------------------ fleet client

def _base_url(addr: str) -> str:
    if "://" not in addr:
        addr = "http://" + addr
    return addr.rstrip("/")


def poll_fleet(addr: str, group: str = "", timeout: float = 3.0
               ) -> Optional[Dict[str, Any]]:
    """One ``GET /fleet.json`` rollup scrape: fleet-folded histogram
    percentiles + reporting/stuck/breach counts, size-independent of
    fleet width. ``group`` adds one group's own percentile block.
    Returns the parsed reply or None — observability degrades, never
    raises."""
    url = f"{_base_url(addr)}/fleet.json"
    if group:
        url += f"?group={group}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001
        return None
