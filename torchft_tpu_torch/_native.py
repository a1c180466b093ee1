"""ctypes loader for the C++ coordination core (``native/``) — the port's
copy of ``torchft_tpu/_native/__init__.py``, trimmed to what the FT
training step uses: the RPC client, the lighthouse, the manager server,
the key-value store, the striped gradient data plane
(``NativeDataPlane``), the cross-memory-attach pulls (``cma_read``,
``cma_read_into``), the checkpoint blob plane of the striped heal
(``BlobServer``, ``blob_fetch``) and the native planes' latency histograms
(``lathist_snapshot``, ``lathist_reset``, ``LATHIST_BOUNDS_S``).

The library is built from the repo's ``native/`` sources at first use into
``build/torch_native/<sources digest>/`` (``make -C native OUTDIR=...``;
the Makefile stays as it is), under a file lock so concurrent first users
build once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

from torchft_tpu_torch.utils import wire
from torchft_tpu_torch.utils.platform import build_dir, run_locked_build

_NATIVE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)

# RPC status codes (native/wire.h). CANCELLED and DEADLINE_EXCEEDED map to
# TimeoutError, everything else to RuntimeError.
OK = 0
CANCELLED = 1
DEADLINE_EXCEEDED = 4
UNAVAILABLE = 6
_TIMEOUT_CODES = (CANCELLED, DEADLINE_EXCEEDED)

# The C ABI contract with libtftcore.so; must match native
# `tft_abi_version()` (the same version the JAX package's loader checks).
_ABI_VERSION = 7

_ERRLEN = 1024
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _sources_digest() -> str:
    """sha256 of the sources ``make`` compiles the core from."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_NATIVE_SRC)):
        if name == "Makefile" or name.endswith((".cc", ".h")):
            h.update(name.encode())
            with open(os.path.join(_NATIVE_SRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Build ``libtftcore.so`` into ``build/torch_native/<sources digest>/``
    unless it is there; returns its path. Keying the directory by the
    sources means an edit of ``native/`` is never answered by a stale
    library."""
    out_dir = os.path.join(build_dir("torch_native"), _sources_digest())
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libtftcore.so")
    # CXX=g++ overrides a CXX from the environment: the host's own compiler
    # links the shared libstdc++ that PyTorch loads too, while a compiler
    # wrapper that links libstdc++ statically puts a second libstdc++ into
    # the process, and PyTorch then crashes in its CUDA initialisation.
    return run_locked_build(
        lib, ["make", "-s", "-C", _NATIVE_SRC, "CXX=g++", f"OUTDIR={out_dir}", lib]
    )


def _abi_of(lib: ctypes.CDLL) -> int:
    try:
        fn = lib.tft_abi_version
    except AttributeError:
        return 1  # pre-versioning build
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return int(fn())


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(path)
        got = _abi_of(lib)
        if got != _ABI_VERSION:
            raise RuntimeError(
                f"native ABI mismatch: {path} reports {got}, this loader "
                f"needs {_ABI_VERSION}; remove {os.path.dirname(path)} and retry"
            )
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        lib.tft_buf_free.argtypes = [u8p]
        # native latency histograms (native/lathist.h)
        lib.tft_lathist_snapshot.argtypes = [
            c.POINTER(u8p), c.POINTER(c.c_int64), c.c_char_p, c.c_int,
        ]
        lib.tft_lathist_snapshot.restype = c.c_int64
        lib.tft_lathist_reset.argtypes = []
        lib.tft_lathist_reset.restype = None
        # the lighthouse's time-series store (native/tsdb.h)
        lib.tft_tsdb_snapshot.argtypes = [
            c.POINTER(u8p), c.POINTER(c.c_int64), c.c_char_p, c.c_int,
        ]
        lib.tft_tsdb_snapshot.restype = c.c_int64
        lib.tft_tsdb_reset.argtypes = []
        lib.tft_tsdb_reset.restype = None
        # always-on sampling profiler (native/profiler.h)
        lib.tft_prof_set_hz.argtypes = [c.c_double]
        lib.tft_prof_set_hz.restype = None
        lib.tft_prof_hz.argtypes = []
        lib.tft_prof_hz.restype = c.c_double
        lib.tft_prof_snapshot.argtypes = [c.POINTER(u8p), c.POINTER(c.c_int64), c.c_char_p, c.c_int]
        lib.tft_prof_snapshot.restype = c.c_int64
        lib.tft_prof_samples_total.argtypes = []
        lib.tft_prof_samples_total.restype = c.c_int64
        lib.tft_prof_reset.argtypes = []
        lib.tft_prof_reset.restype = None
        lib.tft_buf_free.restype = None
        lib.tft_lighthouse_create.argtypes = [
            c.c_char_p, c.c_uint64, c.c_uint64, c.c_uint64, c.c_uint64, c.c_uint64,
            c.c_char_p, c.c_int,
        ]
        lib.tft_lighthouse_create.restype = c.c_int64
        lib.tft_lighthouse_address.argtypes = [c.c_int64, c.c_char_p, c.c_int]
        lib.tft_lighthouse_address.restype = None
        lib.tft_lighthouse_shutdown.argtypes = [c.c_int64]
        lib.tft_lighthouse_shutdown.restype = None
        lib.tft_manager_create.argtypes = [
            c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p,
            c.c_uint64, c.c_int64, c.c_int64, c.c_char_p, c.c_int,
        ]
        lib.tft_manager_create.restype = c.c_int64
        lib.tft_manager_address.argtypes = [c.c_int64, c.c_char_p, c.c_int]
        lib.tft_manager_address.restype = None
        lib.tft_manager_shutdown.argtypes = [c.c_int64]
        lib.tft_manager_shutdown.restype = None
        lib.tft_store_create.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
        lib.tft_store_create.restype = c.c_int64
        lib.tft_store_address.argtypes = [c.c_int64, c.c_char_p, c.c_int]
        lib.tft_store_address.restype = None
        lib.tft_store_shutdown.argtypes = [c.c_int64]
        lib.tft_store_shutdown.restype = None
        lib.tft_client_create.argtypes = [c.c_char_p, c.c_int64, c.c_char_p, c.c_int]
        lib.tft_client_create.restype = c.c_int64
        lib.tft_client_call.argtypes = [
            c.c_int64, c.c_char_p, u8p, c.c_int64, c.c_int64,
            c.POINTER(u8p), c.POINTER(c.c_int64), c.c_char_p, c.c_int,
        ]
        lib.tft_client_call.restype = c.c_int64
        lib.tft_client_free.argtypes = [c.c_int64]
        lib.tft_client_free.restype = None
        # striped cross-process gradient data plane (native/dataplane.cc)
        lib.tft_dp_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int]
        lib.tft_dp_create.restype = c.c_int64
        lib.tft_dp_port.argtypes = [c.c_int64]
        lib.tft_dp_port.restype = c.c_int
        lib.tft_dp_connect.argtypes = [
            c.c_int64, c.c_int, c.c_char_p, c.c_int, c.c_int64, c.c_char_p, c.c_int,
        ]
        lib.tft_dp_connect.restype = c.c_int
        lib.tft_dp_wait_ready.argtypes = [c.c_int64, c.c_int64, c.c_char_p, c.c_int]
        lib.tft_dp_wait_ready.restype = c.c_int
        lib.tft_dp_enable_cma.argtypes = [
            c.c_int64, c.POINTER(c.c_int64), c.c_int, c.c_char_p, c.c_int,
        ]
        lib.tft_dp_enable_cma.restype = c.c_int
        lib.tft_dp_allreduce.argtypes = [
            c.c_int64, c.c_void_p, c.c_int64, c.c_int, c.c_int, c.c_int,
            c.c_uint32, c.c_int64, c.POINTER(c.c_int), c.c_char_p, c.c_int,
        ]
        lib.tft_dp_allreduce.restype = c.c_int
        lib.tft_dp_free.argtypes = [c.c_int64]
        lib.tft_dp_free.restype = None
        # striped checkpoint blob plane (native/blob.cc)
        lib.tft_blob_serve_create.argtypes = [c.c_char_p, c.c_int]
        lib.tft_blob_serve_create.restype = c.c_int64
        lib.tft_blob_serve_port.argtypes = [c.c_int64]
        lib.tft_blob_serve_port.restype = c.c_int
        lib.tft_blob_stage.argtypes = [
            c.c_int64, c.POINTER(c.c_uint64), c.POINTER(c.c_int64), c.c_int,
            c.c_uint64, c.c_char_p, c.c_int,
        ]
        lib.tft_blob_stage.restype = c.c_int
        lib.tft_blob_unstage.argtypes = [c.c_int64]
        lib.tft_blob_unstage.restype = c.c_int
        lib.tft_blob_serve_free.argtypes = [c.c_int64]
        lib.tft_blob_serve_free.restype = None
        lib.tft_blob_fetch.argtypes = [
            c.c_char_p, c.c_int, c.c_uint64, c.c_uint64, c.c_uint64,
            c.c_void_p, c.c_int64, c.c_char_p, c.c_int,
        ]
        lib.tft_blob_fetch.restype = c.c_int
        _lib = lib
        return lib


def _raise_status(code: int, msg: str) -> None:
    if code in _TIMEOUT_CODES:
        raise TimeoutError(msg)
    raise RuntimeError(msg)


def _errbuf() -> ctypes.Array:
    return ctypes.create_string_buffer(_ERRLEN)


class NativeClient:
    """Generic RPC client over the C++ transport (retry, backoff and
    keepalive live in native/rpc.cc)."""

    def __init__(self, addr: str, connect_timeout_ms: int) -> None:
        self._lib = _load()
        err = _errbuf()
        self._h = self._lib.tft_client_create(
            addr.encode(), int(connect_timeout_ms), err, _ERRLEN
        )
        if self._h == 0:
            _raise_status(UNAVAILABLE, err.value.decode())

    def call(self, method: str, req: Dict[str, Any], timeout_ms: int) -> Dict[str, Any]:
        buf = wire.encode(req)
        cbuf = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf) if buf else None
        outp = ctypes.POINTER(ctypes.c_uint8)()
        outlen = ctypes.c_int64()
        err = _errbuf()
        code = self._lib.tft_client_call(
            self._h, method.encode(), cbuf, len(buf), int(timeout_ms),
            ctypes.byref(outp), ctypes.byref(outlen), err, _ERRLEN,
        )
        if code != OK:
            _raise_status(code, f"{method}: {err.value.decode()}")
        try:
            out = ctypes.string_at(outp, outlen.value)
        finally:
            self._lib.tft_buf_free(outp)
        return wire.decode(out)

    def close(self) -> None:
        if self._h:
            self._lib.tft_client_free(self._h)
            self._h = 0

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# The fixed log2 bucket grid of the native latency histograms, in seconds;
# it mirrors native/lathist.h (kMinExp=-20, kNumBounds=27): one bucket per
# binary order of magnitude from about 1 us to 64 s, plus an overflow
# slot. It equals telemetry.anatomy.LOG2_BUCKETS, so the Python and native
# distributions share one grid and merges across processes are exact.
LATHIST_BOUNDS_S = tuple(2.0 ** e for e in range(-20, 7))


def lathist_snapshot() -> Dict[str, Dict[str, Any]]:
    """This process's native latency histograms (dp.hop, dp.stripe,
    rpc.serve, quorum.fanout) as ``{op: {"counts": [int x 28], "count":
    int, "sum_ns": int}}``: raw per-bucket tallies on the
    :data:`LATHIST_BOUNDS_S` grid (the last slot is the overflow), so two
    processes' snapshots merge by elementwise addition."""
    lib = _load()
    outp = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_int64()
    err = _errbuf()
    code = lib.tft_lathist_snapshot(ctypes.byref(outp), ctypes.byref(outlen), err, _ERRLEN)
    if code != OK:
        _raise_status(code, err.value.decode())
    try:
        out = ctypes.string_at(outp, outlen.value)
    finally:
        lib.tft_buf_free(outp)
    return wire.decode(out)


def lathist_reset() -> None:
    """Zero every native latency histogram of this process."""
    _load().tft_lathist_reset()


def tsdb_snapshot() -> Dict[str, Dict[str, Any]]:
    """This process's time-series store (the in-process lighthouse's sample
    rings, ``native/tsdb.h``) as ``{replica: {series: {"samples": [[epoch,
    step, value], ...]}}}``, oldest first: what ``GET /timeseries.json``
    serves."""
    lib = _load()
    outp = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_int64()
    err = _errbuf()
    code = lib.tft_tsdb_snapshot(ctypes.byref(outp), ctypes.byref(outlen), err, _ERRLEN)
    if code != OK:
        _raise_status(code, err.value.decode())
    try:
        out = ctypes.string_at(outp, outlen.value)
    finally:
        lib.tft_buf_free(outp)
    return wire.decode(out)


def tsdb_reset() -> None:
    """Clear this process's time-series store (tests)."""
    _load().tft_tsdb_reset()


def prof_set_hz(hz: float) -> None:
    """Retarget the native sampling profiler's rate live (0 pauses, more
    arms: the diagnosis engine's burst boost; ``native/profiler.h``)."""
    _load().tft_prof_set_hz(float(hz))


def prof_hz() -> float:
    """The native profiler's current rate (the ``TORCHFT_PROF_HZ`` default
    resolved on the first call; 0 is disarmed)."""
    return float(_load().tft_prof_hz())


def prof_snapshot() -> str:
    """Flamegraph-ready collapsed stacks of every native sample so far:
    ``"label;root;...;leaf count\\n"`` per (thread label, stack), sorted.
    Cumulative: two snapshots' difference
    (``telemetry.profiler.subtract_folded``) is a capture window."""
    lib = _load()
    outp = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_int64()
    err = _errbuf()
    code = lib.tft_prof_snapshot(ctypes.byref(outp), ctypes.byref(outlen), err, _ERRLEN)
    if code != OK:
        _raise_status(code, err.value.decode())
    try:
        out = ctypes.string_at(outp, outlen.value)
    finally:
        lib.tft_buf_free(outp)
    return out.decode(errors="replace")


def prof_samples_total() -> int:
    """Native samples aggregated since the process started (or the last
    :func:`prof_reset`)."""
    return int(_load().tft_prof_samples_total())


def prof_reset() -> None:
    """Drop every aggregated native sample."""
    _load().tft_prof_reset()


def _server_address(getter: Any, h: int) -> str:
    buf = ctypes.create_string_buffer(512)
    getter(h, buf, 512)
    return buf.value.decode()


def lighthouse_create(
    bind: str,
    min_replicas: int,
    join_timeout_ms: int,
    quorum_tick_ms: int,
    heartbeat_timeout_ms: int,
    evict_probe_ms: int = 100,
) -> Tuple[int, str]:
    lib = _load()
    err = _errbuf()
    h = lib.tft_lighthouse_create(
        bind.encode(), min_replicas, join_timeout_ms, quorum_tick_ms,
        heartbeat_timeout_ms, evict_probe_ms, err, _ERRLEN,
    )
    if h == 0:
        raise RuntimeError(err.value.decode())
    return h, _server_address(lib.tft_lighthouse_address, h)


def lighthouse_shutdown(h: int) -> None:
    _load().tft_lighthouse_shutdown(h)


def manager_create(
    replica_id: str,
    lighthouse_addr: str,
    hostname: str,
    bind: str,
    store_addr: str,
    world_size: int,
    heartbeat_interval_ms: int,
    connect_timeout_ms: int,
) -> Tuple[int, str]:
    lib = _load()
    err = _errbuf()
    h = lib.tft_manager_create(
        replica_id.encode(), lighthouse_addr.encode(), hostname.encode(),
        bind.encode(), store_addr.encode(), world_size,
        heartbeat_interval_ms, connect_timeout_ms, err, _ERRLEN,
    )
    if h == 0:
        msg = err.value.decode()
        if "timed out" in msg:
            raise TimeoutError(msg)
        raise RuntimeError(msg)
    return h, _server_address(lib.tft_manager_address, h)


def manager_shutdown(h: int) -> None:
    _load().tft_manager_shutdown(h)


def store_create(bind: str) -> Tuple[int, str]:
    lib = _load()
    err = _errbuf()
    h = lib.tft_store_create(bind.encode(), err, _ERRLEN)
    if h == 0:
        raise RuntimeError(err.value.decode())
    return h, _server_address(lib.tft_store_address, h)


def store_shutdown(h: int) -> None:
    _load().tft_store_shutdown(h)


# ---------------------------------------------------------------------------
# cross-memory attach (process_vm_readv) and the striped data plane
# ---------------------------------------------------------------------------


class _iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


_libc_handle: Optional[ctypes.CDLL] = None


def _libc() -> ctypes.CDLL:
    global _libc_handle
    with _lib_lock:
        if _libc_handle is None:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            # ssize_t return: the default c_int would truncate a pull of
            # 2 GiB or more into a spurious error or a wrong offset
            libc.process_vm_readv.restype = ctypes.c_ssize_t
            libc.process_vm_readv.argtypes = [
                ctypes.c_int, ctypes.POINTER(_iovec), ctypes.c_ulong,
                ctypes.POINTER(_iovec), ctypes.c_ulong, ctypes.c_ulong,
            ]
            _libc_handle = libc
        return _libc_handle


def cma_read_into(pid: int, addr: int, view: memoryview) -> None:
    """process_vm_readv ``len(view)`` bytes from ``pid``'s address space
    straight into the writable buffer ``view`` (one copy: the pull of the
    point-to-point CMA path). Raises OSError when the kernel refuses."""
    libc = _libc()
    n = len(view)
    buf = (ctypes.c_char * n).from_buffer(view)
    off = 0
    while off < n:
        local = _iovec(ctypes.addressof(buf) + off, n - off)
        remote = _iovec(addr + off, n - off)
        got = libc.process_vm_readv(pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
        if got <= 0:
            raise OSError(ctypes.get_errno(), "process_vm_readv failed")
        off += got


def cma_read(pid: int, addr: int, n: int) -> bytes:
    """One process_vm_readv of ``n`` bytes from ``pid``'s address space:
    the rendezvous probe of the CMA transport (a token read proves the
    published pid is addressable from this pid namespace and that the
    ptrace policy allows the attach). Raises OSError when the kernel
    refuses."""
    libc = _libc()
    buf = ctypes.create_string_buffer(n)
    local = _iovec(ctypes.addressof(buf), n)
    remote = _iovec(addr, n)
    got = libc.process_vm_readv(pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
    if got != n:
        raise OSError(ctypes.get_errno(), "process_vm_readv failed")
    return buf.raw


class DataPlaneError(ConnectionError):
    """A native data-plane op failed; ``peer_rank`` is the ring rank whose
    socket broke (-1 when no peer can be named), for the eviction
    report."""

    def __init__(self, peer_rank: int, msg: str) -> None:
        super().__init__(msg)
        self.peer_rank = peer_rank


class NativeDataPlane:
    """The striped C++ gradient plane (``native/dataplane.cc``), one per
    collectives epoch: the rendezvous (store addresses, who dials whom)
    stays in Python; the allreduce's bytes never touch the interpreter
    (ctypes drops the GIL for the call)."""

    DTYPE_F32 = 0
    OP = {"sum": 0, "avg": 1, "max": 2, "min": 3}
    # wire codecs (native/dataplane.h DpCodec; the formats are
    # wire_codec.py's byte for byte)
    CODEC = {"f32": 0, "bfloat16": 1, "int8": 2}

    def __init__(self, rank: int, world: int, nstripes: int = 4) -> None:
        self._lib = _load()
        err = _errbuf()
        self._h = self._lib.tft_dp_create(rank, world, nstripes, err, _ERRLEN)
        if self._h == 0:
            raise RuntimeError(f"dataplane create: {err.value.decode()}")
        self.rank = rank
        self.world = world
        self.nstripes = nstripes
        self.port = int(self._lib.tft_dp_port(self._h))

    def connect(self, peer: int, host: str, port: int, timeout_ms: int) -> None:
        err = _errbuf()
        rc = self._lib.tft_dp_connect(
            self._h, peer, host.encode(), port, timeout_ms, err, _ERRLEN
        )
        if rc != 0:
            raise DataPlaneError(peer, f"dataplane dial {peer}: {err.value.decode()}")

    def wait_ready(self, timeout_ms: int) -> None:
        err = _errbuf()
        rc = self._lib.tft_dp_wait_ready(self._h, timeout_ms, err, _ERRLEN)
        if rc != 0:
            raise TimeoutError(f"dataplane rendezvous: {err.value.decode()}")

    def enable_cma(self, pids: List[int]) -> None:
        """Switch ring payloads to cross-memory attach (one-copy pulls from
        the left neighbour's address space). The caller has proven every
        rank same-host and CMA-capable; ``pids`` is indexed by rank."""
        arr = (ctypes.c_int64 * len(pids))(*pids)
        err = _errbuf()
        rc = self._lib.tft_dp_enable_cma(self._h, arr, len(pids), err, _ERRLEN)
        if rc != 0:
            raise RuntimeError(f"enable_cma: {err.value.decode()}")

    def allreduce(
        self,
        ptr: int,
        nelems: int,
        op: str,
        codec: Union[int, str] = 0,
        tag: int = 0,
        timeout_ms: int = 60000,
    ) -> None:
        """In-place float32 ring allreduce of the buffer at ``ptr``.
        Blocking, with the GIL released: the caller keeps the buffer alive
        until it returns. A lossy ``codec`` quantizes the wire while the
        accumulation stays float32, and the decoded result is bitwise
        identical on every rank."""
        err = _errbuf()
        bad_peer = ctypes.c_int(-1)
        codec_i = self.CODEC[codec] if isinstance(codec, str) else int(codec)
        rc = self._lib.tft_dp_allreduce(
            self._h, ptr, nelems, self.DTYPE_F32, self.OP[op], codec_i, tag,
            timeout_ms, ctypes.byref(bad_peer), err, _ERRLEN,
        )
        if rc == -2:
            # a deadline names no peer: slow-but-alive stays retryable,
            # never an accusation that evicts
            raise TimeoutError(f"dataplane allreduce: {err.value.decode()}")
        if rc != 0:
            raise DataPlaneError(
                int(bad_peer.value), f"dataplane allreduce: {err.value.decode()}"
            )

    def close(self) -> None:
        if self._h:
            self._lib.tft_dp_free(self._h)
            self._h = 0

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the checkpoint blob plane (native/blob.cc)
# ---------------------------------------------------------------------------


class BlobServer:
    """The serving side of the striped heal's blob plane: stages the
    flattened state's host buffers (scattered, no coalescing copy) and
    serves any byte range of their logical concatenation to healers, off
    the GIL. The caller keeps the staged buffers alive, contiguous, until
    :meth:`unstage` returns."""

    def __init__(self) -> None:
        self._lib = _load()
        err = _errbuf()
        self._h = self._lib.tft_blob_serve_create(err, _ERRLEN)
        if self._h == 0:
            raise RuntimeError(f"blob server create: {err.value.decode()}")
        self.port = int(self._lib.tft_blob_serve_port(self._h))

    def stage(self, ptrs: List[int], lens: List[int], token: int) -> None:
        """Open the serving window over the buffers at ``ptrs`` / ``lens``
        (base addresses and byte lengths, in stream order). ``token`` names
        this staging; a fetch that carries another token gets a stale
        error, never stale bytes."""
        n = len(ptrs)
        arr_p = (ctypes.c_uint64 * n)(*ptrs)
        arr_l = (ctypes.c_int64 * n)(*lens)
        err = _errbuf()
        rc = self._lib.tft_blob_stage(self._h, arr_p, arr_l, n, token, err, _ERRLEN)
        if rc != 0:
            raise RuntimeError(f"blob stage: {err.value.decode()}")

    def unstage(self) -> None:
        """Close the serving window; returns once no serve in flight still
        reads the staged buffers (they may be freed after this)."""
        if self._h:
            self._lib.tft_blob_unstage(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.tft_blob_serve_free(self._h)
            self._h = 0

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def blob_fetch(
    host: str,
    port: int,
    token: int,
    offset: int,
    length: int,
    view: memoryview,
    timeout_ms: int = 60000,
) -> None:
    """Pull ``length`` bytes at ``offset`` of a peer's staged blob straight
    into the writable buffer ``view`` (the healer's range primitive; the
    GIL is released for the call). Raises TimeoutError on the deadline and
    ConnectionError on any other failure: a cut connection is a failed
    range, never short data."""
    if len(view) != length:
        raise ValueError(f"blob fetch: a view of {len(view)} bytes for {length}")
    lib = _load()
    buf = (ctypes.c_char * length).from_buffer(view)
    err = _errbuf()
    rc = lib.tft_blob_fetch(
        host.encode(), port, token, offset, length,
        ctypes.addressof(buf), timeout_ms, err, _ERRLEN,
    )
    if rc == -2:
        raise TimeoutError(f"blob fetch: {err.value.decode()}")
    if rc != 0:
        raise ConnectionError(f"blob fetch: {err.value.decode()}")
