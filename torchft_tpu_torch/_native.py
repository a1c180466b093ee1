"""ctypes loader for the C++ coordination core (``native/``) — the port's
copy of ``torchft_tpu/_native/__init__.py``, trimmed to what the FT
training step uses: the RPC client, the lighthouse, the manager server
and the key-value store.

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
from typing import Any, Dict, Optional, Tuple

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
