"""Key-value store — TCPStore analogue for rendezvous and bootstrap.

The reference leans on torch's TCPStore for (a) publishing the manager
address to the replica group (torchft/manager.py:176-212) and (b) epoch-
scoped process-group rendezvous with a ``host:port/prefix`` convention
(torchft/process_group.py:85-103). This module provides the same two roles
on top of the C++ KvStore server (native/coord.cc).

Address convention: ``host:port[/prefix]`` — prefixes nest, and quorum
epochs use ``{store}/torchft/{quorum_id}/{rank}`` exactly like the
reference (torchft/manager.py:472).
"""

from __future__ import annotations

from datetime import timedelta
from typing import List, Optional

from torchft_tpu_torch import _native

__all__ = ["StoreServer", "StoreClient", "create_store_client"]


class StoreServer:
    """In-process KV store server (C++, native/coord.cc KvStore)."""

    def __init__(self, bind: str = "[::]:0") -> None:
        self._handle, self._address = _native.store_create(bind)

    def address(self) -> str:
        """``host:port`` of this store."""
        return self._address

    @property
    def port(self) -> int:
        return int(self._address.rsplit(":", 1)[1])

    def shutdown(self) -> None:
        if self._handle:
            _native.store_shutdown(self._handle)
            self._handle = 0

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass


class StoreClient:
    """Client for a StoreServer with key-prefix scoping."""

    def __init__(
        self,
        addr: str,
        prefix: str = "",
        connect_timeout: timedelta = timedelta(seconds=60),
        default_timeout: timedelta = timedelta(seconds=60),
    ) -> None:
        self._client = _native.NativeClient(
            addr if "://" in addr else f"tft://{addr}",
            int(connect_timeout.total_seconds() * 1000),
        )
        self._prefix = prefix
        self._default_timeout = default_timeout

    def _k(self, key: str) -> str:
        return f"{self._prefix}{key}"

    def _ms(self, timeout: Optional[timedelta]) -> int:
        t = timeout or self._default_timeout
        return max(1, int(t.total_seconds() * 1000))

    def set(self, key: str, value: bytes | str) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._client.call("store.set", {"k": self._k(key), "v": value}, self._ms(None))

    def get(self, key: str, timeout: Optional[timedelta] = None, wait: bool = True) -> bytes:
        resp = self._client.call(
            "store.get", {"k": self._k(key), "wait": wait}, self._ms(timeout)
        )
        return resp["v"]

    def add(self, key: str, delta: int = 1) -> int:
        resp = self._client.call(
            "store.add", {"k": self._k(key), "delta": delta}, self._ms(None)
        )
        return resp["v"]

    def delete(self, key: str) -> None:
        self._client.call("store.del", {"k": self._k(key)}, self._ms(None))

    def keys(self, prefix: str = "") -> List[str]:
        resp = self._client.call(
            "store.keys", {"prefix": self._k(prefix)}, self._ms(None)
        )
        return resp["keys"]

    def with_prefix(self, prefix: str) -> "StoreClient":
        """A view of the same store under an extended prefix (PrefixStore
        analogue). Shares the underlying connection."""
        out = StoreClient.__new__(StoreClient)
        out._client = self._client
        out._prefix = f"{self._prefix}{prefix}"
        out._default_timeout = self._default_timeout
        return out

    def close(self) -> None:
        self._client.close()


def create_store_client(
    store_addr: str, connect_timeout: timedelta = timedelta(seconds=60)
) -> StoreClient:
    """Parse ``host:port[/prefix]`` into a prefixed client
    (torchft/process_group.py:85-103 analogue; trailing '/' appended so key
    joins are unambiguous)."""
    if "/" in store_addr:
        hostport, prefix = store_addr.split("/", 1)
        prefix = prefix.rstrip("/") + "/"
    else:
        hostport, prefix = store_addr, ""
    return StoreClient(hostport, prefix=prefix, connect_timeout=connect_timeout)
