"""HTTP checkpoint transport — the live-recovery path of the port, a
single-source copy of ``torchft_tpu/checkpointing/http_transport.py``.

An in-process ``ThreadingHTTPServer`` serves the staged state at
``/checkpoint/{step}/full``; a readers-writer lock gates the serving
window, so a healer's GET blocks until ``send_checkpoint`` stages fresh
state and the commit barrier's ``disallow_checkpoint`` waits for active
readers. Striped multi-source heal, differential heal and the native blob
plane are not ported yet (ROADMAP).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import urllib.request
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Generic, List, Optional, TypeVar

import numpy as np

from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.serialization import (
    as_bytes,
    flatten_state,
    load_state,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["HTTPTransport"]


class _Server(ThreadingHTTPServer):
    address_family = socket.AF_INET6
    request_queue_size = 1024
    daemon_threads = True


class HTTPTransport(CheckpointTransport[T], Generic[T]):
    """Serves the staged checkpoint over HTTP. A received state tree is
    host staging: the receiver's ``load_state_dict`` copies it into its
    own tensors, which puts it on the receiver's device."""

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        hostname: Optional[str] = None,
    ) -> None:
        self._timeout = timeout
        self._hostname = hostname or socket.gethostname()
        self._lock = RWLock(timeout=timeout.total_seconds())
        self._step: Optional[int] = None
        self._header: Optional[bytes] = None
        self._buffers: List[np.ndarray] = []
        # serving starts disallowed: readers block until the first staging.
        # Only the manager's quorum/commit path flips the window.
        self._lock.w_acquire()
        self._allowed = False

        transport = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self) -> None:
                # bound socket writes so one stalled healer can't hold the
                # read lock (and with it the next commit) forever
                self.connection.settimeout(transport._timeout.total_seconds())
                try:
                    transport._lock.r_acquire()
                except TimeoutError:
                    self.send_error(503, "no checkpoint staged within timeout")
                    return
                try:
                    parts = self.path.strip("/").split("/")
                    if len(parts) != 3 or parts[0] != "checkpoint" or parts[2] != "full":
                        self.send_error(404, f"bad path {self.path}")
                        return
                    step = int(parts[1])
                    if step != transport._step:
                        self.send_error(
                            410, f"step {step} not staged (have {transport._step})"
                        )
                        return
                    payload = transport._render_full()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(sum(len(p) for p in payload)))
                    self.end_headers()
                    for part in payload:
                        self.wfile.write(part)
                except (BrokenPipeError, socket.timeout):
                    pass
                except Exception as e:  # noqa: BLE001 — report to the peer
                    logger.exception("checkpoint GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:
                        pass
                finally:
                    transport._lock.r_release()

        self._server = _Server(("::", 0), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tft_ckpt_http", daemon=True
        )
        self._thread.start()

    def _render_full(self) -> List[bytes]:
        assert self._header is not None
        out = [struct.pack("<Q", len(self._header)), self._header]
        out.extend(as_bytes(b) for b in self._buffers)
        return out

    # -- CheckpointTransport --

    def metadata(self) -> str:
        return f"http://{self._hostname}:{self._port}"

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: timedelta
    ) -> None:
        # reclaim the write lock if a previous window is still open (a step
        # aborted before should_commit closed it), so staging never races
        # an active GET
        self.disallow_checkpoint()
        self._header, self._buffers = flatten_state(state_dict)
        self._step = step
        self._lock.w_release()  # open the serving window
        self._allowed = True

    def disallow_checkpoint(self) -> None:
        if self._allowed:
            self._lock.w_acquire()
            self._allowed = False

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        url = f"{metadata}/checkpoint/{step}/full"
        with urllib.request.urlopen(url, timeout=timeout.total_seconds()) as resp:
            return load_state(resp)

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)
