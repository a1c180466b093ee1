"""Fault-tolerant parameter server on reconfigurable collectives — the
port's copy of ``torchft_tpu/parameter_server.py``.

Reference: torchft/parameter_server.py:31-195 — lighthouse-free fault
tolerance: each client asks ``/new_session`` over HTTP, the server hijacks
that request thread for the session's lifetime, and both sides configure a
fresh two-rank collectives epoch through a session-scoped store namespace.
A dead peer simply means the session dies; the client creates a new one —
no global coordination needed.

Server is always rank 0, client rank 1. The sessions run on the port's
host collectives (``CollectivesTcp`` over numpy arrays, or a
``CollectivesProxy`` around one); ``GET /metrics`` serves the port's
Prometheus exposition.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from torchft_tpu_torch import telemetry
from torchft_tpu_torch.collectives import Collectives
from torchft_tpu_torch.store import StoreServer

logger = logging.getLogger(__name__)

__all__ = ["ParameterServer"]


class _IPv6Server(ThreadingHTTPServer):
    address_family = socket.AF_INET6
    request_queue_size = 1024
    daemon_threads = True


class ParameterServer(ABC):
    """Threaded parameter server over reconfigurable collectives."""

    def __init__(self, port: int = 0) -> None:
        self.store = StoreServer()
        ps = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"  # connection closes after response

            def log_message(self, fmt, *args):
                pass

            def do_GET(self) -> None:
                # Prometheus exposition, the route every HTTPTransport
                # serves: the parameter server runs its own HTTP surface
                if self.path.rstrip("/") == "/metrics":
                    body = telemetry.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    try:
                        self.wfile.write(body)
                    except BrokenPipeError:
                        pass
                    return
                if self.path != "/new_session":
                    self.send_error(400, f"invalid path {self.path}")
                    return
                session_id = str(uuid.uuid4())
                store_addr = f"{ps.store.address()}/session/{session_id}"
                logger.info("creating new session %s", session_id)
                body = (
                    json.dumps(
                        {"session_id": session_id, "store_addr": store_addr}
                    )
                    + "\n"
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                # close eagerly so the client knows the JSON is complete,
                # then hijack this thread for the whole session
                self.finish()
                self.connection.close()
                try:
                    ps._handle_session(session_id, store_addr)
                except Exception:
                    logger.exception("session %s failed", session_id)

        self._server = _IPv6Server(("::", port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="tft_param_server"
        )
        self._thread.start()

    def address(self) -> str:
        """``http://host:port/new_session``."""
        port = self._server.socket.getsockname()[1]
        return f"http://{socket.gethostname()}:{port}/new_session"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self.store.shutdown()

    # -- subclass interface --

    @classmethod
    @abstractmethod
    def new_collectives(cls) -> Collectives:
        """A fresh unconfigured Collectives backend (configured per session)."""

    @abstractmethod
    def forward(self, session_id: str, collectives: Collectives) -> None:
        """Runs once per session on a dedicated thread (loop inside for
        multi-op sessions). Errors free the session; the client reconnects."""

    # -- wiring --

    def _handle_session(self, session_id: str, store_addr: str) -> None:
        coll = self.new_collectives()
        coll.configure(store_addr, rank=0, world_size=2)
        try:
            self.forward(session_id, coll)
        finally:
            coll.shutdown()

    @classmethod
    def new_session(cls, address: str, timeout: float = 60.0) -> Collectives:
        """Client side: create a session, return rank-1-configured
        collectives."""
        import urllib.request

        with urllib.request.urlopen(address, timeout=timeout) as f:
            data = json.load(f)
        logger.info("connecting to session %s", data["session_id"])
        coll = cls.new_collectives()
        coll.configure(data["store_addr"], rank=1, world_size=2)
        return coll
