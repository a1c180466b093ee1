"""HTTP checkpoint transport — the live-recovery path of the port, a copy
of ``torchft_tpu/checkpointing/http_transport.py``.

An in-process ``ThreadingHTTPServer`` serves the staged state under
``/checkpoint/{step}/...``; a readers-writer lock gates the serving
window, so a healer's GET blocks until ``send_checkpoint`` stages fresh
state and the commit barrier's ``disallow_checkpoint`` waits for active
readers. A received state tree is host staging: the receiver's
``load_state_dict`` copies it into its own tensors, on its own device.

Endpoints (``/checkpoint/{step}/<what>``):

* ``full``: ``u64 header_len | header | buffers``, the single-source heal
  (:meth:`HTTPTransport.recv_checkpoint`);
* ``metadata`` and ``chunk_{i}``: the chunked mode (``num_chunks > 0``),
  the header and a manifest that groups whole buffers into size-balanced
  chunks fetched in parallel;
* ``stripemeta``: what a striped healer plans with (the header, the
  buffer layout, the staged tree digest, the staging token and the blob
  plane's port);
* ``range_{off}_{len}``: a byte range of the buffers' concatenation, the
  HTTP fallback of the blob plane;
* ``delta_{since}_{digest}``: the differential heal
  (:mod:`~torchft_tpu_torch.checkpointing.delta`).

The striped multi-source heal (:meth:`HTTPTransport.recv_checkpoint_multi`)
pulls byte-balanced ranges of the flattened state from every source whose
staged tree digest equals the primary's, in parallel; a source that dies
mid-heal hands its pending ranges to the survivors. The bulk bytes ride
the native blob plane (``native/blob.cc``, off the GIL) and fall back to
``range_`` when a source advertises no blob port.

``GET /metrics`` serves the process's telemetry (Prometheus text) and
``GET /critical_path.json`` its critical-path attributor's report, neither
needing checkpoint state. Every request a healer sends carries its trace
context in the ``X-TFT-Trace`` header, and the serving side records a
``checkpoint_serve`` span in the healer's trace. Stagings, sends and
receives are counted (``record_checkpoint``, the ``checkpoint_send`` /
``checkpoint_recv`` trail events), and the striped receive's stages
(``meta``, ``recv``, ``decode``) go into the ledger's heal-stage totals.

Fault points (``faultinject.core``): ``ckpt.serve`` as a checkpoint GET is
about to stream (``torn`` / ``drop`` promise the whole Content-Length,
stream a prefix and cut the connection, as a source dying mid-heal does),
and ``ckpt.recv`` as a receive starts (both receive paths).
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import threading
import time
import urllib.parse
import urllib.request
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Generic, List, Optional, Tuple, TypeVar

import numpy as np

from torchft_tpu_torch import telemetry
from torchft_tpu_torch.checkpointing import delta as delta_mod
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.serialization import (
    as_bytes,
    buffer_sizes,
    flatten_state,
    load_state,
    read_exact,
    unflatten_state,
)
from torchft_tpu_torch.checkpointing.stripes import (
    assign_chunk_groups,
    heal_sources_limit,
    heal_stripes_per_source,
    slice_buffers,
    stripe_ranges,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.faultinject.core import fault_point

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["HTTPTransport"]

# The JAX package reads these from TORCHFT_HEAL_META_TIMEOUT_S and
# TORCHFT_HEAL_NATIVE; nothing in the port sets other values, so they are
# constants (a test patches them). Its TORCHFT_HEAL_DIGEST=0, which turns
# the staging digests and with them the striped and differential heals
# off, is not ported: every staging digests its leaves.
#
# How long a striped endpoint waits for a staging window: long enough for
# a source mid-staging, short enough that a source that will not stage
# this round (its quorum ran allow_heal=False) costs seconds, not the
# transfer timeout.
META_TIMEOUT_S = 5.0
# What a striped endpoint answers (a 503) when the bound passes while its
# source is still staging (a state whose host copy and digests take longer
# than META_TIMEOUT_S: the Llama-2-7B width's 4.3 GB): the healer asks
# again until its transfer deadline instead of dropping the source.
STAGING_IN_PROGRESS = "checkpoint staging in progress"
# the bulk heal bytes ride the native blob plane (else HTTP ranges)
HEAL_NATIVE = True


TRACE_HEADER = "X-TFT-Trace"


def _traced_urlopen(url: str, timeout: float, carrier: Optional[Dict[str, str]] = None):
    """urlopen with a trace context in the ``X-TFT-Trace`` header, so the
    serving side records its span in the requester's trace. ``carrier``
    defaults to this thread's; a fetch on a pool thread is handed the
    caller's, taken on the thread that holds the heal's span."""
    req = urllib.request.Request(url)
    try:
        req.add_header(TRACE_HEADER, telemetry.TRACER.format_carrier(
            carrier if carrier is not None else telemetry.TRACER.inject()))
    except Exception:  # noqa: BLE001 — tracing must never fail a transfer
        pass
    return urllib.request.urlopen(req, timeout=timeout)


class _Server(ThreadingHTTPServer):
    address_family = socket.AF_INET6
    request_queue_size = 1024
    daemon_threads = True


# staging tokens are process-wide, so a transport made anew in the same
# process never reissues a token an old healer still holds
_STAGING_TOKEN = iter(range(1, 1 << 62))
_STAGING_TOKEN_LOCK = threading.Lock()


def _next_token() -> int:
    with _STAGING_TOKEN_LOCK:
        return next(_STAGING_TOKEN)


def _call_header_cb(header_cb: Optional[Callable[[bytes], None]], header: bytes) -> None:
    if header_cb is None:
        return
    try:
        header_cb(header)
    except Exception:  # noqa: BLE001 — the callback is best-effort
        logger.exception("heal header callback failed")


class HTTPTransport(CheckpointTransport[T], Generic[T]):
    """Serves the staged checkpoint over HTTP (and its bytes over the blob
    plane) from an in-process server."""

    def __init__(
        self,
        timeout: timedelta = timedelta(seconds=60),
        num_chunks: int = 0,
        hostname: Optional[str] = None,
    ) -> None:
        self._timeout = timeout
        self._num_chunks = num_chunks
        self._hostname = hostname or socket.gethostname()
        # payload bytes of the last receive
        self.last_recv_bytes: int = 0
        # the last multi-source receive: mode, per-source bytes, seconds,
        # ranges and rate, the stages' seconds
        self.last_heal_stats: Dict[str, Any] = {}
        # the differential heal's digest trail; the Manager attaches it
        # when TORCHFT_HEAL_DIFF is on
        self.commit_trail: Optional[delta_mod.CommitTrail] = None

        self._lock = RWLock(timeout=timeout.total_seconds())
        self._step: Optional[int] = None
        self._header: Optional[bytes] = None
        self._buffers: List[np.ndarray] = []
        self._sizes: List[int] = []
        self._total = 0
        self._digests: List[str] = []
        self._tree_digest: Optional[str] = None
        self._groups: List[List[int]] = []
        self._token = 0
        # unguarded-ok: set and cleared by send_checkpoint's thread around
        #   a staging, read by the server's handlers (a hint: at worst a
        #   healer asks once more, or gives up a round early)
        self._staging = False
        # the native blob server, made at the first staging; None when the
        # native core cannot serve (then the HTTP ranges do)
        self._blob = None
        self._blob_failed = False
        # unguarded-ok: set once by shutdown, read by a staging that may
        #   still run on the manager's quorum thread after
        #   shutdown(wait=False): it then makes no blob server (whose
        #   acceptor thread would outlive the transport), or closes the one
        #   it made
        self._closed = False
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
                # /metrics and /critical_path.json need no checkpoint state:
                # served before the staging lock, so a scrape answers while
                # nothing is staged
                path = self.path.rstrip("/")
                if path in ("/metrics", "/critical_path.json"):
                    if path == "/metrics":
                        body = telemetry.render_prometheus().encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        # the process's critical-path attributor (an empty
                        # report when no monitor runs here)
                        from torchft_tpu_torch.telemetry import critical_path

                        body = critical_path.report_json().encode()
                        ctype = "application/json"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    try:
                        self.wfile.write(body)
                    except (BrokenPipeError, ConnectionResetError, socket.timeout):
                        pass
                    return
                # bound socket writes so one stalled healer can't hold the
                # read lock (and with it the next commit) forever
                self.connection.settimeout(transport._timeout.total_seconds())
                parts = self.path.strip("/").split("/")
                # the striped endpoints wait only briefly for a staging
                # window: a healer probing a source whose quorum round ran
                # allow_heal=False would otherwise wait the whole transfer
                # timeout for a window that never opens this round
                bounded = len(parts) == 3 and (
                    parts[2] == "stripemeta" or parts[2].startswith(("range_", "delta_"))
                )
                try:
                    transport._lock.r_acquire(timeout=META_TIMEOUT_S if bounded else None)
                except TimeoutError:
                    self.send_error(503, STAGING_IN_PROGRESS if transport._staging
                                    else "no checkpoint staged within timeout")
                    return
                try:
                    if len(parts) != 3 or parts[0] != "checkpoint":
                        self.send_error(404, f"bad path {self.path}")
                        return
                    step = int(parts[1])
                    if step != transport._step:
                        self.send_error(410, f"step {step} not staged (have {transport._step})")
                        return
                    payload = transport._render(parts[2])
                    if payload is None:
                        self.send_error(404, f"bad path {self.path}")
                        return
                    nbytes = sum(len(p) for p in payload)
                    inj = fault_point("ckpt.serve", match=parts[2], wire=True, step=step,
                                      nbytes=nbytes)
                    if inj is not None and inj.action in ("drop", "torn"):
                        # the healer must fail the transfer on the short
                        # read, never stage the torn state; it retries at
                        # its next quorum
                        self._serve_torn(payload, inj.frac if inj.action == "torn" else 0.0)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(nbytes))
                    self.end_headers()
                    t0 = time.perf_counter()
                    # the healer's trace context rides the request: this
                    # span joins its trace (trace_id and parent) but keeps
                    # this replica's identity, so it renders on the serving
                    # replica's lane
                    carrier = telemetry.TRACER.parse_carrier(
                        self.headers.get(TRACE_HEADER, "") or "")
                    with telemetry.TRACER.span(
                        "checkpoint_serve", parent=carrier,
                        replica_id=telemetry.TRACER.context()["replica_id"] or None,
                        path=self.path, bytes=nbytes,
                    ):
                        for part in payload:
                            self.wfile.write(part)
                    telemetry.record_checkpoint("send", nbytes, time.perf_counter() - t0, "http")
                except (BrokenPipeError, ConnectionResetError, socket.timeout):
                    pass
                except Exception as e:  # noqa: BLE001 — report to the peer
                    logger.exception("checkpoint GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:
                        pass
                finally:
                    transport._lock.r_release()

            def _serve_torn(self, payload: List[Any], frac: float) -> None:
                nbytes = sum(len(p) for p in payload)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(nbytes))
                self.end_headers()
                budget = int(nbytes * frac)
                try:
                    for part in payload:
                        if budget <= 0:
                            break
                        chunk = part[:budget]
                        self.wfile.write(chunk)
                        budget -= len(chunk)
                    self.wfile.flush()
                finally:
                    # a hard cut: the client sees EOF mid-body, as when the
                    # serving process dies mid-transfer
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        self._server = _Server(("::", 0), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tft_ckpt_http", daemon=True
        )
        self._thread.start()

    # -- render (read lock held) --

    def _render(self, what: str) -> Optional[List[Any]]:
        """The body parts of one endpoint, or None for an unknown one."""
        assert self._header is not None
        if what == "full":
            out: List[Any] = [struct.pack("<Q", len(self._header)), self._header]
            out.extend(as_bytes(b) for b in self._buffers)
            return out
        if what == "metadata":
            return [pickle.dumps((self._header, self._groups))]
        if what.startswith("chunk_"):
            return [as_bytes(self._buffers[j]) for j in self._groups[int(what[len("chunk_"):])]]
        if what == "stripemeta":
            return [pickle.dumps({
                "step": self._step,
                "header": self._header,
                "sizes": list(self._sizes),
                "total": self._total,
                "tree_digest": self._tree_digest,
                "token": self._token,
                "blob_port": getattr(self._blob, "port", None),
            })]
        if what.startswith("range_"):
            _, off_s, len_s = what.split("_")
            offset, length = int(off_s), int(len_s)
            if offset < 0 or length <= 0 or offset + length > self._total:
                raise ValueError(f"bad range [{offset}, {offset + length}) of {self._total}")
            return list(slice_buffers(self._buffers, self._sizes, offset, length))
        if what.startswith("delta_"):
            _, since_s, digest = what.split("_")
            return self._render_delta(int(since_s), digest)
        return None

    def _render_delta(self, since_step: int, healer_digest: str) -> List[Any]:
        """The buffers that changed since the healer's last committed step,
        or a ``{"mode": "full"}`` refusal whenever a delta is not provably
        sound (no trail, no trail entry for that step, a digest
        mismatch)."""
        trail = self.commit_trail
        built = None
        if trail is not None:
            built = delta_mod.build_delta(
                self._header, self._buffers, self._digests, trail.get(since_step), healer_digest
            )
        if built is None:
            return delta_mod.pack_delta({"mode": "full"}, [])
        return delta_mod.pack_delta(*built)

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
        self._staging = True
        try:
            self._stage(step, state_dict, dst_ranks)
        finally:
            self._staging = False

    def _stage(self, step: int, state_dict: T, dst_ranks: List[int]) -> None:
        t0 = time.perf_counter()
        header, buffers = flatten_state(state_dict)
        # the blob plane serves raw base pointers: pin contiguity (flatten
        # already returns contiguous host copies)
        self._buffers = [np.ascontiguousarray(b) for b in buffers]
        self._header = header
        self._sizes = [int(b.nbytes) for b in self._buffers]
        self._total = sum(self._sizes)
        nbytes = len(header) + self._total
        telemetry.record_checkpoint("stage", nbytes, time.perf_counter() - t0, "http")
        telemetry.emit("checkpoint_send", transport="http", dst_ranks=list(dst_ranks),
                       step=step, bytes=nbytes)
        trail = self.commit_trail
        digests = None
        if trail is not None:
            # the Manager recorded the trail from the same state at the step
            # boundary: reuse its digests instead of hashing again
            ent = trail.get(step)
            if ent is not None and ent["sizes"] == self._sizes:
                digests = list(ent["leaves"])
        if digests is None:
            digests = delta_mod.leaf_digests(self._buffers)
            if trail is not None:
                trail.record(step, self._buffers, digests=digests)
        self._digests = digests
        self._tree_digest = delta_mod.tree_digest(digests)
        nchunks = min(self._num_chunks, len(self._buffers)) if self._num_chunks else 0
        self._groups = assign_chunk_groups(self._sizes, nchunks) if nchunks else []
        self._step = step
        self._token = _next_token()
        self._stage_blob()
        self._lock.w_release()  # open the serving window
        self._allowed = True

    def _stage_blob(self) -> None:
        """Stage the buffers on the native blob plane. A failure leaves the
        HTTP ranges serving (the stripemeta then advertises no port) and is
        logged: phase 15 of ``chip_smoke.py`` fails a heal that should have
        ridden the blob plane and did not."""
        if not HEAL_NATIVE or self._blob_failed or self._closed:
            return
        try:
            if self._blob is None:
                from torchft_tpu_torch import _native

                self._blob = _native.BlobServer()
                if self._closed:  # shutdown ran meanwhile and saw no server
                    self._blob.close()
                    return
            self._blob.stage([b.ctypes.data for b in self._buffers], self._sizes, self._token)
        except Exception as e:  # noqa: BLE001 — the HTTP ranges stay correct
            logger.warning("native blob staging unavailable: %s", e)
            self._blob = None
            self._blob_failed = True

    def disallow_checkpoint(self) -> None:
        if self._allowed:
            self._lock.w_acquire()
            self._allowed = False
        if self._blob is not None:
            # returns once no native serve in flight still reads the staged
            # buffers, so the next staging may drop them
            self._blob.unstage()

    # -- single-source receive --

    def _record_recv(self, nbytes: int, seconds: float, step: int) -> None:
        self.last_recv_bytes = nbytes
        telemetry.record_checkpoint("recv", nbytes, seconds, "http")
        telemetry.emit("checkpoint_recv", transport="http", step=step, bytes=nbytes,
                       duration_s=round(seconds, 4))

    def _fetch_full(self, base: str, secs: float, step: int) -> T:
        t0 = time.perf_counter()
        with _traced_urlopen(f"{base}/full", timeout=secs) as resp:
            state = load_state(resp)
            nbytes = int(resp.headers.get("Content-Length") or 0)
        self._record_recv(nbytes, time.perf_counter() - t0, step)
        return state

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        fault_point("ckpt.recv", match=str(step), step=step)
        base = f"{metadata}/checkpoint/{step}"
        secs = timeout.total_seconds()
        if self._num_chunks == 0:
            return self._fetch_full(base, secs, step)
        t0 = time.perf_counter()
        with _traced_urlopen(f"{base}/metadata", timeout=secs) as resp:
            header, groups = pickle.loads(resp.read())
        if not groups:
            # the sender staged unchunked (its num_chunks=0 wins over ours)
            return self._fetch_full(base, secs, step)
        _, infos = pickle.loads(header)
        sizes = buffer_sizes(infos)
        buffers: List[Optional[bytearray]] = [None] * len(sizes)
        carrier = telemetry.TRACER.inject()

        def fetch(ci: int) -> None:
            with _traced_urlopen(f"{base}/chunk_{ci}", timeout=secs, carrier=carrier) as r:
                for j in groups[ci]:
                    buffers[j] = read_exact(r, sizes[j])

        with ThreadPoolExecutor(max_workers=len(groups)) as pool:
            for f in [pool.submit(fetch, ci) for ci in range(len(groups))]:
                f.result()
        self._record_recv(len(header) + sum(sizes), time.perf_counter() - t0, step)
        return unflatten_state(header, buffers)

    # -- striped multi-source receive --

    def recv_checkpoint_multi(
        self,
        sources: List[str],
        step: int,
        timeout: timedelta,
        since_step: Optional[int] = None,
        own: Optional[Tuple[List[np.ndarray], str]] = None,
        header_cb: Optional[Callable[[bytes], None]] = None,
    ) -> T:
        """Fetch ``step``'s state striped across ``sources`` (each a
        transport metadata URL; ``sources[0]`` is the lighthouse-named
        primary). With ``since_step`` and ``own`` (this replica's flattened
        buffers and tree digest at ``since_step``) the differential heal is
        tried first. ``header_cb`` gets the header as soon as it is known,
        before any bulk bytes land."""
        fault_point("ckpt.recv", match=str(step), step=step)
        if not sources:
            raise ValueError("need at least one heal source")
        secs = timeout.total_seconds()
        deadline = time.monotonic() + secs
        t_start = time.perf_counter()
        stats: Dict[str, Any] = {"mode": "striped", "sources": {}, "stages": {}}
        self.last_heal_stats = stats
        # the heal's span lives on this thread; the fetches on pool threads
        # carry it in their trace header
        carrier = telemetry.TRACER.inject()

        if since_step is not None and own is not None:
            state = self._try_delta(sources[0], step, since_step, own, secs, stats, header_cb)
            if state is not None:
                self._record_recv(int(stats["bytes"]), time.perf_counter() - t_start, step)
                return state

        # ---- stripe planning ----
        t0 = time.perf_counter()
        sources = sources[: heal_sources_limit()]
        metas: Dict[str, Dict[str, Any]] = {}
        meta_errors: Dict[str, str] = {}
        # the server answers within META_TIMEOUT_S (or 503s): a blackholed
        # host must not take the whole transfer deadline before a range moves
        meta_secs = min(secs, META_TIMEOUT_S + 5.0)

        def fetch_meta(src: str) -> None:
            while True:
                try:
                    with _traced_urlopen(
                        f"{src}/checkpoint/{step}/stripemeta", timeout=meta_secs,
                        carrier=carrier,
                    ) as r:
                        metas[src] = pickle.loads(r.read())
                    return
                except Exception as e:  # noqa: BLE001 — a dead source is dropped
                    if STAGING_IN_PROGRESS in str(e) and time.monotonic() < deadline:
                        continue  # a source still staging: ask again
                    meta_errors[src] = str(e)
                    return

        if len(sources) == 1:
            fetch_meta(sources[0])
        else:
            with ThreadPoolExecutor(
                max_workers=len(sources), thread_name_prefix="tft_heal_meta"
            ) as pool:
                list(pool.map(fetch_meta, sources))
        alive = [s for s in sources if s in metas]
        if not alive:
            raise ConnectionError(f"no heal source reachable for step {step}: {meta_errors}")
        primary = alive[0]
        pmeta = metas[primary]
        if pmeta.get("tree_digest"):
            # stripe only across sources that provably staged the same
            # bytes; anything else (a LocalSGD group's own inner state, a
            # source that restaged another step) takes fewer sources rather
            # than mixing two states
            active = []
            for s in alive:
                if metas[s].get("tree_digest") == pmeta["tree_digest"]:
                    active.append(s)
                else:
                    logger.warning(
                        "heal source %s staged another tree than the primary (digest %s vs "
                        "%s, %s vs %s bytes); left out of the stripes",
                        s, metas[s].get("tree_digest"), pmeta["tree_digest"],
                        metas[s].get("total"), pmeta.get("total"),
                    )
        else:
            active = [primary]
        header: bytes = pmeta["header"]
        sizes: List[int] = list(pmeta["sizes"])
        total: int = int(pmeta["total"])
        telemetry.LEDGER.record_heal_stage("meta", time.perf_counter() - t0)
        stats["stages"]["meta_s"] = round(time.perf_counter() - t0, 4)
        _call_header_cb(header_cb, header)

        # ---- striped fetch: a work queue, so a dead source's pending
        # ranges re-stripe onto the survivors ----
        t0 = time.perf_counter()
        dest = bytearray(total)
        mv = memoryview(dest)
        queue: deque = deque(stripe_ranges(total, len(active) * heal_stripes_per_source()))
        qlock = threading.Lock()
        failures: Dict[str, str] = {}
        done_bytes = [0]

        def fetch_range(src: str, off: int, length: int) -> None:
            left = max(0.1, deadline - time.monotonic())
            meta = metas[src]
            view = mv[off : off + length]
            if meta.get("blob_port") and HEAL_NATIVE:
                from torchft_tpu_torch import _native

                host = urllib.parse.urlsplit(src).hostname or "localhost"
                _native.blob_fetch(host, int(meta["blob_port"]), int(meta["token"]), off,
                                   length, view, timeout_ms=int(left * 1000))
                return
            url = f"{src}/checkpoint/{step}/range_{off}_{length}"
            with _traced_urlopen(url, timeout=left, carrier=carrier) as r:
                got = 0
                while got < length:
                    k = r.readinto(view[got:])
                    if not k:
                        raise EOFError(f"short range read {got}/{length} from {src}")
                    got += k

        def worker(src: str) -> None:
            srcstat = stats["sources"].setdefault(
                src, {"bytes": 0, "seconds": 0.0, "ranges": 0,
                      "route": "blob" if metas[src].get("blob_port") and HEAL_NATIVE
                      else "http"}
            )
            while True:
                with qlock:
                    if not queue:
                        return
                    off, length = queue.popleft()
                ts = time.perf_counter()
                try:
                    fetch_range(src, off, length)
                except Exception as e:  # noqa: BLE001 — re-stripe and retire
                    with qlock:
                        queue.append((off, length))
                        failures[src] = str(e)
                    logger.warning("heal source %s failed mid-stripe (%s); re-striping its "
                                   "ranges over the survivors", src, e)
                    return
                srcstat["bytes"] += length
                srcstat["seconds"] += time.perf_counter() - ts
                srcstat["ranges"] += 1
                with qlock:
                    done_bytes[0] += length

        # A worker that saw an empty queue exits, but a failing worker may
        # put its range back after that: relaunch workers for the surviving
        # sources until the queue drains or every source has failed (each
        # pass finishes the queue or retires a source).
        while queue and len(failures) < len(active):
            threads = [
                threading.Thread(target=worker, args=(s,), name=f"tft_heal_stripe{i}")
                for i, s in enumerate(s for s in active if s not in failures)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        if done_bytes[0] != total:
            raise ConnectionError(
                f"striped heal incomplete: {done_bytes[0]}/{total} bytes "
                f"(source failures: {failures or meta_errors})"
            )
        recv_s = time.perf_counter() - t0
        telemetry.LEDGER.record_heal_stage("recv", recv_s)
        for st in stats["sources"].values():
            st["gb_per_sec"] = (
                round(st["bytes"] / st["seconds"] / 1e9, 3) if st["seconds"] > 0 else 0.0
            )
        stats["stages"]["recv_s"] = round(recv_s, 4)
        stats["nsources"] = len(active) - len(failures)
        stats["failures"] = failures

        # ---- decode: views into the one receive buffer ----
        t0 = time.perf_counter()
        buffers: List[np.ndarray] = []
        off = 0
        for s in sizes:
            buffers.append(np.frombuffer(dest, dtype=np.uint8, count=s, offset=off))
            off += s
        state = unflatten_state(header, buffers)
        decode_s = time.perf_counter() - t0
        telemetry.LEDGER.record_heal_stage("decode", decode_s)
        stats["stages"]["decode_s"] = round(decode_s, 4)
        stats["bytes"] = len(header) + total
        self._record_recv(len(header) + total, time.perf_counter() - t_start, step)
        return state

    def _try_delta(
        self,
        primary: str,
        step: int,
        since_step: int,
        own: Tuple[List[np.ndarray], str],
        secs: float,
        stats: Dict[str, Any],
        header_cb: Optional[Callable[[bytes], None]] = None,
    ) -> Optional[T]:
        """The differential attempt against the primary; None on any
        refusal or failure (the caller then takes the striped full path)."""
        own_buffers, own_digest = own
        t0 = time.perf_counter()
        try:
            url = f"{primary}/checkpoint/{step}/delta_{since_step}_{own_digest}"
            with _traced_urlopen(url, timeout=secs) as r:
                body = read_exact(r, int(r.headers["Content-Length"]))
            manifest, payload = delta_mod.unpack_delta(body)
            if manifest.get("mode") != "delta":
                return None
            _call_header_cb(header_cb, manifest["header"])
            header, buffers = delta_mod.apply_delta(manifest, payload, own_buffers)
            state = unflatten_state(header, buffers)
        except Exception as e:  # noqa: BLE001 — fall back to the full path
            logger.warning("differential heal unavailable (%s); falling back to full", e)
            return None
        dur = time.perf_counter() - t0
        telemetry.LEDGER.record_heal_stage("recv", dur)
        stats["mode"] = "delta"
        stats["bytes"] = len(body)
        stats["delta"] = {
            "since_step": since_step,
            "changed": len(manifest["changed"]),
            "leaves": len(own_buffers),
            "bytes": len(body),
            "seconds": round(dur, 4),
        }
        stats["sources"][primary] = {
            "bytes": len(body),
            "seconds": round(dur, 4),
            "ranges": 1,
            "route": "http",
            "gb_per_sec": round(len(body) / max(dur, 1e-9) / 1e9, 3),
        }
        stats["stages"]["recv_s"] = round(dur, 4)
        stats["nsources"] = 1
        stats["failures"] = {}
        return state

    def shutdown(self, wait: bool = True) -> None:
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._blob is not None:
            self._blob.close()
        if wait:
            self._thread.join(timeout=5)
