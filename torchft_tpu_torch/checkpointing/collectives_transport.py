"""Checkpoint transport over the reconfigurable data plane — the port's
counterpart of ``torchft_tpu/checkpointing/collectives_transport.py``.

The PGTransport analogue: a length frame, a pickled header (treedef and
per-leaf dtype / shape / nbytes) and the raw buffers of a state tree, over
the send / recv pairs of the collectives the Manager configured for the
current quorum (``CollectivesTcp`` or ``CollectivesDevice``).

Transfers are pipelined: at most ``window`` buffer sends (or recvs) are in
flight per destination, and fan-out to several healing replicas runs
destinations in parallel. Each buffer has its own tag, so overlapped frames
may complete out of order. Tags are salted per transfer with a
sender-chosen nonce carried in the length frame: if a receive dies
mid-window, its abandoned recvs keep their old tags and can never claim a
frame of the retry.

The state tree is flattened by ``checkpointing/serialization.py`` (tensors
copied to the host), so a heal still crosses host memory, as the JAX
package's does. Stagings, sends and receives are counted
(``record_checkpoint``) and emitted to the trail (``checkpoint_send`` /
``checkpoint_recv``); ``last_recv_bytes`` holds the last receive's bytes.
"""

from __future__ import annotations

import itertools
import pickle
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Deque, Generic, List, TypeVar

import numpy as np

from torchft_tpu_torch import telemetry
from torchft_tpu_torch.checkpointing.serialization import (
    as_bytes,
    buffer_sizes,
    flatten_state,
    unflatten_state,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.collectives import Collectives

T = TypeVar("T")

__all__ = ["CollectivesTransport"]

# Only the length frame uses the fixed _META_TAG: the receiver cannot know
# the salt before reading it. Header and data tags carry the salt's low 4
# bits (16 salts cycle; a stale recv from 16 transfers ago is long dead, or
# its epoch was reconfigured, which fails it). Data tags cycle within 4096:
# in-flight reordering is bounded by the window, far below the cycle.
_META_TAG = 0x00CC01
_HDR_TAG0 = 0x00CD00
_DATA_TAG0 = 0x0D0000
_TAG_CYCLE = 4096
_WINDOW = 3
_MAX_DST_PARALLEL = 4

_TRANSFER_SALT = itertools.count(1)  # process-global: survives re-instantiation


def _hdr_tag(salt: int) -> int:
    return _HDR_TAG0 | (salt & 0xF)


def _data_tag(salt: int, i: int) -> int:
    return _DATA_TAG0 | ((salt & 0xF) << 12) | (i % _TAG_CYCLE)


class CollectivesTransport(CheckpointTransport[T], Generic[T]):
    def __init__(
        self,
        collectives: Collectives,
        timeout: timedelta,
        window: int = _WINDOW,
    ) -> None:
        self._collectives = collectives
        self._timeout = timeout
        # payload bytes of the last receive
        self.last_recv_bytes: int = 0
        self._window = max(1, window)

    def metadata(self) -> str:
        return "<collectives>"

    def _send_one(
        self,
        dst: int,
        len_arr: np.ndarray,
        hdr_arr: np.ndarray,
        buffers: List[np.ndarray],
        timeout: timedelta,
        salt: int,
    ) -> None:
        self._collectives.send(len_arr, dst, tag=_META_TAG).wait(timeout)
        self._collectives.send(hdr_arr, dst, tag=_hdr_tag(salt)).wait(timeout)
        window: Deque = deque()
        for i, buf in enumerate(buffers):
            while len(window) >= self._window:
                window.popleft().wait(timeout)
            window.append(
                self._collectives.send(
                    np.frombuffer(as_bytes(buf), dtype=np.uint8), dst,
                    tag=_data_tag(salt, i),
                )
            )
        while window:
            window.popleft().wait(timeout)

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: timedelta
    ) -> None:
        t0 = time.perf_counter()
        header, buffers = flatten_state(state_dict)
        nbytes = len(header) + sum(int(b.nbytes) for b in buffers)
        telemetry.record_checkpoint("stage", nbytes, time.perf_counter() - t0, "collectives")
        hdr_arr = np.frombuffer(header, dtype=np.uint8)
        salt = next(_TRANSFER_SALT)
        # the salt rides in the length frame, so the receiver tags its
        # windowed recvs alike without another round trip
        len_arr = np.array([len(header), salt], dtype=np.int64)
        t0 = time.perf_counter()
        if len(dst_ranks) == 1:
            self._send_one(dst_ranks[0], len_arr, hdr_arr, buffers, timeout, salt)
        else:
            with ThreadPoolExecutor(
                max_workers=min(_MAX_DST_PARALLEL, len(dst_ranks)),
                thread_name_prefix="tft_ckpt_send",
            ) as pool:
                futs = [
                    pool.submit(self._send_one, dst, len_arr, hdr_arr, buffers, timeout, salt)
                    for dst in dst_ranks
                ]
                for f in futs:
                    f.result()
        seconds = time.perf_counter() - t0
        telemetry.record_checkpoint("send", nbytes * len(dst_ranks), seconds, "collectives")
        telemetry.emit("checkpoint_send", transport="collectives", dst_ranks=list(dst_ranks),
                       step=step, bytes=nbytes, duration_s=round(seconds, 4))

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: timedelta
    ) -> T:
        t0 = time.perf_counter()
        len_arr = np.zeros(2, dtype=np.int64)
        self._collectives.recv(len_arr, src_rank, tag=_META_TAG).wait(timeout)
        salt = int(len_arr[1])
        hdr_arr = np.zeros(int(len_arr[0]), dtype=np.uint8)
        self._collectives.recv(hdr_arr, src_rank, tag=_hdr_tag(salt)).wait(timeout)
        header = hdr_arr.tobytes()
        _, infos = pickle.loads(header)
        buffers: List[np.ndarray] = []
        window: Deque = deque()
        for i, nbytes in enumerate(buffer_sizes(infos)):
            while len(window) >= self._window:
                window.popleft().wait(timeout)
            buf = np.zeros(nbytes, dtype=np.uint8)
            buffers.append(buf)
            window.append(self._collectives.recv(buf, src_rank, tag=_data_tag(salt, i)))
        while window:
            window.popleft().wait(timeout)
        seconds = time.perf_counter() - t0
        nbytes = len(header) + sum(int(b.nbytes) for b in buffers)
        self.last_recv_bytes = nbytes
        telemetry.record_checkpoint("recv", nbytes, seconds, "collectives")
        telemetry.emit("checkpoint_recv", transport="collectives", step=step, bytes=nbytes,
                       duration_s=round(seconds, 4))
        return unflatten_state(header, buffers)
