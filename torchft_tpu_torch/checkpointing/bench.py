"""Checkpoint-transfer benchmark tool — the port's copy of
``torchft_tpu/checkpointing/bench.py``: one state of ``--total-gb`` in
float32 tensors of ``--tensor-mb`` each, staged by one transport and
received by another in the same process. The tensors live on the card
unless ``DEVICE=cpu``; the staging copies them to the host, and the
receiver's tree lies on the host (a Manager's ``load_state_dict`` puts it
on the device).

``--transport http`` moves the state over ``HTTPTransport``: the single
``/full`` stream, or ``--num-chunks`` chunks fetched in parallel;
``--transport collectives`` over ``CollectivesTransport`` between two
``CollectivesTcp`` ranks (``--window`` overrides its in-flight window; 1
is the serial send/wait schedule). The striped receive has its rows in
``benchmarks/crossgroup.py`` (``measure_striped_heal``).

Usage::

    python -m torchft_tpu_torch.checkpointing.bench --total-gb 12 --num-chunks 8

prints one line: the transport, the bytes, the staging and transfer
seconds, GB/s, and a sha256 of the sent and of the received tensors
(which must be equal; the run exits 1 when they differ).
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Dict

import torch


def _sha256(state: Dict[str, Any]) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(state[k].detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def main(argv=None) -> int:
    from torchft_tpu_torch.utils.platform import resolve_device

    parser = argparse.ArgumentParser(description="checkpoint transfer bench")
    parser.add_argument("--total-gb", type=float, default=12.0)
    parser.add_argument("--tensor-mb", type=float, default=64.0)
    parser.add_argument("--num-chunks", type=int, default=0,
                        help="HTTP: 0 streams /full, N > 0 fetches N chunks in parallel")
    parser.add_argument("--transport", choices=["http", "collectives"], default="http")
    parser.add_argument("--window", type=int, default=0,
                        help="collectives transport in-flight window (0 = its default; 1 is "
                        "the serial send/wait schedule)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(os.environ.get("DEVICE", "cuda"))

    n_tensors = max(1, int(args.total_gb * 1024 / args.tensor_mb))
    elems = int(args.tensor_mb * 1024 * 1024 / 4)
    state = {}
    for i in range(n_tensors):
        g = torch.Generator(device=device).manual_seed(i)
        state[f"t{i}"] = torch.randn(elems, generator=g, device=device)
    total_bytes = n_tensors * elems * 4
    timeout = timedelta(seconds=600)

    if args.transport == "http":
        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

        send = HTTPTransport(timeout=timeout, num_chunks=args.num_chunks, hostname="localhost")
        recv = HTTPTransport(timeout=timeout, num_chunks=args.num_chunks, hostname="localhost")
        try:
            t0 = time.perf_counter()
            send.send_checkpoint([1], step=1, state_dict=state, timeout=timeout)
            staged = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = recv.recv_checkpoint(src_rank=0, metadata=send.metadata(), step=1,
                                       timeout=timeout)
            took = time.perf_counter() - t0
        finally:
            send.shutdown()
            recv.shutdown()
    else:
        from torchft_tpu_torch.checkpointing.collectives_transport import (
            _WINDOW,
            CollectivesTransport,
        )
        from torchft_tpu_torch.collectives import CollectivesTcp
        from torchft_tpu_torch.store import StoreServer

        window = args.window if args.window > 0 else _WINDOW
        store = StoreServer()
        colls = [CollectivesTcp(timeout=timeout, hostname="localhost") for _ in range(2)]
        try:
            with ThreadPoolExecutor(max_workers=2) as pool:
                list(pool.map(lambda i: colls[i].configure(store.address(), i, 2), range(2)))
            transports = [CollectivesTransport(c, timeout=timeout, window=window) for c in colls]
            staged = 0.0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=2) as pool:
                fs = pool.submit(transports[0].send_checkpoint, [1], 1, state, timeout)
                fr = pool.submit(transports[1].recv_checkpoint, 0, "<collectives>", 1, timeout)
                fs.result()
                out = fr.result()
            took = time.perf_counter() - t0
        finally:
            for c in colls:
                c.shutdown()
            store.shutdown()

    sent, got = _sha256(state), _sha256(out)
    print(
        f"transport={args.transport} device={device.type} total={total_bytes / 1e9:.4f}GB "
        f"chunks={args.num_chunks} window={args.window} stage={staged:.4f}s "
        f"transfer={took:.4f}s ({total_bytes / took / 1e9:.4f} GB/s) "
        f"sha256 sent {sent} received {got}",
        flush=True,
    )
    return 0 if sent == got and len(out) == n_tensors else 1


if __name__ == "__main__":
    sys.exit(main())
