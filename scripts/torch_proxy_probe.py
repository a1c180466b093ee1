"""Where ``CollectivesProxy``'s time goes on a host: the headline's gradient
bytes (234 MB float32 by default, in 25 MB buckets, as ``ddp`` stages them)
averaged between two ranks

* ``ring``: two ``CollectivesTcp`` Python rings in threads of this process
  (``chip_smoke.py`` phase 5's plane);
* ``proxy``: the same rings, each in a ``CollectivesProxy`` child (phase 20
  leg (c)'s plane: a fresh ``/dev/shm`` segment per bucket, copied in and
  out);
* ``shm_fresh`` / ``shm_reused``: the proxy's staging alone, one rank's
  buckets copied into a fresh segment each (created, filled, closed and
  unlinked) or into one segment kept across buckets.

Prints one JSON line: seconds per round (every bucket once) for each leg,
the medians, the host, and the card's name and power limit where
``nvidia-smi`` answers. No GPU work: it times the host the card sits in.

Usage: ``python3 scripts/torch_proxy_probe.py [--mb 234] [--reps 3]``
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from datetime import timedelta
from multiprocessing import shared_memory

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUCKET_BYTES = 25 * 1024 * 1024  # ddp's default bucket


def _pair(kind: str, store_addr: str):
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.proxy import CollectivesProxy

    timeout = timedelta(seconds=120)
    if kind == "ring":
        ranks = [CollectivesTcp(timeout=timeout, native_plane=False) for _ in range(2)]
    else:
        factory = functools.partial(CollectivesTcp, timeout=timeout, native_plane=False)
        ranks = [CollectivesProxy(factory, timeout=timeout) for _ in range(2)]
    threads = [threading.Thread(target=c.configure, args=(store_addr, i, 2))
               for i, c in enumerate(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ranks


def _round(ranks, bufs) -> float:
    from torchft_tpu_torch.collectives import ReduceOp

    def run(i):
        works = [ranks[i].allreduce([b], ReduceOp.SUM) for b in bufs[i]]
        for w in works:
            w.wait(timedelta(seconds=120))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0


def _staging(bufs, reused: bool) -> float:
    t0 = time.perf_counter()
    keep = shared_memory.SharedMemory(create=True, size=max(b.nbytes for b in bufs)) \
        if reused else None
    try:
        for b in bufs:
            shm = keep or shared_memory.SharedMemory(create=True, size=b.nbytes)
            np.frombuffer(shm.buf, np.uint8, count=b.nbytes)[:] = b.view(np.uint8)
            if not reused:
                shm.close()
                shm.unlink()
    finally:
        if keep is not None:
            keep.close()
            keep.unlink()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=234.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    from torchft_tpu_torch.store import StoreServer

    total = int(args.mb * 1e6) // 4 * 4
    sizes = [BUCKET_BYTES] * (total // BUCKET_BYTES) + ([total % BUCKET_BYTES]
                                                        if total % BUCKET_BYTES else [])
    rng = np.random.default_rng(0)
    bufs = [[rng.standard_normal(n // 4).astype(np.float32) for n in sizes] for _ in range(2)]
    out = {"bytes": total, "buckets": len(sizes)}
    for kind in ("ring", "proxy"):
        store = StoreServer()
        ranks = _pair(kind, store.address())
        try:
            out[kind] = [round(_round(ranks, bufs), 4) for _ in range(args.reps)]
        finally:
            for r in ranks:
                r.shutdown()
            store.shutdown()
    for name, reused in (("shm_fresh", False), ("shm_reused", True)):
        out[name] = [round(_staging(bufs[0], reused), 4) for _ in range(args.reps)]
    out["medians"] = {k: statistics.median(out[k])
                      for k in ("ring", "proxy", "shm_fresh", "shm_reused")}
    out["host"] = {"node": os.uname().nodename, "cpus": os.cpu_count()}
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        out["card"] = None
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
