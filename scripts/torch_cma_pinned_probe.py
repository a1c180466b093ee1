"""Can one process pull another's page-locked staging buffer with
process_vm_readv (CMA)?

The host data plane stages gradient buckets in page-locked host memory so
the device-to-host copies run asynchronously; on the CMA plane the C++
ring of the neighbouring worker process then reads those buckets with
``process_vm_readv``. This script asks the kernel directly, between two
sibling processes (as the workers are: neither is the other's ancestor),
for each way of allocating the buffer:

* ``pageable``: ``torch.empty`` (ordinary process memory);
* ``pinned``: ``torch.empty(..., pin_memory=True)`` (``cudaHostAlloc``);
* ``registered``: ``torch.empty`` page-locked afterwards with
  ``cudaHostRegister``;
* ``pinned_host_register``: ``pin_memory=True`` in a process started with
  ``PYTORCH_CUDA_ALLOC_CONF=pinned_use_cuda_host_register:True``.

For each it prints one JSON line: whether the pull worked (or its errno),
whether the bytes match, the pull's rate, and the rate of a device-to-host
copy into that buffer (CUDA events, median of 5). Needs a CUDA card::

    python3 scripts/torch_cma_pinned_probe.py [--mb 234]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _holder(mb: int, host_register_conf: bool) -> None:
    import torch

    n = mb * (1 << 20) // 4
    dev = torch.arange(n, dtype=torch.float32, device="cuda") * 0.5
    bufs = {}
    if host_register_conf:
        bufs["pinned_host_register"] = torch.empty(n, pin_memory=True)
    else:
        bufs["pageable"] = torch.empty(n)
        bufs["pinned"] = torch.empty(n, pin_memory=True)
        reg = torch.empty(n)
        rc = torch.cuda.cudart().cudaHostRegister(reg.data_ptr(), reg.numel() * 4, 0)
        if int(rc) != 0:
            raise RuntimeError(f"cudaHostRegister returned {rc}")
        bufs["registered"] = reg
    d2h = {}
    for name, buf in bufs.items():
        times = []
        for _ in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            buf.copy_(dev, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        d2h[name] = sorted(times[1:])[2]
    torch.cuda.synchronize()
    print(json.dumps({
        "pid": os.getpid(), "nbytes": n * 4,
        "bufs": {k: v.data_ptr() for k, v in bufs.items()}, "d2h_ms": d2h,
    }), flush=True)
    sys.stdin.read()  # hold the buffers until the parent closes our stdin


def _reader(pid: int, addr: int, nbytes: int) -> None:
    import numpy as np

    sys.path.insert(0, _ROOT)
    from torchft_tpu_torch._native import cma_read_into

    out = np.empty(nbytes // 4, dtype=np.float32)
    t0 = time.perf_counter()
    try:
        cma_read_into(pid, addr, memoryview(out).cast("B"))
    except OSError as e:
        print(json.dumps({"ok": False, "errno": e.errno,
                          "error": os.strerror(e.errno or 0)}), flush=True)
        return
    dt = time.perf_counter() - t0
    want = np.arange(out.size, dtype=np.float32) * np.float32(0.5)
    print(json.dumps({"ok": True, "bytes_equal": bool(np.array_equal(out, want)),
                      "pull_s": dt, "pull_gb_s": nbytes / dt / 1e9}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=234)
    ap.add_argument("--role", choices=["holder", "reader"])
    ap.add_argument("--host-register-conf", action="store_true")
    ap.add_argument("--pid", type=int)
    ap.add_argument("--addr", type=int)
    ap.add_argument("--nbytes", type=int)
    args = ap.parse_args()
    if args.role == "holder":
        _holder(args.mb, args.host_register_conf)
        return 0
    if args.role == "reader":
        _reader(args.pid, args.addr, args.nbytes)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    try:
        with open("/proc/sys/kernel/yama/ptrace_scope") as f:
            scope = f.read().strip()
    except OSError:
        scope = "absent"
    print(json.dumps({"yama_ptrace_scope": scope}))
    failed = False
    for conf in (False, True):
        env = dict(os.environ)
        if conf:
            env["PYTORCH_CUDA_ALLOC_CONF"] = "pinned_use_cuda_host_register:True"
        cmd = [sys.executable, __file__, "--role", "holder", "--mb", str(args.mb)]
        if conf:
            cmd.append("--host-register-conf")
        holder = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  env=env, text=True)
        try:
            info = json.loads(holder.stdout.readline())
            for name, addr in info["bufs"].items():
                rd = subprocess.run(
                    [sys.executable, __file__, "--role", "reader", "--pid", str(info["pid"]),
                     "--addr", str(addr), "--nbytes", str(info["nbytes"])],
                    capture_output=True, text=True, timeout=120,
                )
                if rd.returncode != 0:
                    failed = True
                    print(rd.stderr, file=sys.stderr)
                    continue
                res = json.loads(rd.stdout.strip().splitlines()[-1])
                res.update(kind=name, mb=info["nbytes"] / 1e6, d2h_ms=info["d2h_ms"][name],
                           d2h_gb_s=info["nbytes"] / info["d2h_ms"][name] / 1e6)
                print(json.dumps(res), flush=True)
        finally:
            holder.stdin.close()
            holder.wait(timeout=60)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
