"""Run the port's ``train_bytes`` worker to its exit many times and report
each worker's exit code and the threads it leaves.

Usage (repo root; on the card by default, ``DEVICE=cpu`` for the CPU):
``python3 scripts/torch_exit_probe.py [--rounds 6] [--parallel 4] [--no-ckpt]``

Each round starts ``--parallel`` launchers at once (``python -m
torchft_tpu_torch.launcher --groups 1 --max-restarts 0``, as ``chip_smoke.py``
phase 20 (b) does), each running one group of 3 steps with a disk
checkpoint every step (``--no-ckpt``: none). The worker is this script with
``--worker``: ``train_bytes.main`` with ``faulthandler`` armed (a SIGABRT
prints every Python thread's stack) and, before the Manager is made,
before and after ``Manager.shutdown`` and at interpreter exit, one
``PROBE <when>`` line naming the tasks it has added since the Manager was
made that are no Python thread (``/proc/self/task`` less every Python
thread's ``native_id``), by tid, ``comm`` and state, and the Python threads.
A worker fails when its launcher exits non-zero or its log holds
``terminate called``; the last line counts the failures.
"""

from __future__ import annotations

import argparse
import atexit
import faulthandler
import glob
import os
import runpy
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tasks(tids):
    out = []
    for t in tids:
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                comm = f.read().strip()
            with open(f"/proc/self/task/{t}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            comm = state = "gone"
        out.append((t, comm, state))
    return out


def worker() -> None:
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, REPO)
    import torchft_tpu_torch.manager as M

    base = set()

    def native():
        py = {t.native_id for t in threading.enumerate()}
        return sorted(int(t) for t in os.listdir("/proc/self/task") if int(t) not in py)

    def probe(when):
        print(f"PROBE {when} native {_tasks(t for t in native() if t not in base)} python "
              f"{[(t.name, t.daemon) for t in threading.enumerate()]}", flush=True)

    init, shutdown = M.Manager.__init__, M.Manager.shutdown

    def probed_init(self, *a, **k):
        base.update(native())
        probe("before-manager")
        init(self, *a, **k)

    def probed_shutdown(self, wait=True):
        probe("before-shutdown")
        shutdown(self, wait)
        probe("after-shutdown")

    M.Manager.__init__, M.Manager.shutdown = probed_init, probed_shutdown
    atexit.register(probe, "atexit")
    runpy.run_module("torchft_tpu_torch.examples.train_bytes", run_name="__main__")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--no-ckpt", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return
    sys.path.insert(0, REPO)
    from torchft_tpu_torch.examples.train_bytes import ensure_corpus

    out = tempfile.mkdtemp(prefix="exit_probe_")
    corpus = os.path.join(out, "corpus.bin")
    ensure_corpus(corpus)
    bad, t0 = 0, time.time()
    for r in range(args.rounds):
        runs = []
        for j in range(args.parallel):
            d = os.path.join(out, f"r{r}_{j}")
            env = dict(os.environ, PYTHONPATH=REPO, DATA_PATH=corpus, STEPS="3")
            if not args.no_ckpt:
                env.update(CKPT_DIR=os.path.join(d, "ckpt"), CKPT_EVERY="1")
            runs.append((d, subprocess.Popen(
                [sys.executable, "-m", "torchft_tpu_torch.launcher", "--log-dir", d,
                 "--groups", "1", "--max-restarts", "0", "--", sys.executable,
                 os.path.abspath(__file__), "--worker"],
                env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for d, p in runs:
            launcher = p.communicate()[0].decode(errors="replace")
            text = "".join(open(f, errors="replace").read()
                           for f in sorted(glob.glob(os.path.join(d, "*.log"))))
            fail = p.returncode != 0 or "terminate called" in text
            bad += fail
            print(f"== {os.path.basename(d)} launcher exit {p.returncode} failed {fail}",
                  flush=True)
            for line in text.splitlines():
                if "PROBE" in line or "terminate" in line or "done:" in line:
                    print("  ", line[:2000])
            if fail:
                print(text[-6000:])
                print(launcher[-2000:])
    print(f"failed {bad} of {args.rounds * args.parallel} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
