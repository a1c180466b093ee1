"""Kill and rejoin in two checkouts of the port, alternated: the survivors'
blackout and steps and the rejoiner's heal, before and after a change to
the heal path.

Usage (one NVIDIA GPU): ``python3 scripts/torch_heal_ab.py DIR_A DIR_B
[--groups 2 4] [--pairs 1]``

Each DIR is the root of a checkout with
``torchft_tpu_torch/benchmarks/recovery.py``. Both are built first, in
parallel. Then each of ``--pairs`` rounds runs, for each group count, the
checkout's ``measure_recovery`` (the headline in worker processes on the
card, the last group SIGKILLed at step 8 and respawned; a 1 s join
timeout with three groups or more, the bench's) in a process of its own,
A then B in even rounds and B then A in odd ones. Prints one JSON line a
run: the blackout, its steps and the steps lost, the steady step, the
rejoin and its parts (the heal among them), the rejoiner's heal as the
transport saw it (where the checkout reports it), each survivor's longest
step while the rejoiner heals (``survivor_step_at_rejoin_s``: from the
respawn to a second past the rejoiner's first commit) and the deadlines
hit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BUILD = ("from torchft_tpu_torch import _native; "
         "from torchft_tpu_torch.ops import flash_attention as fa; "
         "_native.build(); fa.build()")
RUN = """
import inspect, json, os
os.environ["DEVICE"] = "{device}"
from torchft_tpu_torch.benchmarks.recovery import measure_recovery
n = {groups}
# an older checkout takes the join timeout as an argument (100 ms by default)
kw = ({{"join_timeout_ms": 1000}} if n >= 3 and "join_timeout_ms"
      in inspect.signature(measure_recovery).parameters else {{}})
r = measure_recovery(total_steps=20, kill_at_step=8, op_timeout=30.0, heartbeat_timeout_ms=5000,
                     timeout_s=600.0, num_groups=n, **kw)
out = r.as_dict()
# the survivors' longest step while the rejoiner heals: from the respawn to
# the rejoiner's first commit (every survivor stages its state then)
from torchft_tpu_torch.benchmarks.recovery import _read_events
victim = [e for e in _read_events(r.log_paths[-1])]
t0 = [e["t"] for e in victim if e["event"] == "start"][-1]
t1 = min(e["t"] for e in victim if e["event"] == "commit" and e["t"] > t0)
stalls = []
for path in r.log_paths[:-1]:
    ts = [e["t"] for e in _read_events(path) if e["event"] == "commit"]
    gaps = [b - a for a, b in zip(ts, ts[1:]) if b > t0 and a < t1 + 1.0]
    stalls.append(round(max(gaps), 4) if gaps else None)
out["survivor_step_at_rejoin_s"] = stalls
out["digests"] = len({{f["digest"] for f in r.finals.values()}})
out["launches_per_step"] = [f["launches_per_step"] for f in r.finals.values()]
print("ROW " + json.dumps(out))
"""


def _run(tree: str, groups: int, device: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN.format(groups=groups, device=device)],
                          cwd=tree,
                          capture_output=True, text=True, timeout=900)
    rows = [line[4:] for line in proc.stdout.splitlines() if line.startswith("ROW ")]
    if proc.returncode != 0 or not rows:
        sys.exit(f"{tree}: rc={proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(rows[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--groups", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cpu rehearses the script (a tiny model)")
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    for side, tree in trees.items():
        print(f"{side}: {tree}", flush=True)
    if args.device == "cuda":
        builds = {side: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
                  for side, tree in trees.items()}
        for side, proc in builds.items():
            if proc.wait(timeout=900) != 0:
                sys.exit(f"{side}: build failed (rc={proc.returncode})")
    for i in range(args.pairs):
        for groups in args.groups:
            for side in ("AB" if i % 2 == 0 else "BA"):
                row = _run(trees[side], groups, args.device)
                print(json.dumps({"round": i, "side": side, "groups": groups, **row}),
                      flush=True)


if __name__ == "__main__":
    main()
