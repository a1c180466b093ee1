"""Where the time of the port's headline fault-tolerant step goes.

Usage (repo root, one NVIDIA GPU): ``python3 scripts/torch_step_profile.py``

Runs the single-group FT loop of ``chip_smoke.py``, with its headline
configuration and Manager wiring (d512 L8 h8 ff1408 vocab 32000 bf16,
batch 8 x seq 1024, flash attention), and reports:

* host-clock phases per step, with a device synchronise at each boundary:
  quorum start, forward+backward, gradient averaging (D2H, ring, H2D),
  commit vote, optimizer update;
* a ``torch.profiler`` trace of 3 unsynchronised steps: device time by
  kernel (top 15), the flash kernels' share and each flash kernel's
  device time per launch, the device's busy share of the wall clock, and
  the device time of each range named with ``record_function`` (AdamW's
  step; ``flash_attention.delta``, the plain ops that compute the
  backward's ``delta``). Those ranges also lie on the device's timeline,
  spanning their kernels, and are left out of the kernel sums.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HEADLINE, headline_config, make_manager, make_tokens  # noqa: E402
from torchft_tpu_torch.coordination import LighthouseServer  # noqa: E402
from torchft_tpu_torch.ddp import allreduce_gradients  # noqa: E402
from torchft_tpu_torch.parallel.ft import FTTrainer  # noqa: E402
from torchft_tpu_torch.parallel.train_step import TrainStep  # noqa: E402
from torchft_tpu_torch.store import StoreServer  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = headline_config()
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    manager = make_manager(lighthouse.address(), store, "profile")
    try:
        ts = TrainStep(cfg, device="cuda")
        trainer = FTTrainer(manager, ts)
        trainer.init(seed=0)
        tokens = make_tokens(cfg, 0, HEADLINE["batch"], HEADLINE["seq"])
        for _ in range(3):
            trainer.step(tokens)
        torch.cuda.synchronize()

        phases = {k: [] for k in ("quorum", "fwd_bwd", "average", "commit", "apply", "wall")}
        for _ in range(5):
            t0 = time.perf_counter()
            manager.start_quorum()
            t1 = time.perf_counter()
            loss, grads = ts.grads(trainer.params, tokens)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grads = allreduce_gradients(manager, grads)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            committed = manager.should_commit()
            t4 = time.perf_counter()
            if committed:
                ts.apply(trainer.params, trainer.opt, grads)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for k, a, b in (("quorum", t0, t1), ("fwd_bwd", t1, t2), ("average", t2, t3),
                            ("commit", t3, t4), ("apply", t4, t5), ("wall", t0, t5)):
                phases[k].append((b - a) * 1e3)
        print("host-clock phases, median of 5 synchronised steps (ms):")
        for k, v in phases.items():
            print(f"  {k:8s} {statistics.median(v):9.3f}")

        from torch.profiler import ProfilerActivity, profile

        steps = 3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(tokens)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        kernels = [e for e in events
                   if e.device_type.name == "CUDA" and not e.is_user_annotation]
        by_name, launches = {}, {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches[e.name] = launches.get(e.name, 0) + 1
        busy_us = 0.0
        intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        cur_s = cur_e = None
        for s, e in intervals:  # union of device intervals
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_us += cur_e - cur_s
        total = sum(by_name.values())
        print(f"profiled {steps} steps: wall {wall_us / steps / 1e3:.3f} ms/step, device "
              f"busy {busy_us / steps / 1e3:.3f} ms/step ({100 * busy_us / wall_us:.1f}% of "
              f"wall), device op time {total / steps / 1e3:.3f} ms/step")
        flash = sum(v for k, v in by_name.items() if "flash_" in k)
        print(f"flash kernels: {flash / steps / 1e3:.3f} ms/step "
              f"({100 * flash / total:.1f}% of device op time)")
        for name, us in sorted(by_name.items()):
            if "flash_" in name:
                short = name.replace("(anonymous namespace)::", "").replace("void ", "")
                short = short.split("(")[0]
                print(f"  {short}: {us / steps / 1e3:.3f} ms/step, {launches[name] // steps} "
                      f"launches/step, {us / launches[name] / 1e3:.4f} ms each")
        # named ranges (record_function: AdamW's step, the backward's
        # delta) lie on the device timeline too, spanning their kernels;
        # left out of the sums above, each is reported by the device time
        # of the kernels launched inside its host-side event
        names = {e.name for e in events if e.device_type.name == "CUDA" and e.is_user_annotation}
        for name in sorted(names):
            hosts = [e for e in events if e.name == name and e.device_type.name == "CPU"]
            us = sum(e.device_time_total for e in hosts)
            print(f"range {name}: {us / steps / 1e3:.3f} ms/step, {len(hosts) // steps} "
                  f"per step, {us / max(len(hosts), 1) / 1e3:.4f} ms each")
        print("top device ops (ms/step):")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {us / steps / 1e3:8.3f}  {name[:110]}")
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


if __name__ == "__main__":
    main()
