"""Does a device-wide sync in one thread break a CUDA-graph capture in
another? (card)

One thread captures a small transformer's train step again and again (new
params: the gradient graph; a new optimizer: the update's), while a second
thread synchronizes the device in a loop, either with
``torch.cuda.synchronize()`` (``raw``) or through
``torchft_tpu_torch.parallel.train_step.synchronize``, which waits for the
capture lock (``lock``). Prints the syncs, the captures and each thread's
error, and exits 1 if either thread raised.

    python3 scripts/torch_sync_capture_probe.py raw|lock
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchft_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from torchft_tpu_torch.parallel.train_step import TrainStep, synchronize  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["raw", "lock"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if args.mode == "raw" else synchronize
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, head_dim=64,
                            d_ff=256, dtype=torch.bfloat16, attention_impl="plain")
    ts = TrainStep(cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    done, errors, syncs = threading.Event(), [], [0]

    def syncer():
        try:
            while not done.is_set():
                sync()
                syncs[0] += 1
        except Exception as e:  # noqa: BLE001 — printed below
            errors.append(("syncer", repr(e)[:200]))

    th = threading.Thread(target=syncer)
    th.start()
    try:
        for seed in range(6):
            params = ts.init_params(seed)
            _, grads = ts.grads(params, tokens)
            for _ in range(3):
                ts.apply(params, ts.init_opt(params), grads)
        torch.cuda.current_stream().synchronize()
    except Exception as e:  # noqa: BLE001 — printed below
        errors.append(("capturer", repr(e)[:200]))
    finally:
        done.set()
        th.join()
    print(f"mode={args.mode} syncs={syncs[0]} captures={ts.graphs.captures} errors={errors}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
