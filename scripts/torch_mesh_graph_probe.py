"""Card probe of the sharded train step on the one-rank mesh a replica group
on one card runs (``TrainStep(mesh=...)``, every placement ``Replicate()``).

1. Whether its forward and backward can be captured in a CUDA graph (the
   unsharded step replays from one, ``StepGraphs``): capture after a
   warm-up on a side stream, replay, and compare with the eager step
   bitwise; then the same for AdamW (capturable, foreach) over the
   DTensor params. Each outcome is printed, an exception by its type and
   message.
2. The step's time (forward, backward and AdamW; 1 warm-up and
   ``--steps`` timed, host clock ending in a device sync) under the mesh
   against the unsharded step of the same config and params, each eager
   and replayed from CUDA graphs (``TrainStep``'s default on the card): the
   cost of DTensor's dispatch where nothing is sharded, and what the
   graphs take off it.

Usage (the card; no JAX): ``python3 scripts/torch_mesh_graph_probe.py
[--config tiny|llama] [--steps N]``; ``llama`` is phase 9's and phase 21
(b)'s Llama-2-7B width at 4 layers, B2 S4096. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from torchft_tpu_torch.examples.train_hsdp import preset_config  # noqa: E402
from torchft_tpu_torch.models.transformer import loss_fn  # noqa: E402
from torchft_tpu_torch.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from torchft_tpu_torch.parallel.train_step import TrainStep  # noqa: E402
from torchft_tpu_torch.utils.tree import tree_leaves  # noqa: E402

SHAPES = {"tiny": dict(batch=8, seq=16, overrides={}),
          "llama": dict(batch=2, seq=4096, overrides={"n_layers": 4})}


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:400]


def _capture(fn):
    """``fn()`` warmed up on a side stream, then captured; returns (the
    graph's outputs after one replay, None) or (None, the error)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        return out, None
    except Exception as e:  # noqa: BLE001 — the outcome is what is reported
        return None, _error(e)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def probe_capture(name: str) -> dict:
    shape = SHAPES[name]
    cfg = preset_config("tiny" if name == "tiny" else "llama2-7b", **shape["overrides"])
    mesh = make_mesh(MeshConfig(), "cuda")
    ts = TrainStep(cfg, mesh=mesh)
    params = ts.init_params(0)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    tokens = ts.shard_batch(torch.randint(0, cfg.vocab_size, (shape["batch"], shape["seq"]),
                                          generator=g, dtype=torch.int32))

    def fwd_bwd():
        loss = loss_fn(params, tokens, cfg, mesh)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_e, grads_e = fwd_bwd()
    out = {"config": name}
    got, err = _capture(fwd_bwd)
    out["grads_capture"] = err or "ok"
    if got is not None:
        out["grads_bitwise_equal_eager"] = bool(torch.equal(got[0], loss_e) and all(
            torch.equal(_local(a), _local(b)) for a, b in zip(got[1], grads_e)))
    for p, gr in zip(leaves, grads_e):
        p.grad = gr
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=1e-4, capturable=True, foreach=True)
    try:
        opt.step()  # creates the state outside the capture
        _, err = _capture(opt.step)
        out["adamw_capture"] = err or "ok"
    except Exception as e:  # noqa: BLE001
        out["adamw_capture"] = "eager step failed: " + _error(e)
    del opt, grads_e, got, params, leaves
    torch.cuda.empty_cache()
    return out


def time_steps(name: str, steps: int) -> dict:
    """ms a step of the unsharded step and of the one-rank mesh step, eager
    and graphed, from the same seeded params and tokens."""
    shape = SHAPES[name]
    cfg = preset_config("tiny" if name == "tiny" else "llama2-7b", **shape["overrides"])
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (shape["batch"], shape["seq"]), generator=g,
                           dtype=torch.int32)
    out = {}
    mesh1 = make_mesh(MeshConfig(), "cuda")
    for arm, mesh, graph in (("plain", None, False), ("mesh", mesh1, False),
                             ("plain_graphed", None, True), ("mesh_graphed", mesh1, True)):
        ts = TrainStep(cfg, graph=graph, mesh=mesh)
        params = ts.init_params(0)
        opt = ts.init_opt(params)
        losses = []
        for i in range(steps + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            loss, params, opt = ts.step(params, opt, tokens)
            losses.append(float(loss))
        torch.cuda.synchronize()
        out[arm] = {"ms_per_step": (time.perf_counter() - t0) / steps * 1e3, "losses": losses,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del ts, params, opt
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(SHAPES), default="tiny")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = probe_capture(args.config)
    res["steps"] = time_steps(args.config, args.steps)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
