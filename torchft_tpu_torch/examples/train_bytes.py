"""Fault-tolerant byte-level LM on a real on-disk corpus — the port of
``examples/train_bytes.py``, and the worker the fault-injection runner
(``torchft_tpu_torch.faultinject.runner``) spawns.

A byte-level transformer LM (d128 L2 h4 head dim 32 ff352, vocab 256,
sequences of ``SEQ`` bytes, ``"auto"`` attention: the flash kernels at head
dim 32 on the card) trains over a corpus file with Adam(1e-3) through
:class:`~torchft_tpu_torch.optim.ManagedOptimizer`. A batch's indices derive
from the committed step count (``data.step_indices``), the one clock every
replica group agrees on, so

* a killed and restarted group resumes where its last committed step left
  off (no sample trained twice, none skipped),
* the groups' round-robin partitions stay disjoint through kill, heal and
  resume,
* a failed commit retries the same batch (the step did not advance).

Each group appends one JSONL line per committed step to TRACE_PATH with the
sample indices it trained on, and ends with ``done: step=N
param_checksum=X`` (the runner's cross-group check reads it). On the card
it runs in bf16 with the gradients graphed (``TrainStep``) and prints the
flash kernels' launches on the line before; on the CPU in float32, eagerly,
on one intra-op thread (the groups share the host's cores).

Env: TORCHFT_LIGHTHOUSE, REPLICA_GROUP_ID, NUM_REPLICA_GROUPS, STEPS, BATCH,
DATA_PATH (built from this package's own sources when absent), TRACE_PATH
(``{group}`` in it is replaced by the group's id, so groups under one
launcher keep their own traces), TORCHFT_STORE_ADDR, DEVICE (``cuda``, the
default, or ``cpu``), TORCHFT_WIRE_CODEC (the data plane's wire codec;
exact float32 when unset), CKPT_DIR / CKPT_EVERY (periodic disk
checkpoints of the manager, params, Adam state and sampler, one writer per
group, restored before the first quorum: a group that lost every process
resumes from its newest checkpoint and heals forward from there).

Run two groups under the launcher::

    python -m torchft_tpu_torch.launcher --groups 2 -- \\
        python -m torchft_tpu_torch.examples.train_bytes
"""

from __future__ import annotations

import glob
import json
import logging
import os
import tempfile
import time
from datetime import timedelta
from typing import Any, Dict, Union

import numpy as np
import torch

from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.data import DistributedSampler, step_indices
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import TransformerConfig
from torchft_tpu_torch.optim import ManagedOptimizer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger("train_bytes")

SEQ = 128
# the wire codec of the float32 allreduces (``f32``, ``bfloat16``, ``int8``), as
# the JAX package's CollectivesTcp reads it; the fault matrix's int8
# scenarios set it
WIRE_CODEC_ENV = "TORCHFT_WIRE_CODEC"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ensure_corpus(path: str) -> bytes:
    """Real bytes from disk: this package's own sources, the same for every
    group of one checkout. Written atomically, so groups may race."""
    if not os.path.exists(path):
        files = sorted(glob.glob(os.path.join(_PACKAGE, "**", "*.py"), recursive=True))
        blob = b"".join(open(f, "rb").read() for f in files)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    with open(path, "rb") as f:
        return f.read()


def windows_of(corpus: bytes) -> np.ndarray:
    """The corpus as ``[n, SEQ]`` byte windows (the tail that fills no
    window is dropped)."""
    data = np.frombuffer(corpus, dtype=np.uint8)
    n = (len(data) - 1) // SEQ
    return data[: n * SEQ].reshape(n, SEQ)


def bytes_config(device: Union[str, torch.device]) -> TransformerConfig:
    """The JAX example's model: bf16 on the card, float32 on the CPU."""
    on_card = torch.device(device).type == "cuda"
    return TransformerConfig(
        vocab_size=256, d_model=128, n_layers=2, n_heads=4, head_dim=32, d_ff=352,
        dtype=torch.bfloat16 if on_card else torch.float32, attention_impl="auto",
    )


def make_optimizer(params: Dict[str, Any]) -> torch.optim.Adam:
    """``optax.adam(1e-3)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, no weight decay."""
    leaves = tree_leaves(params)
    on_card = bool(leaves) and leaves[0].device.type == "cuda"
    return torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            foreach=True if on_card else None)


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 2))
    steps = int(os.environ.get("STEPS", 20))
    batch = int(os.environ.get("BATCH", 8))
    data_path = os.environ.get(
        "DATA_PATH", os.path.join(tempfile.gettempdir(), "torchft_tpu_torch_corpus.bin"))
    trace_path = os.environ.get("TRACE_PATH")
    if trace_path:
        trace_path = trace_path.replace("{group}", str(replica_group))
    ckpt_dir = os.environ.get("CKPT_DIR")
    ckpt_every = int(os.environ.get("CKPT_EVERY", 5))
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    on_card = device.type == "cuda"
    if not on_card:
        torch.set_num_threads(1)

    store_addr = os.environ.get("TORCHFT_STORE_ADDR")
    store = None
    if store_addr is None:
        store = StoreServer()
        store_addr = store.address()

    windows = windows_of(ensure_corpus(data_path))
    logger.info("corpus: %d windows of %d bytes", len(windows), SEQ)

    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30),
                                   wire_dtype=os.environ.get(WIRE_CODEC_ENV) or None),
        load_state_dict=None,  # wired by ManagedOptimizer.init
        state_dict=None,
        min_replica_size=min(2, num_groups),
        replica_id=f"train_bytes_{replica_group}",
        store_addr=store_addr,
        rank=0,
        world_size=1,
        timeout=timedelta(seconds=30),
    )
    trace = open(trace_path, "a", buffering=1) if trace_path else None
    try:
        train_step = TrainStep(bytes_config(device), device)
        opt = ManagedOptimizer(manager, make_optimizer)
        opt.init(train_step.init_params(0))
        sampler = DistributedSampler(len(windows), replica_group=replica_group,
                                     num_replica_groups=num_groups, shuffle=True, seed=0)
        ckpt = None
        if ckpt_dir:
            from torchft_tpu_torch.checkpointing.disk import DiskCheckpointer

            # restored before the first quorum: the group reports its true
            # step and heals forward, never backward
            ckpt = DiskCheckpointer(
                ckpt_dir,
                manager,
                state_dict=lambda: {"opt": opt.state_dict(), "sampler": sampler.state_dict()},
                load_state_dict=lambda s: (opt.load_state_dict(s["opt"]),
                                           sampler.load_state_dict(s["sampler"])),
                every=ckpt_every,
                tag=f"group{replica_group}",
            )
            ckpt.restore()
        if on_card:
            from torchft_tpu_torch.ops import flash_attention as fa

            fa.reset_launches()
        prev_step = manager.current_step()
        while manager.current_step() < steps:
            step = manager.current_step()
            ids = step_indices(sampler, step, batch)
            tokens = torch.from_numpy(windows[ids].astype(np.int64)).to(device)

            opt.begin_step()
            loss, grads = train_step.grads(opt.params, tokens)
            opt.step(grads)

            committed = manager.current_step() > prev_step
            if committed and manager.is_participating() and trace is not None:
                trace.write(json.dumps({"step": step, "ids": ids.tolist()}) + "\n")
            if not committed:
                time.sleep(0.2)  # same batch retries: the step did not advance
            prev_step = manager.current_step()
            logger.info("step=%d participants=%d loss=%.4f", manager.current_step(),
                        manager.num_participants(), float(loss))
            if ckpt is not None:
                ckpt.maybe_save()
        if ckpt is not None:
            ckpt.close()
        checksum = sum(float(p.detach().double().sum()) for p in tree_leaves(opt.params))
        if on_card:
            logger.info("flash launches (head dim 32): %s", json.dumps(dict(fa.LAUNCHES)))
        logger.info("done: step=%d param_checksum=%.6f", manager.current_step(), checksum)
    finally:
        if trace is not None:
            trace.close()
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()


if __name__ == "__main__":
    main()
