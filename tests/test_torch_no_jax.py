"""The port stands alone: it imports neither JAX nor ``torchft_tpu``.

``tests/conftest.py`` imports jax for the whole session, so the runtime
check runs a one-group fault-tolerant step of the port and one DiLoCo
sync (``sync_every=1``) in a fresh subprocess and inspects its
``sys.modules``. A static check covers every module of the package and
``chip_smoke.py``.
"""

import ast
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "torchft_tpu")

_STEP = r"""
import json, sys
from datetime import timedelta
import numpy as np, torch
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import ManagedOptimizer
from torchft_tpu_torch.models.transformer import TransformerConfig
from torchft_tpu_torch.parallel.ft import FTTrainer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer

cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                        d_ff=64, dtype=torch.float32, attention_impl="flash")
lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
store = StoreServer()
manager = Manager(collectives=CollectivesTcp(timeout=timedelta(seconds=20)),
                  load_state_dict=None, state_dict=None, min_replica_size=1,
                  replica_id="solo", store_addr=store.address(), rank=0, world_size=1,
                  lighthouse_addr=lighthouse.address(), timeout=timedelta(seconds=20),
                  use_async_quorum=False)
ts = TrainStep(cfg, device="cpu")
trainer = FTTrainer(manager, ts)
trainer.init(seed=0)
tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 64)))
loss, committed = trainer.step(tokens)
diloco = DiLoCo(manager, lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True),
                sync_every=1)
diloco.save(trainer.params)
ts.step(trainer.params, trainer.opt, tokens)
synced = diloco.step(trainer.params)
assert ManagedOptimizer.__name__ == "ManagedOptimizer"
manager.shutdown(wait=False); store.shutdown(); lighthouse.shutdown()
print(json.dumps({"loss": loss, "committed": committed, "synced": synced,
                  "step": manager.current_step(), "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_ft_step_runs_without_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _STEP], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["committed"] and out["synced"] and out["step"] == 2
    assert math.isfinite(out["loss"]) and out["loss"] > 0
    leaked = [m for m in out["modules"] if _forbidden(m)]
    assert not leaked, f"the port pulled in {leaked}"
    assert "torchft_tpu_torch" in out["modules"]


def _port_sources():
    pkg = os.path.join(REPO, "torchft_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_forbidden_imports_in_sources():
    bad = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
