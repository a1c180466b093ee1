"""The port stands alone: it imports neither JAX nor ``torchft_tpu``.

``tests/conftest.py`` imports jax for the whole session, so the runtime
checks run in fresh subprocesses whose imports of jax, jaxlib, optax and
``torchft_tpu`` raise, and inspect their ``sys.modules``: a one-group
fault-tolerant step of the port and one DiLoCo sync (``sync_every=1``)
over CollectivesTcp, then a step of the CIFAR example's narrow ResNet and
the sampler, the imports of the recovery and crossgroup harnesses, the bench and its
other harnesses (the step's CollectivesTcp loads the wire codecs), and a striped
heal of the trainer's state from two HTTP transports over the blob plane; and two groups as threads over CollectivesDevice, the second
joining late and healing over CollectivesTransport. A static check covers
every module of the package (the examples, the lighthouse CLI, the bench
and its harnesses and the wire codecs included) and ``chip_smoke.py``;
neither may import the JAX package's root ``bench.py`` either. The
telemetry modules (``telemetry/`` and ``profiling.py``, the fleet plane's
among them: each quorum's report is built and delta-encoded), the
forensics (black box, samplers, diagnosis, postmortem), the fault plane
(``faultinject/``) and the samplers' overhead row are held to the same:
the Manager's step loads them, and the scan covers each. So are the fault
matrix's runner (its ``--list``), the sanitizer's numpy worker and the
``train_bytes`` example the runner spawns, imported in a blocked process.
"""

import ast
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ``bench`` is the JAX package's root bench.py: the port keeps its own
# copies of its numpy-only helpers
FORBIDDEN = ("jax", "jaxlib", "optax", "torchft_tpu", "bench")

# imports of the forbidden packages raise inside the subprocess
_BLOCK = r"""
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "torchft_tpu", "bench"):
            raise ImportError(f"{name} is blocked: the port must not import it")
        return None

sys.meta_path.insert(0, _Blocked())
"""

_STEP = _BLOCK + r"""
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
manager = Manager(collectives=CollectivesTcp(timeout=timedelta(seconds=20), native_plane=True),
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
from torchft_tpu_torch.data import DistributedSampler, step_indices
from torchft_tpu_torch.examples.train_cifar import CifarStep
from torchft_tpu_torch.models.resnet import ResNetConfig
import torchft_tpu_torch.lighthouse
import torchft_tpu_torch.benchmarks.recovery
import torchft_tpu_torch.benchmarks.crossgroup
import torchft_tpu_torch.bench
import torchft_tpu_torch.benchmarks.long_context
import torchft_tpu_torch.benchmarks.resnet_ft
import torchft_tpu_torch.benchmarks.quorum_overlap
import torchft_tpu_torch.benchmarks.commit_pipeline
import torchft_tpu_torch.benchmarks.diloco
import torchft_tpu_torch.checkpointing.bench
import torchft_tpu_torch.benchmarks.quorum_scale
import torchft_tpu_torch.benchmarks.telemetry_overhead
import torchft_tpu_torch.telemetry.critical_path
import torchft_tpu_torch.telemetry.regression
import torchft_tpu_torch.telemetry.postmortem
import torchft_tpu_torch.benchmarks.profiler_overhead
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
srcs = [HTTPTransport(timeout=timedelta(seconds=20), hostname="localhost") for _ in range(3)]
for t in srcs[:2]:
    t.send_checkpoint([1], 1, trainer.state_dict(), timedelta(seconds=20))
healed = srcs[2].recv_checkpoint_multi([t.metadata() for t in srcs[:2]], 1,
                                       timedelta(seconds=20))
from torchft_tpu_torch.utils.tree import tree_leaves
striped = (srcs[2].last_heal_stats["nsources"] == 2
           and all(torch.equal(a, b) for a, b in zip(tree_leaves(healed["params"]),
                                                     tree_leaves(trainer.params))))
for t in srcs:
    t.shutdown()
ids = step_indices(DistributedSampler(64, replica_group=0, num_replica_groups=2), 0, 4)
cifar = CifarStep(ResNetConfig(channels=(4, 8, 16, 32), dtype=torch.float32), device="cpu")
cparams, cstats = cifar.init(0)
closs, cgrads, _ = cifar.grads(cparams, cstats, torch.rand(4, 32, 32, 3),
                               torch.from_numpy(ids % 10))
cifar.apply(cparams, cifar.init_opt(cparams), cgrads)
manager.shutdown(wait=False); store.shutdown(); lighthouse.shutdown()
print(json.dumps({"loss": loss, "committed": committed, "synced": synced, "striped": striped,
                  "step": manager.current_step(), "cifar_loss": float(closs),
                  "modules": sorted(sys.modules)}))
"""


_DEVICE_HEAL = _BLOCK + r"""
import hashlib, json, sys, threading
from datetime import timedelta
import numpy as np, torch
from torchft_tpu_torch.checkpointing import CollectivesTransport
from torchft_tpu_torch.collectives_device import CollectivesDevice
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import TransformerConfig
from torchft_tpu_torch.parallel.ft import FTTrainer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves

cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                        d_ff=64, dtype=torch.float32, attention_impl="flash")
timeout = timedelta(seconds=20)
lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
first_commit, out = threading.Event(), {}
tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 64)))

def group(gid):
    if gid == 1:
        first_commit.wait(60)
    store = StoreServer()
    plane = CollectivesDevice(timeout=timeout, device="cpu")
    manager = Manager(collectives=plane, load_state_dict=None, state_dict=None,
                      min_replica_size=1, replica_id=f"g{gid}", store_addr=store.address(),
                      rank=0, world_size=1, lighthouse_addr=lighthouse.address(),
                      timeout=timeout, checkpoint_transport=CollectivesTransport(plane, timeout))
    try:
        trainer = FTTrainer(manager, TrainStep(cfg, device="cpu"))
        trainer.init(seed=gid)
        joint = 0
        while joint < 1:
            _, committed = trainer.step(tokens)
            first_commit.set()
            joint += committed and manager.num_participants() == 2
        h = hashlib.sha256()
        for leaf in tree_leaves(trainer.params):
            h.update(leaf.detach().numpy().tobytes())
        out[gid] = (manager.current_step(), h.hexdigest())
    finally:
        first_commit.set()
        manager.shutdown(wait=False)
        store.shutdown()

threads = [threading.Thread(target=group, args=(g,)) for g in (0, 1)]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
lighthouse.shutdown()
print(json.dumps({"groups": [out.get(0), out.get(1)], "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _run_blocked(script: str) -> dict:
    """Run ``script`` in a fresh interpreter; its last stdout line is JSON
    with the modules it loaded, none of which may be forbidden."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    leaked = [m for m in out["modules"] if _forbidden(m)]
    assert not leaked, f"the port pulled in {leaked}"
    assert "torchft_tpu_torch" in out["modules"]
    return out


def test_ft_step_runs_without_jax_or_reference_package():
    out = _run_blocked(_STEP)
    assert out["committed"] and out["synced"] and out["striped"] and out["step"] == 2
    assert math.isfinite(out["loss"]) and out["loss"] > 0
    assert math.isfinite(out["cifar_loss"]) and out["cifar_loss"] > 0
    for module in ("data", "models.resnet", "lighthouse", "examples.train_cifar",
                   "benchmarks.recovery", "benchmarks.crossgroup", "wire_codec", "bench",
                   "benchmarks.long_context", "benchmarks.resnet_ft",
                   "benchmarks.quorum_overlap", "benchmarks.commit_pipeline",
                   "benchmarks.diloco", "checkpointing.stripes", "checkpointing.delta",
                   "checkpointing.bench", "telemetry", "telemetry.registry", "telemetry.events",
                   "telemetry.tracing", "telemetry.anatomy", "telemetry.flight", "profiling",
                   "faultinject", "faultinject.core", "telemetry.blackbox",
                   "telemetry.profiler", "telemetry.diagnosis", "telemetry.postmortem",
                   "benchmarks.profiler_overhead"):
        assert f"torchft_tpu_torch.{module}" in out["modules"]


def test_device_plane_heal_runs_without_jax_or_reference_package():
    out = _run_blocked(_DEVICE_HEAL)
    g0, g1 = out["groups"]
    assert g0 is not None and g1 is not None, "a group did not finish"
    assert g0 == g1, "the late joiner did not end with the other group's params"
    assert "torchft_tpu_torch.collectives_device" in out["modules"]
    assert "torchft_tpu_torch.checkpointing.collectives_transport" in out["modules"]


_RUNNER = _BLOCK + r"""
import contextlib, io, json, sys
from torchft_tpu_torch.faultinject import _san_worker, runner
from torchft_tpu_torch.examples import train_bytes
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = runner.main(["--list"])
names = [line.split()[0] for line in buf.getvalue().splitlines() if line.strip()]
print(json.dumps({"rc": rc, "names": names, "san_worker": callable(_san_worker.main),
                  "example": callable(train_bytes.main), "modules": sorted(sys.modules)}))
"""


def test_fault_runner_and_workers_import_without_jax_or_reference_package():
    """The runner's ``--list``, the sanitizer's worker and the example it
    spawns, in a process where JAX and the JAX package cannot load."""
    out = _run_blocked(_RUNNER)
    assert out["rc"] == 0 and out["san_worker"] and out["example"]
    assert "corrupt_divergence" in out["names"] and len(out["names"]) == 15
    for module in ("faultinject.runner", "faultinject._san_worker", "examples.train_bytes"):
        assert f"torchft_tpu_torch.{module}" in out["modules"]


def _port_sources():
    pkg = os.path.join(REPO, "torchft_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_forbidden_imports_in_sources():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"torchft_tpu_torch/collectives_device.py",
            "torchft_tpu_torch/checkpointing/collectives_transport.py",
            "torchft_tpu_torch/data.py", "torchft_tpu_torch/models/resnet.py",
            "torchft_tpu_torch/lighthouse.py",
            "torchft_tpu_torch/examples/train_cifar.py",
            "torchft_tpu_torch/benchmarks/recovery.py",
            "torchft_tpu_torch/benchmarks/crossgroup.py",
            "torchft_tpu_torch/wire_codec.py", "torchft_tpu_torch/bench.py",
            "torchft_tpu_torch/benchmarks/long_context.py",
            "torchft_tpu_torch/benchmarks/resnet_ft.py",
            "torchft_tpu_torch/benchmarks/quorum_overlap.py",
            "torchft_tpu_torch/benchmarks/commit_pipeline.py",
            "torchft_tpu_torch/benchmarks/diloco.py",
            "torchft_tpu_torch/checkpointing/stripes.py",
            "torchft_tpu_torch/checkpointing/delta.py",
            "torchft_tpu_torch/checkpointing/bench.py",
            "torchft_tpu_torch/telemetry/__init__.py",
            "torchft_tpu_torch/telemetry/registry.py",
            "torchft_tpu_torch/telemetry/events.py",
            "torchft_tpu_torch/telemetry/tracing.py",
            "torchft_tpu_torch/telemetry/anatomy.py",
            "torchft_tpu_torch/telemetry/flight.py",
            "torchft_tpu_torch/telemetry/native.py",
            "torchft_tpu_torch/telemetry/fleetdelta.py",
            "torchft_tpu_torch/telemetry/timeseries.py",
            "torchft_tpu_torch/telemetry/slo.py",
            "torchft_tpu_torch/telemetry/regression.py",
            "torchft_tpu_torch/telemetry/critical_path.py",
            "torchft_tpu_torch/benchmarks/quorum_scale.py",
            "torchft_tpu_torch/benchmarks/telemetry_overhead.py",
            "torchft_tpu_torch/faultinject/__init__.py",
            "torchft_tpu_torch/faultinject/core.py",
            "torchft_tpu_torch/telemetry/blackbox.py",
            "torchft_tpu_torch/telemetry/profiler.py",
            "torchft_tpu_torch/telemetry/diagnosis.py",
            "torchft_tpu_torch/telemetry/postmortem.py",
            "torchft_tpu_torch/benchmarks/profiler_overhead.py",
            "torchft_tpu_torch/faultinject/runner.py",
            "torchft_tpu_torch/faultinject/_san_worker.py",
            "torchft_tpu_torch/examples/train_bytes.py",
            "torchft_tpu_torch/profiling.py",
            "torchft_tpu_torch/multiprocessing.py",
            "torchft_tpu_torch/proxy.py",
            "torchft_tpu_torch/checkpointing/disk.py",
            "torchft_tpu_torch/parameter_server.py",
            "torchft_tpu_torch/parallel/multihost.py",
            "torchft_tpu_torch/launcher.py",
            "torchft_tpu_torch/k8s.py",
            "torchft_tpu_torch/examples/train_ddp.py",
            "torchft_tpu_torch/examples/train_diloco.py"} <= scanned
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


_DEPLOYMENT = _BLOCK + r"""
import json, os, sys, tempfile
from datetime import timedelta
import numpy as np, torch
from torchft_tpu_torch import CollectivesProxy, ParameterServer, k8s, launcher
from torchft_tpu_torch.checkpointing.disk import DiskCheckpointer
from torchft_tpu_torch.collectives import CollectivesTcp, ReduceOp
from torchft_tpu_torch.examples import train_ddp, train_diloco
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.store import StoreServer
import functools, threading

class Mgr:
    step = 0
    def current_step(self): return self.step
    def state_dict(self): return {"step": self.step}
    def load_state_dict(self, s): self.step = s["step"]

d = tempfile.mkdtemp()
m = Mgr()
got = {}
ck = DiskCheckpointer(d, m, state_dict=lambda: {"w": torch.arange(3.0)},
                      load_state_dict=got.update, every=1, tag="g0")
m.step = 1
ck.maybe_save()
m2 = Mgr()
DiskCheckpointer(d, m2, state_dict=dict, load_state_dict=got.update, tag="g0").restore()
multihost.initialize_group()  # no endpoint: a no-op
store = StoreServer()
proxies = [CollectivesProxy(functools.partial(CollectivesTcp, timeout=timedelta(seconds=10)))
           for _ in range(2)]
ths = [threading.Thread(target=p.configure, args=(store.address(), i, 2))
       for i, p in enumerate(proxies)]
[t.start() for t in ths]; [t.join() for t in ths]
arrays = [np.full(1 << 15, float(i + 1), np.float32) for i in range(2)]
works = [p.allreduce([a], ReduceOp.SUM) for p, a in zip(proxies, arrays)]
[w.wait(timedelta(seconds=20)) for w in works]
for p in proxies:
    p.shutdown()
store.shutdown()
print(json.dumps({"restored": m2.step, "w": got["w"].tolist(), "sum": float(arrays[0][0]),
                  "plane": proxies[0].plane_info(),
                  "k8s": "torchft_tpu_torch.launcher" in k8s.emit_manifests(["x"]),
                  "ps": issubclass(ParameterServer, object),
                  "initialized": multihost.is_initialized(),
                  "examples": callable(train_ddp.main) and callable(train_diloco.main),
                  "modules": sorted(sys.modules)}))
"""


def test_deployment_plane_runs_without_jax_or_reference_package():
    """The launcher, k8s, the proxy (an allreduce through two spawned
    children), the disk checkpointer, the parameter server, multihost and
    both examples, in a process where JAX and the JAX package cannot
    load."""
    out = _run_blocked(_DEPLOYMENT)
    assert out["restored"] == 1 and out["w"] == [0.0, 1.0, 2.0]
    assert out["sum"] == 3.0 and out["plane"].startswith("proxy:")
    assert out["k8s"] and out["ps"] and out["examples"] and not out["initialized"]
    for module in ("launcher", "k8s", "proxy", "multiprocessing", "parameter_server",
                   "checkpointing.disk", "parallel.multihost", "examples.train_ddp",
                   "examples.train_diloco"):
        assert f"torchft_tpu_torch.{module}" in out["modules"]
