"""The port's CIFAR example (``torchft_tpu_torch/examples/train_cifar.py``)
against the JAX package's (``examples/train_cifar.py``), on the CPU.

One replica group, served by ``python -m torchft_tpu_torch.lighthouse`` in
a subprocess, takes 2 fault-tolerant steps of a narrow ResNet (channels 4,
8, 16, 32, every stage present) at batch 8 from the JAX init; the JAX
example's own ``grads_fn`` / ``apply_fn`` (``jax.value_and_grad`` of the
ResNet loss, ``optax.sgd(0.05, momentum=0.9)``) take the same 2 steps on
the same batches (the same ``step_indices`` ids, the same augmentation
draws). Float32 on both sides: losses at rtol 1e-5; params, momentum and
BN stats at atol 1e-5 (two updates of 0.05 x gradients that agree to
1e-4, see ``test_torch_resnet.py``). The copied dataset and augmentation
are held equal to the JAX example's exactly.
"""

import importlib.util
import os
import re
import subprocess
import sys
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.data import DistributedSampler as JSampler
from torchft_tpu.data import step_indices as j_step_indices
from torchft_tpu.models import resnet as J
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.examples import train_cifar as C
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import resnet as R
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(channels=(4, 8, 16, 32), blocks_per_stage=(2, 2, 2, 2))
BATCH = 8


def _jax_example():
    """The JAX example as a module (its ``main`` does not run on import)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_cifar", os.path.join(REPO, "examples", "train_cifar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cli_lighthouse():
    """``python -m torchft_tpu_torch.lighthouse`` in a subprocess; yields
    its address and checks that SIGTERM ends it cleanly."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse", "--bind", "[::]:0",
         "--min_replicas", "1", "--join_timeout_ms", "100"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(120, proc.kill)  # a lighthouse that never starts
    killer.start()
    try:
        address = None
        for line in proc.stderr:
            m = re.search(r"lighthouse listening on (\S+)", line)
            if m:
                address = m.group(1)
                break
        assert address, "the lighthouse never reported its address"
        yield address
    finally:
        killer.cancel()
        proc.terminate()
        rc = proc.wait(timeout=30)
        proc.stderr.close()
    assert rc == 0, f"the lighthouse exited with {rc} on SIGTERM"


def test_dataset_and_augment_equal_jax(tmp_path):
    jmod = _jax_example()
    ji, jl = jmod.ensure_dataset(str(tmp_path / "jax.npz"), n=64)
    ti, tl = C.ensure_dataset(str(tmp_path / "port.npz"), n=64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(C.augment(ti, np.random.default_rng(1000)),
                                  jmod.augment(ji, np.random.default_rng(1000)))


def test_example_two_steps_match_jax(tmp_path, cli_lighthouse):
    images, labels = C.ensure_dataset(str(tmp_path / "cifar.npz"))
    jparams, jstats = J.init(jax.random.PRNGKey(0), J.ResNetConfig(**NARROW, dtype=jnp.float32))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_stats = jax.tree_util.tree_map(np.asarray, jstats)

    # the port: the example's trainer, one group, from the JAX init
    store = StoreServer()
    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30), native_plane=True), load_state_dict=None,
        state_dict=None, min_replica_size=1, replica_id="cifar0", store_addr=store.address(),
        rank=0, world_size=1, lighthouse_addr=cli_lighthouse, timeout=timedelta(seconds=30))
    try:
        step = C.CifarStep(R.ResNetConfig(**NARROW, dtype=torch.float32), device="cpu")
        assert step.graphs is None  # eager on the CPU
        trainer = C.CifarTrainer(manager, step, images, labels, replica_group=0, num_groups=1,
                                 batch=BATCH)
        trainer.load_state_dict({"params": R.params_from_jax(np_params, np_stats, "cpu")[0],
                                 "opt_state": trainer.opt.state_dict(),
                                 "bn": R.params_from_jax(np_params, np_stats, "cpu")[1]})
        port = [trainer.step() for _ in range(2)]
        assert manager.current_step() == 2
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
    assert all(committed for _, _, committed in port)

    # the JAX example's step on the same batches
    jmod = _jax_example()
    cfg = J.ResNetConfig(**NARROW, dtype=jnp.float32)
    tx = optax.sgd(0.05, momentum=0.9)
    params, stats = jparams, jstats
    opt_state = tx.init(params)
    sampler = JSampler(len(images), replica_group=0, num_replica_groups=1, shuffle=True, seed=0)
    rng = np.random.default_rng(1000)
    grads_fn = jax.jit(lambda p, bn, x, y: jax.value_and_grad(  # the JAX example's
        lambda p: J.loss_fn(p, bn, x, y, cfg), has_aux=True)(p))
    losses = []
    for s in range(2):
        ids = j_step_indices(sampler, s, BATCH)
        np.testing.assert_array_equal(port[s][1], ids)
        x = jmod.augment(images[ids], rng).astype(np.float32) / 255.0
        y = jnp.asarray(labels[ids], jnp.int32)
        (loss, new_bn), grads = grads_fn(params, stats, jnp.asarray(x), y)
        updates, opt_state = tx.update(grads, opt_state, params)
        params, stats = optax.apply_updates(params, updates), new_bn
        losses.append(float(loss))
    np.testing.assert_allclose([loss for loss, _, _ in port], losses, rtol=1e-5)

    def hwio(t):
        a = t.detach().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    momentum = [trainer.opt.state[p]["momentum_buffer"] for p in tree_leaves(trainer.params)]
    trace = jax.tree_util.tree_leaves(opt_state[0].trace)
    for got, want in ((tree_leaves(trainer.params), jax.tree_util.tree_leaves(params)),
                      (momentum, trace),
                      (tree_leaves(trainer.stats), jax.tree_util.tree_leaves(stats))):
        assert len(got) == len(want)
        for t, a in zip(got, want):
            np.testing.assert_allclose(hwio(t), np.asarray(a), atol=1e-5)


def test_ckpt_dir_is_not_ported(tmp_path, monkeypatch):
    """CKPT_DIR is wired; the part that is not ported is a checkpoint
    written as per-process files (sharded leaves, ROADMAP queue 1 item 5):
    restoring one raises before the first quorum."""
    from torchft_tpu_torch.checkpointing.serialization import save_state
    from torchft_tpu_torch.coordination import LighthouseServer

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for pidx in (0, 1):
        with open(ckpt / f"group0_step2.proc{pidx}of2.ckpt", "wb") as f:
            save_state({"torchft": {"step": 2, "batches_committed": 2}, "user": {}}, f)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    monkeypatch.setenv("CKPT_DIR", str(ckpt))
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("REPLICA_GROUP_ID", "0")
    monkeypatch.setenv("NUM_REPLICA_GROUPS", "1")
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", lighthouse.address().split("//", 1)[-1])
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "cifar.npz"))
    try:
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            C.main()
    finally:
        lighthouse.shutdown()


def test_graph_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        C.CifarStep(R.ResNetConfig(**NARROW), device="cpu", graph=True)
