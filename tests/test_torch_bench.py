"""The port's bench (``torchft_tpu_torch/bench.py`` and the harnesses of
``torchft_tpu_torch/benchmarks/``) on the CPU, beside the JAX package's.

No timing is asserted: the structure of the rows (the JAX rows' keys),
counts (committed steps, parameters, FLOPs, payload bytes) and values
(the DiLoCo MLP's data, params, loss and gradients against the JAX
harness's; the int8 wire's first average within its limit of the exact
one). The 647M model's parameter count is taken without allocating
(``jax.eval_shape`` on the JAX side, fake tensors on the port's). Every
subprocess has its own timeout.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the JAX package's root bench.py

import bench as jax_bench  # noqa: E402
from torchft_tpu.benchmarks import diloco as jax_diloco  # noqa: E402
from torchft_tpu.models import transformer as jax_transformer  # noqa: E402
from torchft_tpu_torch import bench  # noqa: E402
from torchft_tpu_torch.benchmarks import crossgroup, diloco, long_context, resnet_ft  # noqa: E402
from torchft_tpu_torch.models import resnet  # noqa: E402
from torchft_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    headline_config,
    init_params,
)
from torchft_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# the JAX rows' keys (torchft_tpu/benchmarks/long_context.py:52-57,71-80,
# resnet_ft.py:85-91, diloco.py:247-257, crossgroup.py:506-516 and 681-685)
JAX_LONG_KEYS = {"steps_per_sec", "tokens_per_sec", "mfu_pct", "attention"}
JAX_SCALE_KEYS = {"steps_per_sec", "tokens_per_sec", "n_params", "mfu_pct", "config"}
JAX_RESNET_KEYS = {"steps_per_sec", "imgs_per_sec", "runs_steps_per_sec", "spread_pct", "config"}
JAX_DILOCO_KEYS = {"num_groups", "sync_every", "outer_steps_measured", "inner_steps_per_sec",
                   "per_sync_seconds", "overhead_pct", "payload_bytes", "config"}
JAX_TREE_KEYS = {"seconds_per_round", "gb_per_sec", "plane", "wire_codec",
                 "stages_per_round_s", "derived_llama2_7b_avg_s"}
JAX_COMPRESSED_KEYS = {"topology", "tree_mb", "codec", "serial", "streamed"}

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, head_dim=32, d_ff=128)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DEVICE", "cpu")


def _jax_cfg(**kw):
    import jax.numpy as jnp

    return jax_transformer.TransformerConfig(dtype=jnp.bfloat16, **kw)


def _jax_n_params(cfg) -> int:
    shapes = jax.eval_shape(lambda k: jax_transformer.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def _port_n_params(cfg) -> int:
    with FakeTensorMode():  # shapes only: nothing is allocated
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return sum(p.numel() for p in tree_leaves(params))


SCALE = dict(vocab_size=32000, d_model=2048, n_layers=12, n_heads=16, head_dim=64, d_ff=5632)


@pytest.mark.parametrize("model,seq", [("headline", 1024), ("headline", 32768),
                                       ("scale_647M", 1024)])
def test_model_flops_and_params_equal_jax(model, seq):
    if model == "headline":
        port_cfg, jax_cfg = headline_config(), jax_bench.headline_config()
        batch = 8 if seq == 1024 else 1
    else:
        port_cfg, jax_cfg = long_context.scale_config(), _jax_cfg(**SCALE, remat=False)
        batch = 4
    n = _port_n_params(port_cfg)
    assert n == _jax_n_params(jax_cfg)
    assert bench._model_flops_per_step(port_cfg, n, batch, seq) == \
        jax_bench._model_flops_per_step(jax_cfg, n, batch, seq)


def test_peak_flops_by_card_name():
    assert bench._peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench._peak_flops("NVIDIA A100-SXM4-80GB") == 0.0
    assert bench.mfu_pct(2.0, 1e12, bench._peak_flops("Some Other GPU")) is None
    assert bench.mfu_pct(2.0, 989e12, 989e12) == 200.0


@pytest.mark.parametrize("averaging", [True, False], ids=["avg", "noavg"])
def test_train_bench_commits_every_step(cpu, averaging):
    cfg = TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    rec = {}
    sps, n_params = bench.train_bench(cfg, 2, 64, steps=2, warmup=1, averaging=averaging,
                                      record=rec)
    assert sps > 0
    assert rec["steps"] == 3 and rec["committed"] == 3  # the Manager's step count
    assert n_params == _jax_n_params(_jax_cfg(**TINY))
    # the CPU runs the kernels' plain versions: no launch is counted
    assert rec["launches_per_step"] == [{"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}]
    assert rec["captures"] is None and np.isfinite(rec["loss"])


def test_long_context_rows_carry_the_jax_keys(cpu):
    cfg = TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    scale = TransformerConfig(**TINY, dtype=torch.float32, remat=False, attention_impl="flash")
    rows = long_context.run(cfg, lengths=((128, 1, 1, 1), (64, 2, 1, 1)),
                            scale=(scale, (2, 64, 1, 1)))
    assert list(rows) == ["long_context_s128", "long_context_s64", "scale_647M"]
    for name, row in rows.items():
        assert not bench.has_error(row), row
        keys = JAX_SCALE_KEYS if name == "scale_647M" else JAX_LONG_KEYS
        assert keys <= set(row), (name, keys - set(row))
        assert row["committed"] == row["steps"] == 2
        assert row["mfu_pct"] is None  # no peak on the CPU
    assert rows["scale_647M"]["n_params"] == _jax_n_params(_jax_cfg(**TINY, remat=False))


def test_resnet_row_carries_the_jax_keys(cpu):
    cfg = resnet.ResNetConfig(channels=(4, 8, 16, 32), dtype=torch.float32)
    row = resnet_ft.run(steps=2, warmup=1, batch=4, reps=2, cfg=cfg)
    assert JAX_RESNET_KEYS <= set(row)
    assert len(row["runs_steps_per_sec"]) == 2 and row["steps_per_sec"] > 0
    assert row["committed"] == [3, 3]


def _run(cmd, env_extra=None, jax_side=False):
    env = {k: v for k, v in os.environ.items() if jax_side or not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-m", *cmd], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _row(proc, timeout=120):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_quorum_and_commit_harnesses_equal_jax_keys():
    """The port's and the JAX package's quorum_overlap and commit_pipeline,
    one pair of runs each, at once in four processes."""
    short = ["--runs", "1", "--steps", "3"]
    procs = {
        (pkg, name): _run([f"{pkg}.benchmarks.{name}", *short], jax_side=pkg == "torchft_tpu")
        for pkg in ("torchft_tpu_torch", "torchft_tpu")
        for name in ("quorum_overlap", "commit_pipeline")
    }
    rows = {key: _row(p) for key, p in procs.items()}
    for name in ("quorum_overlap", "commit_pipeline"):
        port, ref = rows[("torchft_tpu_torch", name)], rows[("torchft_tpu", name)]
        assert set(port) == set(ref), set(port) ^ set(ref)
    assert rows[("torchft_tpu_torch", "commit_pipeline")]["rollbacks"] == 0
    assert rows[("torchft_tpu", "commit_pipeline")]["rollbacks"] == 0


def test_diloco_data_params_loss_and_grads_equal_jax():
    x, y = diloco._make_dataset()
    jx, jy = jax_diloco._make_dataset()
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    params, jparams = diloco._init_params(), jax_diloco._init_params()
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert params[k].dtype == jparams[k].dtype and params[k].tobytes() == jparams[k].tobytes()
    xb, yb = x[:64], y[:64]
    jloss, jgrads = jax.value_and_grad(jax_diloco._loss_fn)(jparams, xb, yb)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    loss = diloco._loss_fn(tp, torch.from_numpy(xb), torch.from_numpy(yb))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]), rtol=0, atol=1e-6)


def test_measure_diloco_row(cpu):
    row = diloco.measure_diloco(num_groups=2, outer_steps=1)
    assert JAX_DILOCO_KEYS <= set(row)
    assert row["outer_steps_measured"] == 1
    # what every sync of both workers handed the collectives: the MLP's
    # float32 bytes, 32x64 + 64 + 64x10 + 10 floats
    assert row["payload_bytes"] == 11048 == sum(
        a.nbytes for a in jax_diloco._init_params().values())


def test_measure_compressed_rows():
    # 11 leaves in 2 buckets: "g10" sorts before "g2", the order must not matter
    rows = crossgroup.measure_compressed(total_mb=44, rounds=1, device="cpu")
    assert JAX_COMPRESSED_KEYS <= set(rows)
    for sched in ("serial", "streamed"):
        row = rows[sched]
        assert JAX_TREE_KEYS <= set(row), JAX_TREE_KEYS - set(row)
        assert (row["plane"], row["wire_codec"]) == ("tcp-striped", "int8")
        # int8's error scales with its chunk's largest element: the first
        # average lies within 2/127 of the tree's largest one
        assert 0 < row["first_avg_wire_err"]["peak"] <= 2 / 127
    assert set(rows["serial"]["stages_per_round_s"]) == {"host_copy", "wire", "device_copy"}


def test_has_error_walks_nested_rows():
    assert not bench.has_error({"a": 1, "b": {"c": [1]}})
    assert bench.has_error({"a": {"serial": {"error": "x"}}})
