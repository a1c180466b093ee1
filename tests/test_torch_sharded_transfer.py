"""The port's sharded checkpoint transfer: the counterparts of
``tests/test_sharded_transfer.py``'s five cases, on DTensors in gloo
processes (``tests/torch_mesh_worker.py``), and the heal warm-up that the
transfer's header feeds (``Manager.set_heal_warmup``,
``TrainStep.warm_apply``).

A DTensor on a mesh of more than one rank ships this rank's shard with the
JAX package's header tuple (``("shards", dtype, global shape, (axis
names, mesh shape), spec entries, [(index, nbytes)])``); each rank holds
one shard a leaf, so a replicated copy ships once a rank, and the distinct
shards of all ranks add up to the model, never a gathered copy.
"""

import io
import json
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_worker import spawn
from torchft_tpu_torch.checkpointing.serialization import (
    ShardedArray,
    TensorSpec,
    flatten_state,
    load_state,
    loads_state,
    save_state,
    spec_tree_from_header,
)

DP_TP = {"dp": 2, "tp": 2}
W_BYTES, B_BYTES = 64 * 4, 16 * 4


def test_shards_travel_not_the_gather(tmp_path):
    spawn("flatten", 4, tmp_path, {"mesh": DP_TP}, timeout=60)
    distinct = {}
    for rank in range(4):
        with open(tmp_path / f"infos_r{rank}.json") as f:
            got = json.load(f)
        kinds = [i[0] for i in got["infos"]]
        assert kinds.count("shards") == 2 and "obj" in kinds
        # one shard a leaf: half of each (tp 2), never the gathered leaf
        assert got["nbuffers"] == 2
        assert sum(n for _, n in got["shards"]) == (W_BYTES + B_BYTES) // 2
        for idx, n in got["shards"]:
            distinct[json.dumps(idx)] = n
    # the dp replicas send the same shards: the distinct ones are the model
    assert sum(distinct.values()) == W_BYTES + B_BYTES


def test_roundtrip_to_congruent_mesh_bit_identical(tmp_path):
    spawn("flatten", 4, tmp_path, {"mesh": DP_TP}, timeout=60)
    # every rank rebuilds the shard its coordinate's sender wrote, on a
    # mesh over the ranks transposed, and compares bit for bit
    spawn("rebuild", 4, tmp_path, {"mesh": DP_TP}, timeout=60)


def test_sharded_array_full_fallback(tmp_path):
    spawn("full", 4, tmp_path, timeout=60)
    parts = [loads_state((tmp_path / f"full_r{r}.bin").read_bytes())["x"] for r in range(4)]
    assert all(isinstance(p, ShardedArray) for p in parts)
    assert parts[0].shape == (4, 8) and parts[0].mesh_desc == (("tp",), (4,))
    with pytest.raises(ValueError, match="cover"):
        parts[0].full()  # one rank's shard alone
    whole = ShardedArray(parts[0].dtype, parts[0].shape, parts[0].mesh_desc,
                         parts[0].spec_entries, [s for p in parts for s in p.shards])
    assert torch.equal(whole.full(), torch.arange(32, dtype=torch.float32).reshape(4, 8))


def test_dense_and_obj_leaves_unchanged():
    tree = {"a": np.arange(5, dtype=np.int64), "t": torch.arange(3.0), "s": "hello", "n": 7}
    buf = io.BytesIO()
    save_state(tree, buf)
    buf.seek(0)
    out = load_state(buf)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert torch.equal(out["t"], tree["t"])
    assert out["s"] == "hello" and out["n"] == 7


def test_single_device_array_stays_dense(tmp_path):
    spawn("dense", 1, tmp_path, timeout=60)


def test_spec_tree_from_header_gives_a_shards_leaf_its_global_shape():
    header = pickle.dumps((("dict", ["w"], [("leaf", None, None)]),
                           [("shards", "bfloat16", (8, 4), (("tp",), (2,)), ("tp", None),
                             [(((0, 4), (0, 4)), 32)])]))
    assert spec_tree_from_header(header) == {"w": TensorSpec((8, 4), torch.bfloat16)}


def test_heal_warmup_hook_fires_with_spec_tree():
    """``tests/test_manager.py::test_heal_warmup_hook_fires_with_spec_tree``
    on the port's Manager (constructed without its server)."""
    import threading

    from torchft_tpu_torch.manager import Manager

    m = Manager.__new__(Manager)
    m._heal_warmup = None
    seen, done = [], threading.Event()

    def warmup(spec):
        seen.append(spec)
        done.set()

    m.set_heal_warmup(warmup)
    header, _ = flatten_state({"w": torch.zeros(3, 2)})
    m._heal_header_cb(header)
    assert done.wait(5.0)
    assert seen[0]["w"].shape == (3, 2)


def test_warm_apply_builds_the_optimizer_state_a_heal_fills():
    """The warm-up builds AdamW's state from the transferred shapes; the
    heal's load then copies into those very tensors, and the next step
    matches an optimizer that loaded the state the usual way."""
    from torchft_tpu_torch.models.transformer import TransformerConfig
    from torchft_tpu_torch.optim import load_optimizer_state
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.utils.tree import tree_leaves

    cfg = TransformerConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2, head_dim=8,
                            d_ff=32, dtype=torch.float32)
    ts = TrainStep(cfg, device="cpu")
    src_params = ts.init_params(1)
    src = ts.init_opt(src_params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32))
    ts.step(src_params, src, tokens)
    header, _ = flatten_state({"opt_state": src.state_dict()})
    params = ts.init_params(1)
    opt = ts.init_opt(params)
    assert not opt.state
    ts.warm_apply(opt, spec_tree_from_header(header)["opt_state"])
    held = {id(t) for st in opt.state.values() for t in st.values()}
    assert len(opt.state) == len(tree_leaves(params))
    load_optimizer_state(opt, src.state_dict())
    assert {id(t) for st in opt.state.values() for t in st.values()} == held
    for sp, p in zip(tree_leaves(src_params), tree_leaves(params)):
        for k, v in src.state[sp].items():
            assert torch.equal(v, opt.state[p][k])
