"""The port's sharded train step against the JAX package's on its virtual
CPU mesh: the same params (the JAX init, carried across with
``params_from_jax``) and tokens, through the JAX ``TrainStep`` on a mesh of
four virtual devices and through the port's ``TrainStep`` on a DTensor mesh
of four gloo processes (``tests/torch_mesh_worker.py``), with ``CFG`` of
``tests/test_hsdp.py``, at pp 2 with two microbatches where the mesh has
pp 2. Also the one-rank mesh a group on one card runs.

Bars: those of ``tests/test_torch_transformer.py`` (float32 end to end):
the loss to rtol 1e-5, the gathered gradients to atol 2e-5, and the params
after one AdamW step to atol 1e-6 (the two AdamW formulations round
differently at float32). The port also holds every gradient to its
param's placements and local shape (in the worker).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_mesh_worker import spawn
from torchft_tpu.models.transformer import TransformerConfig
from torchft_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as jmake_mesh
from torchft_tpu.parallel.train_step import TrainStep as JTrainStep
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.parallel import mesh as M

# tests/test_hsdp.py:33-41
CFG = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8, d_ff=32)


def _save_tree(path, tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_save_tree(None, v, prefix + k + "/"))
        else:
            flat[prefix + k] = np.asarray(v)
    if path is not None:
        np.savez(path, **flat)
    return flat


def _cfg(mesh_sizes):
    """CFG at the mesh's pipeline depth."""
    return dict(CFG, pp=mesh_sizes.get("pp", 1))


def _jax_step(mesh_sizes, tokens):
    """Loss, gradients and params after one optax.adamw(3e-4) step of the
    JAX TrainStep on the virtual mesh; the params it started from."""
    n = int(np.prod(list(mesh_sizes.values()))) if mesh_sizes else 1
    mesh = jmake_mesh(JMeshConfig(**mesh_sizes), devices=jax.devices()[:n])
    ts = JTrainStep(TransformerConfig(**_cfg(mesh_sizes), dtype=jnp.float32), optax.adamw(3e-4),
                    mesh)
    params = ts.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    toks = ts.shard_batch(jnp.asarray(tokens))
    loss, grads = ts.grads(params, toks)
    new, _ = ts.apply(params, ts.init_opt(params), grads, donate=False)
    leaves = jax.tree_util.tree_leaves
    return (np_params, float(loss), [np.asarray(g) for g in leaves(grads)],
            [np.asarray(p) for p in leaves(new)])


@pytest.mark.parametrize("mesh_sizes,chunk", [(dict(fsdp=2, tp=2), None),
                                              (dict(dp=2, tp=2), None), ({}, None),
                                              (dict(fsdp=2, tp=2), "64"),
                                              (dict(sp=2, tp=2), None),
                                              (dict(fsdp=2, pp=2), None),
                                              (dict(pp=2, sp=2), None)],
                         ids=["fsdp2-tp2", "dp2-tp2", "one-rank", "fsdp2-tp2-chunked-loss",
                              "sp2-tp2", "pp2-fsdp2", "pp2-sp2"])
def test_sharded_step_matches_jax_train_step(tmp_path, monkeypatch, mesh_sizes, chunk):
    """``chunk``: the logit budget of both packages' loss heads
    (``TORCHFT_TPU_LOSS_CHUNK_ELEMS``, read by the workers too), small
    enough that both chunk the sequence."""
    if chunk is not None:
        monkeypatch.setenv("TORCHFT_TPU_LOSS_CHUNK_ELEMS", chunk)
    tokens = np.random.default_rng(7).integers(0, CFG["vocab_size"], (4, 16)).astype(np.int32)
    np_params, jl, jg, jnew = _jax_step(mesh_sizes, tokens)
    _save_tree(tmp_path / "params.npz", np_params)
    np.save(tmp_path / "tokens.npy", tokens)
    world = int(np.prod(list(mesh_sizes.values()))) if mesh_sizes else 1
    spawn("step", world, tmp_path, {"mesh": mesh_sizes, "cfg": _cfg(mesh_sizes)}, timeout=60)
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(float(out["loss"]), jl, rtol=1e-5)
    for i, (g, p) in enumerate(zip(jg, jnew)):
        np.testing.assert_allclose(out[f"g{i}"], g, atol=2e-5)
        np.testing.assert_allclose(out[f"p{i}"], p, atol=1e-6)


def test_param_specs_match_jax():
    """The port's specs are the JAX ``param_specs`` of the dense pp=1
    model, entry for entry."""
    from torchft_tpu.models.transformer import param_specs as jspecs

    jleaves = jax.tree_util.tree_leaves(
        jspecs(TransformerConfig(**CFG)), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tleaves = jax.tree_util.tree_leaves(T.param_specs(), is_leaf=lambda x: isinstance(x, M.P))
    assert [tuple(j) for j in jleaves] == [t.entries for t in tleaves]


def test_mesh_config_and_axes_match_jax():
    from torchft_tpu.parallel.mesh import AXES as JAXES

    assert tuple(M.AXES) == tuple(JAXES)
    for sizes in ({}, dict(fsdp=2, tp=2), dict(dp=2, pp=2, ep=2)):
        jc, tc = JMeshConfig(**sizes), M.MeshConfig(**sizes)
        assert jc.sizes == tc.sizes and jc.total == tc.total
    assert ([f.name for f in dataclasses.fields(JMeshConfig)]
            == [f.name for f in dataclasses.fields(M.MeshConfig)])


def test_unported_axes_raise_naming_roadmap():
    """ep above 1 raises, naming its ROADMAP item (8), and so does an MoE
    tree; pp and sp above 1 are taken (the config's pipeline depth must be
    the mesh's), and ``params_from_jax`` takes a tree of leading size pp;
    a mesh of more than one rank needs the group's process group."""
    with pytest.raises(NotImplementedError, match="item 8"):
        T.check_mesh(_FakeMesh({"ep": 2}))
    for sizes in ({"pp": 2}, {"sp": 2}, {"pp": 2, "sp": 2, "tp": 2}):
        T.check_mesh(_FakeMesh(sizes))
    T.check_mesh(_FakeMesh({"pp": 2, "sp": 2}), T.TransformerConfig(n_layers=2, pp=2))
    with pytest.raises(ValueError, match="pp"):
        T.check_mesh(_FakeMesh({"pp": 2}), T.TransformerConfig())
    with pytest.raises(RuntimeError, match="initialize_group"):
        M.make_mesh(M.MeshConfig(fsdp=2), "cpu")
    layers = {k: np.zeros((2, 1, 4, 4), np.float32) for k in T._LAYER_KEYS}
    got = T.params_from_jax({"layers": layers}, device="cpu")
    assert got["layers"]["wq"].shape == (2, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="item 8"):
        T.params_from_jax({"layers": dict(layers, router=np.zeros((2, 1, 4, 2)))},
                          device="cpu")


def test_place_and_the_graph_key_on_a_two_rank_mesh(tmp_path):
    """``mesh.place`` (a full tensor gives this rank's slice, a DTensor is
    kept or redistributed), ``is_dtensor``, the CUDA-graph cache's key of a
    DTensor (its local shard's address), and ``TrainStep`` keeping the step
    eager on a mesh of two ranks (``graph=True`` raises); two gloo
    processes."""
    spawn("place", 2, tmp_path, timeout=60)


def test_placements_of_specs():
    """Each P entry becomes Shard(dim) on its axis, Replicate elsewhere; an
    axis of size 1 (or left out of the mesh) stays Replicate; the inverse
    gives the entries back; local_index is DTensor's torch.chunk split."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh({"fsdp": 2, "tp": 2}, coord=(1, 0))
    assert M.placements(M.P(None, ("tp", "fsdp")), mesh) == [Shard(1), Shard(1)]
    assert M.placements(M.P("pp", None, "fsdp", "tp"), mesh) == [Shard(2), Shard(3)]
    assert M.placements(M.P("dp", "sp"), mesh) == [Replicate(), Replicate()]
    assert M.spec_entries([Shard(1), Shard(1)], mesh, 2) == (None, ("fsdp", "tp"))
    assert M.spec_entries([Shard(0), Replicate()], mesh, 2) == ("fsdp", None)
    # fsdp coordinate 1 of 2, then tp coordinate 0 of 2 inside it
    assert M.local_index((3, 8), mesh, [Shard(1), Shard(1)]) == ((0, 3), (4, 6))
    # ceil chunks: 5 rows over 2 ranks give 3 and 2
    assert M.local_index((5,), mesh, [Shard(0), Replicate()]) == ((3, 5),)


class _FakeMesh:
    """The parts of a DeviceMesh the placement helpers read."""

    def __init__(self, sizes, coord=None):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())
        self.ndim = len(self._sizes)
        self._coord = list(coord or [0] * self.ndim)

    def size(self, i):
        return self._sizes[i]

    def get_coordinate(self):
        return self._coord
