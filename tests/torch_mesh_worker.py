"""One rank of the port's multi-process mesh tests: a gloo group on the CPU,
``torchft_tpu_torch`` alone (no JAX in this process). The tests hand it
numpy inputs through files in a scratch directory and read its numpy
outputs back; :func:`spawn` runs ``world`` of them and raises with their
stderr if any fails.

    python tests/torch_mesh_worker.py MODE RANK WORLD PORT DIR ARGS_JSON
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(mode: str, world: int, tmp, args=None, timeout: float = 60.0) -> None:
    """Run ``world`` ranks of ``mode`` and wait for all (at most ``timeout``
    seconds); raise with the failed ranks' stderr."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, errs = [], []
    for rank in range(world):
        err = open(os.path.join(str(tmp), f"{mode}_r{rank}.stderr"), "wb")
        errs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank), str(world), str(port),
             str(tmp), json.dumps(args or {})],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=err))
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(0.1, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()
    if any(rcs):
        tails = [open(e.name, errors="replace").read()[-2000:] for e in errs]
        raise AssertionError(f"{mode}: ranks exited {rcs}: " + "\n---\n".join(tails))


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def _tree_from_npz(path):
    """A nested dict from an npz whose keys are '/'-joined paths."""
    import numpy as np

    out = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return out


def mode_step(rank, world, tmp, args):
    """The sharded TrainStep's loss, gathered gradients and one AdamW
    update from the JAX params and tokens in ``tmp``."""
    import numpy as np
    import torch

    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.utils.tree import tree_leaves

    mesh = make_mesh(MeshConfig(**args["mesh"]), "cpu")
    cfg = T.TransformerConfig(**args["cfg"], dtype=torch.float32)
    ts = TrainStep(cfg, mesh=mesh)
    params = T.params_from_jax(_tree_from_npz(os.path.join(tmp, "params.npz")), mesh=mesh)
    tokens = torch.from_numpy(np.load(os.path.join(tmp, "tokens.npy")))
    loss, grads = ts.grads(params, tokens)
    for g, p, place in zip(tree_leaves(grads), tree_leaves(params), ts.placements):
        assert list(g.placements) == place == list(p.placements), (g.placements, place)
        assert g.to_local().shape == p.to_local().shape
    full = [g.full_tensor().numpy() for g in tree_leaves(grads)]
    opt = ts.init_opt(params)
    ts.apply(params, opt, grads)
    new = [p.full_tensor().detach().numpy() for p in tree_leaves(params)]
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), loss=np.float32(float(loss)),
                 **{f"g{i}": g for i, g in enumerate(full)},
                 **{f"p{i}": p for i, p in enumerate(new)})


def _sharded_tree(mesh):
    """The JAX test's tree: ``w`` [8, 8] over tp on dim 0, ``b`` [16] over
    tp, an object leaf."""
    import torch

    from torchft_tpu_torch.parallel.mesh import P, from_full, placements

    w = from_full(torch.arange(64, dtype=torch.float32).reshape(8, 8), mesh,
                  placements(P("tp", None), mesh))
    b = from_full(torch.arange(16, dtype=torch.float32), mesh, placements(P("tp"), mesh))
    return {"w": w, "b": b, "step": 3}


def mode_flatten(rank, world, tmp, args):
    """Each rank's header and buffer sizes of the (dp 2, tp 2) tree, and its
    bytes on disk for the receiving ranks."""
    import pickle

    from torchft_tpu_torch.checkpointing.serialization import dumps_state, flatten_state
    from torchft_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(**args["mesh"]), "cpu")
    tree = _sharded_tree(mesh)
    header, buffers = flatten_state(tree)
    _, infos = pickle.loads(header)
    with open(os.path.join(tmp, f"infos_r{rank}.json"), "w") as f:
        json.dump({"infos": [[i[0], repr(i[1:])] for i in infos],
                   "shards": [[list(map(list, idx)), n] for i in infos if i[0] == "shards"
                              for idx, n in i[5]],
                   "nbuffers": len(buffers), "coord": list(mesh.get_coordinate())}, f)
    with open(os.path.join(tmp, f"state_r{rank}.bin"), "wb") as f:
        f.write(dumps_state(tree))


def mode_rebuild(rank, world, tmp, args):
    """Load the state a rank of the sender's mesh wrote (the one at this
    rank's coordinate) onto a congruent mesh over the ranks transposed
    (rank r of it sits where another rank sat; each of its axes keeps its
    ranks in ascending order, as DTensor's process groups do), and check it
    bit for bit against the values sent."""
    import torch

    from torchft_tpu_torch.checkpointing.serialization import from_transfer_tree, loads_state
    from torchft_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = MeshConfig(**args["mesh"])
    sender = make_mesh(cfg, "cpu")
    ranks = [0, 2, 1, 3]
    mesh = make_mesh(cfg, devices=ranks)
    peer = list(range(world))[ranks.index(rank)]  # the sender rank at my coordinate
    assert list(sender.mesh.flatten().tolist()).index(peer) == list(
        mesh.mesh.flatten().tolist()).index(rank)
    with open(os.path.join(tmp, f"state_r{peer}.bin"), "rb") as f:
        restored = from_transfer_tree(loads_state(f.read()), mesh)
    expect = _sharded_tree(sender)
    assert restored["step"] == 3
    for key in ("w", "b"):
        got = restored[key]
        assert got.device_mesh == mesh
        assert list(got.placements) == list(expect[key].placements)
        assert torch.equal(got.full_tensor(), expect[key].full_tensor())


def mode_full(rank, world, tmp, args):
    """One rank's file of the (tp 4) array, for ``ShardedArray.full``."""
    import torch

    from torchft_tpu_torch.checkpointing.serialization import dumps_state
    from torchft_tpu_torch.parallel.mesh import MeshConfig, P, from_full, make_mesh, placements

    mesh = make_mesh(MeshConfig(tp=4), "cpu")
    arr = from_full(torch.arange(32, dtype=torch.float32).reshape(4, 8), mesh,
                    placements(P(None, "tp"), mesh))
    with open(os.path.join(tmp, f"full_r{rank}.bin"), "wb") as f:
        f.write(dumps_state({"x": arr}))


def mode_dense(rank, world, tmp, args):
    """A DTensor on a one-rank mesh travels dense (``"tensor"``)."""
    import pickle

    import torch

    from torchft_tpu_torch.checkpointing.serialization import flatten_state, unflatten_state
    from torchft_tpu_torch.parallel.mesh import MeshConfig, P, from_full, make_mesh, placements

    mesh = make_mesh(MeshConfig(), "cpu")
    x = from_full(torch.arange(6, dtype=torch.float32), mesh, placements(P("tp"), mesh))
    header, buffers = flatten_state({"x": x})
    _, infos = pickle.loads(header)
    assert infos[0][0] == "tensor", infos
    out = unflatten_state(header, buffers)
    assert torch.equal(out["x"], torch.arange(6, dtype=torch.float32))


def mode_place(rank, world, tmp, args):
    """``mesh.place`` and ``is_dtensor`` on a (tp 2) mesh; the graph cache
    keys a DTensor by its local shard's storage; a mesh of more than one
    rank keeps the step eager."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from torchft_tpu_torch.models.transformer import TransformerConfig
    from torchft_tpu_torch.parallel import train_step
    from torchft_tpu_torch.parallel.mesh import MeshConfig, is_dtensor, make_mesh, place

    mesh = make_mesh(MeshConfig(tp=2), "cpu")
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    x = place(full, mesh, [Shard(1)])
    assert is_dtensor(x) and not is_dtensor(full) and not is_dtensor(None)
    assert torch.equal(x.to_local(), full[:, 3 * rank:3 * rank + 3])
    assert place(x, mesh, [Shard(1)]) is x
    y = place(x, mesh, [Replicate()])
    assert list(y.placements) == [Replicate()] and torch.equal(y.to_local(), full)
    assert train_step._ptrs([x, full]) == (x.to_local().data_ptr(), full.data_ptr())
    cfg = TransformerConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2, head_dim=8,
                            d_ff=32, dtype=torch.float32)
    assert train_step.TrainStep(cfg, mesh=mesh).graphs is None
    try:
        train_step.TrainStep(cfg, graph=True, mesh=mesh)
    except ValueError as e:
        assert "more than one rank" in str(e)
    else:
        raise AssertionError("graph=True on a mesh of two ranks did not raise")


def _full_grads(tensors):
    """Each rank's gradients of ``tensors`` (nonzero on its own slices
    only) summed over the world: the whole gradients."""
    import torch.distributed as dist

    out = []
    for t in tensors:
        g = t.grad.clone()
        dist.all_reduce(g)
        out.append(g.numpy())
    return out


def mode_ring(rank, world, tmp, args):
    """``ring_attention`` on the mesh from the q, k, v and output weights
    in ``tmp``: its output and the gradients of ``sum(out * w)``."""
    import numpy as np
    import torch

    from torchft_tpu_torch.ops.attention import ring_attention
    from torchft_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(**args["mesh"]), "cpu")
    with np.load(os.path.join(tmp, "qkv.npz")) as f:
        q, k, v, w = (torch.from_numpy(f[n]).requires_grad_(n != "w") for n in "qkvw")
    out = ring_attention(q, k, v, mesh, causal=args.get("causal", True)).full_tensor()
    (out * w).sum().backward()
    grads = _full_grads([q, k, v])
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), out=out.detach().numpy(),
                 **{f"d{n}": g for n, g in zip("qkv", grads)})


def mode_pipeline(rank, world, tmp, args):
    """The transformer's loss and gradients at pp 2 (``loss_fn`` through
    ``pipeline_forward``) on the mesh, from the JAX params of the pipelined
    config; rank 0 also runs the same weights as one stage, unsharded."""
    import numpy as np
    import torch

    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.parallel.mesh import MeshConfig, P, make_mesh, place, placements
    from torchft_tpu_torch.utils.tree import tree_leaves

    mesh = make_mesh(MeshConfig(**args["mesh"]), "cpu")
    cfg = T.TransformerConfig(**args["cfg"], dtype=torch.float32)
    tree = _tree_from_npz(os.path.join(tmp, "params.npz"))
    tokens = torch.from_numpy(np.load(os.path.join(tmp, "tokens.npy")))
    params = T.params_from_jax(tree, mesh=mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    sharded = place(tokens, mesh, placements(P(("dp", "fsdp"), "sp"), mesh))
    loss = T.loss_fn(params, sharded, cfg, mesh)
    grads = torch.autograd.grad(loss, leaves)
    full = [g.full_tensor().numpy() for g in grads]
    if rank == 0:
        seq = T.TransformerConfig(**dict(args["cfg"], pp=1, microbatches=0),
                                  dtype=torch.float32)
        one_stage = dict(tree, layers={k: v.reshape(1, -1, *v.shape[2:])
                                       for k, v in tree["layers"].items()})
        seq_loss = T.loss_fn(T.params_from_jax(one_stage, device="cpu"), tokens, seq)
        np.savez(os.path.join(tmp, "out.npz"), loss=np.float32(float(loss)),
                 seq_loss=np.float32(float(seq_loss)),
                 **{f"g{i}": g for i, g in enumerate(full)})


def mode_disk(rank, world, tmp, args):
    """An (fsdp 2) group's ``DiskCheckpointer``: every process writes its
    own file of the set, then a fresh checkpointer restores the set and
    the rebuilt DTensors equal the saved ones bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.checkpointing.disk import DiskCheckpointer
    from torchft_tpu_torch.checkpointing.serialization import from_transfer_tree
    from torchft_tpu_torch.parallel.mesh import MeshConfig, P, from_full, make_mesh, placements

    class Mgr:
        def __init__(self):
            self.step = 0

        def current_step(self):
            return self.step

        def state_dict(self):
            return {"step": self.step, "batches_committed": 2 * self.step}

        def load_state_dict(self, s):
            self.step = s["step"]

    mesh = make_mesh(MeshConfig(**args["mesh"]), "cpu")
    gen = torch.Generator().manual_seed(5)
    full = {"w": torch.randn(8, 6, generator=gen), "b": torch.randn(6, generator=gen)}
    state = {"w": from_full(full["w"], mesh, placements(P("fsdp", None), mesh)),
             "b": from_full(full["b"], mesh, placements(P(None), mesh)),
             "lr": np.float32(0.5)}
    mgr = Mgr()
    ck = DiskCheckpointer(tmp, mgr, state_dict=lambda: dict(state),
                          load_state_dict=lambda s: None, every=1, tag="g0")
    # every process claims its write generation before any of them saves
    dist.barrier()
    mgr.step = 3
    path = ck.maybe_save()
    assert path.endswith(f"g0_step3.proc{rank}of{world}.ckpt"), path
    dist.barrier()
    got, mgr2 = {}, Mgr()
    ck2 = DiskCheckpointer(tmp, mgr2, state_dict=dict,
                           load_state_dict=lambda s: got.update(from_transfer_tree(s, mesh)),
                           tag="g0")
    assert ck2.restore() and mgr2.step == 3
    for key in ("w", "b"):
        assert got[key].placements == state[key].placements
        assert torch.equal(got[key].to_local(), state[key].to_local())
        assert torch.equal(got[key].full_tensor(), full[key])
    assert got["lr"] == np.float32(0.5)
    if rank == 0:
        np.savez(os.path.join(tmp, "full.npz"), **{k: v.numpy() for k, v in full.items()})


MODES = {"step": mode_step, "ring": mode_ring, "pipeline": mode_pipeline, "disk": mode_disk, "flatten": mode_flatten, "rebuild": mode_rebuild,
         "full": mode_full, "dense": mode_dense, "place": mode_place}


def main() -> None:
    mode, rank, world, port, tmp, args = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        MODES[mode](rank, world, tmp, json.loads(args))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
