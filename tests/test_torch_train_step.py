"""The compiled step: ``TrainStep`` replayed from CUDA graphs against the
eager one.

On the CPU the step is eager (``graph=None``), ``graph=True`` raises, and
the flash launch counts route a call made on a capturing stream to the
graph's recorder. The card-only cases (marker ``cuda``; run with
``python -m pytest --noconftest -m cuda tests/test_torch_train_step.py``)
hold the graphed step to the eager one bit for bit at a small bf16 config
(losses and params after 3 steps: the replays run the kernels the eager
step launches, on the same inputs), the flash launches per step under each
``remat`` policy, a heal into a trainer whose graphs were captured, a
capture that fails, and captures beside another thread's device syncs.
"""

import threading
import types

import numpy as np
import pytest
import torch

from torchft_tpu_torch.models.transformer import TransformerConfig
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.parallel import train_step
from torchft_tpu_torch.parallel.train_step import StepGraphs, TrainStep, synchronize
from torchft_tpu_torch.utils.tree import tree_leaves, tree_map

CPU_CFG = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                            d_ff=64, dtype=torch.float32, attention_impl="plain")
# a small bf16 config the kernels take (head dim 64, S a multiple of 64)
CARD_CFG = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, head_dim=64,
                             d_ff=256, dtype=torch.bfloat16, attention_impl="flash")


def test_cpu_step_is_eager_and_graph_true_raises():
    assert TrainStep(CPU_CFG, device="cpu").graphs is None
    assert TrainStep(CPU_CFG, device="cpu", graph=False).graphs is None
    with pytest.raises(ValueError, match="CUDA"):
        TrainStep(CPU_CFG, device="cpu", graph=True)
    opt = TrainStep(CPU_CFG, device="cpu").init_opt(
        TrainStep(CPU_CFG, device="cpu").init_params(0))
    assert not opt.param_groups[0]["capturable"]


def test_launches_on_a_capturing_stream_go_to_its_recorder():
    """A call made on the stream being captured counts for the graph, not
    in LAUNCHES; the owner adds the recorded counts once per replay."""
    fa.reset_launches()
    capturing = types.SimpleNamespace(cuda_stream=0x1234)
    with fa.recorded_launches(capturing) as rec:
        fa._count_launch("flash_fwd", 0x1234)
        fa._count_launch("flash_fwd", 0x1234)
        fa._count_launch("flash_dq", 0x1234)
        fa._count_launch("flash_fwd", 0x9999)  # another stream: a real launch
    assert rec == {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 0}
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0}
    fa._count_launch("flash_dkv", 0x1234)  # the capture ended
    fa.add_launches(rec)
    fa.add_launches(rec)
    assert fa.LAUNCHES == {"flash_fwd": 5, "flash_dq": 2, "flash_dkv": 1}
    fa.reset_launches()


def test_synchronize_waits_for_a_capture():
    """A device-wide sync from another thread waits while a capture holds
    the process's capture lock (CUDA fails a capture when the device is
    synchronized during it), and goes on once the capture is done."""
    done = threading.Event()

    def sync():
        synchronize("cpu")
        done.set()

    with train_step._CAPTURE_LOCK:
        th = threading.Thread(target=sync)
        th.start()
        assert not done.wait(timeout=0.2)
    assert done.wait(timeout=10)
    th.join()


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _tokens(cfg, seed, batch=2, seq=256):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).cuda()


def _run(cfg, graph, steps=3):
    ts = TrainStep(cfg, device="cuda", graph=graph)
    params = ts.init_params(0)
    opt = ts.init_opt(params)
    losses = []
    for i in range(steps):
        loss, params, opt = ts.step(params, opt, _tokens(cfg, i % 2))
        losses.append(float(loss))
    torch.cuda.synchronize()
    return ts, params, opt, losses


@pytest.mark.cuda
def test_graphed_step_matches_eager_bitwise():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, p_eager, _, l_eager = _run(CARD_CFG, graph=False)
    ts, p_graph, opt, l_graph = _run(CARD_CFG, graph=True)
    assert ts.graphs.captures == {"grads": 1, "apply": 1}  # one token shape
    assert l_graph == l_eager and all(np.isfinite(l_graph))
    for a, b in zip(tree_leaves(p_graph), tree_leaves(p_eager)):
        assert torch.equal(a, b)
    assert all(opt.state[p]["step"].is_cuda for p in tree_leaves(p_graph))


@pytest.mark.cuda
@pytest.mark.parametrize("remat,policy,fwd", [(True, "all", 2), (True, "dots", 2),
                                              (False, "all", 1)],
                         ids=["all", "dots", "no-remat"])
def test_graphed_launches_per_policy(remat, policy, fwd):
    """Launches per replayed step: the forward's K1 and, under remat, the
    recompute's; one K2 and one K3 per layer."""
    _need_card()
    import dataclasses

    cfg = dataclasses.replace(CARD_CFG, remat=remat, remat_policy=policy)
    ts = TrainStep(cfg, device="cuda")
    params = ts.init_params(0)
    opt = ts.init_opt(params)
    tokens = _tokens(cfg, 0)
    ts.step(params, opt, tokens)  # runs eagerly, then captures
    fa.reset_launches()
    for _ in range(3):
        ts.step(params, opt, tokens)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert fa.LAUNCHES == {"flash_fwd": 3 * fwd * n, "flash_dq": 3 * n, "flash_dkv": 3 * n}


@pytest.mark.cuda
def test_heal_into_graphed_trainer():
    """A state loaded into a trainer whose graphs were captured lands in
    the captured tensors: the next replays continue the sender's run bit
    for bit, with no new capture."""
    _need_card()
    from unittest.mock import MagicMock

    from torchft_tpu_torch.parallel.ft import FTTrainer

    def trainer(seed, steps):
        t = FTTrainer(MagicMock(), TrainStep(CARD_CFG, device="cuda"))
        t.init(seed=seed)
        for i in range(steps):
            _, grads = t._ts.grads(t.params, _tokens(CARD_CFG, 0))
            t._ts.apply(t.params, t.opt, grads)
        return t

    sender, receiver = trainer(1, 3), trainer(2, 2)
    captured = dict(receiver._ts.graphs.captures)
    state = tree_map(lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
                     sender.state_dict())
    receiver.load_state_dict(state)
    for t in (sender, receiver):
        _, grads = t._ts.grads(t.params, _tokens(CARD_CFG, 0))
        t._ts.apply(t.params, t.opt, grads)
    torch.cuda.synchronize()
    assert receiver._ts.graphs.captures == captured
    for a, b in zip(tree_leaves(receiver.params), tree_leaves(sender.params)):
        assert torch.equal(a, b)
    for p, q in zip(tree_leaves(receiver.params), tree_leaves(sender.params)):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(receiver.opt.state[p][k], sender.opt.state[q][k])


@pytest.mark.cuda
def test_failed_capture_raises():
    """A function that syncs with the host cannot be captured: the call
    raises, it does not fall back to running eagerly."""
    _need_card()
    graphs = StepGraphs(torch.device("cuda"))
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        graphs.run(lambda y: [y * float(y.sum())], [], [x])
    assert graphs.captures["grads"] == 0


@pytest.mark.cuda
def test_device_sync_beside_captures():
    """One thread captures again and again (new params: the gradient graph;
    a new optimizer: the update's) while another synchronizes the device
    through ``synchronize`` in a loop: no capture fails and no sync
    raises. Without the lock the two collide, as two replica groups did."""
    _need_card()
    ts = TrainStep(CARD_CFG, device="cuda")
    tokens = _tokens(CARD_CFG, 0)
    done, errors, syncs = threading.Event(), [], [0]

    def syncer():
        try:
            while not done.is_set():
                synchronize()
                syncs[0] += 1
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    th = threading.Thread(target=syncer)
    th.start()
    try:
        for seed in range(6):
            params = ts.init_params(seed)
            _, grads = ts.grads(params, tokens)
            for _ in range(3):
                ts.apply(params, ts.init_opt(params), grads)
        torch.cuda.current_stream().synchronize()
    finally:
        done.set()
        th.join()
    assert not errors
    assert syncs[0] > 0
    assert ts.graphs.captures == {"grads": 6, "apply": 18}
