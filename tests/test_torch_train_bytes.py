"""The port's ``train_bytes`` example (the fault matrix's worker) against
``examples/train_bytes.py`` on one corpus, on the CPU.

* Two groups of each package as processes: the committed steps' sample
  indices in each group's TRACE_PATH are the same in both packages, and
  each package's two groups end with one ``param_checksum``.
* The first losses: the JAX example's model and ``optax.adam(1e-3)`` from
  ``init_params(PRNGKey(0))``, and the port's (``bytes_config``,
  ``make_optimizer``, ``TrainStep``) from the same weights carried across by
  ``params_from_jax``, three steps on group 0's batches: losses within
  ``LOSS_RTOL`` (float32; the two packages' matmuls and softmax differ in
  the order of their sums).
* ``tests/test_data_example.py``'s kill-and-restart resume on the port: a
  group SIGKILLed mid-epoch restarts, heals (disk checkpoints are not
  ported: the live heal alone), and the traces show no sample skipped or
  trained twice.
* ``CKPT_DIR``: a group that lost its process resumes from its newest
  checkpoint (traces with no step trained twice, the checksum of a run
  that never stopped); a per-process set whose files disagree raises;
  and the corpus is built from the port's own sources when
  DATA_PATH is absent.
"""

from __future__ import annotations

import glob
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-6
_CHECKSUM = re.compile(r"done: step=(\d+) param_checksum=(-?[\d.]+)")


def _env(extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def _spawn(pkg, gid, lighthouse_addr, tmp, steps, batch, num_groups=2):
    env = _env(dict(REPLICA_GROUP_ID=str(gid), NUM_REPLICA_GROUPS=str(num_groups),
                    STEPS=str(steps), BATCH=str(batch),
                    DATA_PATH=os.path.join(tmp, "corpus.bin"),
                    TRACE_PATH=os.path.join(tmp, f"{pkg}_trace{gid}.jsonl"),
                    TORCHFT_LIGHTHOUSE=lighthouse_addr, JAX_PLATFORMS="cpu", DEVICE="cpu"))
    argv = ([sys.executable, os.path.join(REPO, "examples", "train_bytes.py")] if pkg == "jax"
            else [sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"])
    return subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _trace(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _corpus(tmp, n):
    rng = np.random.default_rng(0)
    with open(os.path.join(tmp, "corpus.bin"), "wb") as f:
        f.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())


def _run_two_groups(pkg, tmp, steps, batch):
    if pkg == "jax":
        from torchft_tpu.coordination import LighthouseServer
    else:
        from torchft_tpu_torch.coordination import LighthouseServer
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    addr = lighthouse.address().split("//", 1)[-1]
    procs = [_spawn(pkg, g, addr, tmp, steps, batch) for g in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
            assert p.returncode == 0, outs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()
    return [_CHECKSUM.findall(o)[-1] for o in outs]


def test_traces_match_the_jax_example_and_groups_end_bit_identical(tmp_path):
    tmp = str(tmp_path)
    _corpus(tmp, 6001)
    steps, batch = 6, 4
    port = _run_two_groups("port", tmp, steps, batch)
    jax = _run_two_groups("jax", tmp, steps, batch)
    assert port[0] == port[1] and port[0][0] == str(steps), port
    assert jax[0] == jax[1], jax
    for g in (0, 1):
        mine = _trace(os.path.join(tmp, f"port_trace{g}.jsonl"))
        theirs = _trace(os.path.join(tmp, f"jax_trace{g}.jsonl"))
        assert mine and mine == theirs, (g, mine, theirs)


def test_first_losses_match_the_jax_example():
    """Three optimizer steps of group 0's batches, no fault tolerance: the
    examples' model and optimizer alone, from one set of weights."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from torchft_tpu.data import DistributedSampler as JaxSampler, step_indices as jax_indices
    from torchft_tpu.models.transformer import TransformerConfig, init_params, loss_fn
    from torchft_tpu_torch.data import DistributedSampler, step_indices
    from torchft_tpu_torch.examples import train_bytes
    from torchft_tpu_torch.models.transformer import params_from_jax
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.utils.tree import tree_leaves

    windows = train_bytes.windows_of(
        np.random.default_rng(1).integers(0, 256, 40 * 128 + 1, dtype=np.uint8).tobytes())
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, head_dim=32,
                            d_ff=352, dtype=jnp.float32)
    jparams = init_params(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(1e-3)
    jstate = opt.init(jparams)
    vg = jax.jit(jax.value_and_grad(lambda p, t: loss_fn(p, t, cfg, None)))
    jsampler = JaxSampler(len(windows), replica_group=0, num_replica_groups=2, shuffle=True,
                          seed=0)

    torch.set_num_threads(1)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ts = TrainStep(train_bytes.bytes_config("cpu"), "cpu")
    topt = train_bytes.make_optimizer(params)
    sampler = DistributedSampler(len(windows), replica_group=0, num_replica_groups=2,
                                 shuffle=True, seed=0)
    jax_losses, port_losses = [], []
    for step in range(3):
        ids = step_indices(sampler, step, 8)
        assert ids.tolist() == jax_indices(jsampler, step, 8).tolist()
        loss, grads = vg(jparams, jnp.asarray(windows[ids], jnp.int32))
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jax_losses.append(float(loss))

        tloss, tgrads = ts.grads(params, torch.from_numpy(windows[ids].astype(np.int64)))
        for p, g in zip(tree_leaves(params), tree_leaves(tgrads)):
            p.grad = g
        topt.step()
        topt.zero_grad(set_to_none=True)
        port_losses.append(float(tloss))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL)
    assert port_losses[2] < port_losses[0]


def test_kill_restart_no_sample_skipped_or_repeated(tmp_path):
    """``tests/test_data_example.py`` on the port, the live heal alone."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.data import DistributedSampler, step_indices
    from torchft_tpu_torch.examples.train_bytes import SEQ

    tmp = str(tmp_path)
    steps, batch = 24, 8
    # epochs roll every 2 steps, so the kill is mid-epoch and the resume
    # crosses epoch boundaries again and again
    _corpus(tmp, 4001)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)
    addr = lighthouse.address().split("//", 1)[-1]
    procs = {}
    try:
        for g in (0, 1):
            procs[g] = _spawn("port", g, addr, tmp, steps, batch)
        victim_trace = os.path.join(tmp, "port_trace1.jsonl")
        deadline = time.time() + 240
        while len(_trace(victim_trace)) < 5:
            assert time.time() < deadline, "the victim never made progress"
            assert procs[0].poll() is None and procs[1].poll() is None
            time.sleep(0.2)
        os.kill(procs[1].pid, signal.SIGKILL)
        procs[1].wait()
        procs[1] = _spawn("port", 1, addr, tmp, steps, batch)
        for g in (0, 1):
            out, _ = procs[g].communicate(timeout=300)
            assert procs[g].returncode == 0, out.decode(errors="replace")[-2000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        lighthouse.shutdown()

    n_windows = (os.path.getsize(os.path.join(tmp, "corpus.bin")) - 1) // SEQ
    by_step = {}
    for g in (0, 1):
        lines = _trace(os.path.join(tmp, f"port_trace{g}.jsonl"))
        assert lines, f"group {g} committed nothing"
        done = [ln["step"] for ln in lines]
        # a step logged twice is a batch trained twice (a resume too early)
        assert len(done) == len(set(done)) and done == sorted(done), (g, done)
        sampler = DistributedSampler(n_windows, replica_group=g, num_replica_groups=2,
                                     shuffle=True, seed=0)
        for ln in lines:
            assert ln["ids"] == step_indices(sampler, ln["step"], batch).tolist(), (
                f"group {g} step {ln['step']}: trained the wrong samples after the resume")
            by_step.setdefault(ln["step"], {})[g] = set(ln["ids"])
    # the survivor covered every step; the victim's one gap is its blackout
    assert {ln["step"] for ln in _trace(os.path.join(tmp, "port_trace0.jsonl"))} == set(
        range(steps))
    for step, groups in by_step.items():
        if len(groups) == 2:
            assert not (groups[0] & groups[1]), f"overlap at step {step}"


def test_ckpt_dir_raises_and_corpus_is_the_ports_sources(tmp_path, monkeypatch):
    """CKPT_DIR is wired (the resume itself: ``test_ckpt_dir_resume_...``);
    what raises is a directory whose newest checkpoint is a complete set of
    per-process files that disagree on the tree's structure: restore
    refuses to pool them, before the first quorum."""
    from torchft_tpu_torch.checkpointing.serialization import save_state
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.examples import train_bytes

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for pidx in (0, 1):
        with open(ckpt / f"group0_step4.proc{pidx}of2.ckpt", "wb") as f:
            save_state({"torchft": {"step": 4, "batches_committed": 4},
                        "user": {f"leaf{pidx}": pidx}}, f)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("REPLICA_GROUP_ID", "0")
    monkeypatch.setenv("NUM_REPLICA_GROUPS", "1")
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", lighthouse.address().split("//", 1)[-1])
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "corpus.bin"))
    monkeypatch.setenv("CKPT_DIR", str(ckpt))
    try:
        with pytest.raises(ValueError, match="disagree on tree structure"):
            train_bytes.main()
    finally:
        lighthouse.shutdown()
    blob = train_bytes.ensure_corpus(str(tmp_path / "corpus.bin"))
    package = os.path.join(REPO, "torchft_tpu_torch")
    files = sorted(glob.glob(os.path.join(package, "**", "*.py"), recursive=True))
    assert blob == b"".join(open(f, "rb").read() for f in files)


def test_ckpt_dir_resume_bit_identical_no_step_twice(tmp_path):
    """``tests/test_resume.py``'s bar on ``train_bytes``: one group trains 6
    steps straight; another trains 3 with a checkpoint every step and a
    fresh process resumes it from the directory alone to step 6. The
    checksums are bit-identical, and the resumed group's trace (TRACE_PATH
    with ``{group}``) holds every step once, with the samples of the
    straight run."""
    from torchft_tpu_torch.coordination import LighthouseServer

    tmp = str(tmp_path)
    _corpus(tmp, 4001)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    addr = lighthouse.address().split("//", 1)[-1]

    def run(name, steps, ckpt):
        env = _env(dict(REPLICA_GROUP_ID="0", NUM_REPLICA_GROUPS="1", STEPS=str(steps),
                        BATCH="4", DATA_PATH=os.path.join(tmp, "corpus.bin"),
                        TRACE_PATH=os.path.join(tmp, name + "_trace{group}.jsonl"),
                        TORCHFT_LIGHTHOUSE=addr, DEVICE="cpu"))
        if ckpt:
            env.update(CKPT_DIR=os.path.join(tmp, "ckpt"), CKPT_EVERY="1")
        proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"],
                              env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        return proc.stdout + proc.stderr

    try:
        straight = run("straight", 6, ckpt=False)
        run("resumed", 3, ckpt=True)
        resumed = run("resumed", 6, ckpt=True)
    finally:
        lighthouse.shutdown()
    assert re.search(r"resumed from .*group0_step3\.ckpt at step 3", resumed), resumed[-2000:]
    sums = [re.search(r"done: step=6 param_checksum=(-?[\d.]+)", t).group(1)
            for t in (straight, resumed)]
    assert sums[0] == sums[1]
    mine = _trace(os.path.join(tmp, "resumed_trace0.jsonl"))
    assert [ln["step"] for ln in mine] == list(range(6))
    assert mine == _trace(os.path.join(tmp, "straight_trace0.jsonl"))


EXIT_RUNS = 6  # three at a time, each on a lighthouse of its own


def test_exits_cleanly_every_time(tmp_path):
    """The worker's end, ``manager.shutdown(wait=False)`` and the
    interpreter's exit, run EXIT_RUNS times: one group of two steps, half of
    the runs with a disk checkpoint every step (``chip_smoke.py`` phase 20
    (b)'s worker). Every run logs ``done:`` and exits 0, with no C++
    ``terminate called`` (a native thread destroyed while still joinable)
    and no fatal Python error."""
    from torchft_tpu_torch.coordination import LighthouseServer

    tmp = str(tmp_path)
    _corpus(tmp, 3001)
    for wave in range(EXIT_RUNS // 3):
        lighthouses = [LighthouseServer(bind="[::]:0", min_replicas=1) for _ in range(3)]
        procs = []
        try:
            for i, lh in enumerate(lighthouses):
                run = 3 * wave + i
                env = _env(dict(REPLICA_GROUP_ID="0", NUM_REPLICA_GROUPS="1", STEPS="2",
                                BATCH="2", DATA_PATH=os.path.join(tmp, "corpus.bin"),
                                TORCHFT_LIGHTHOUSE=lh.address().split("//", 1)[-1],
                                DEVICE="cpu", PYTHONFAULTHANDLER="1"))
                if run % 2:
                    env.update(CKPT_DIR=os.path.join(tmp, f"ckpt{run}"), CKPT_EVERY="1")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torchft_tpu_torch.examples.train_bytes"], env=env,
                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for p in procs:
                out = p.communicate(timeout=120)[0].decode(errors="replace")
                assert p.returncode == 0, (p.returncode, out[-3000:])
                assert "done: step=2" in out, out[-3000:]
                assert "terminate called" not in out and "Fatal Python" not in out, out[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for lh in lighthouses:
                lh.shutdown()
