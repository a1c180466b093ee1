"""The port's step-anatomy ledger against the JAX package's.

The same record / tick sequences go into ``torchft_tpu.telemetry.anatomy``
and the port's copy under one injected clock (``time.perf_counter``
patched to a counter the test advances): their rows, summaries, dumps,
heal-stage and wire-stage views are equal. ``merge_lathist`` and
``lathist_quantile`` agree exactly on random histograms of both wire
shapes, and the log2 grid is the native core's. Then the port's runtime
feeds its ledger: a one-group FT run on each plane on the CPU, every row
summing to its wall clock, and the bench's ``step_anatomy`` row with the
JAX row's keys.
"""

import ast
import os
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

from torchft_tpu import telemetry as J
from torchft_tpu.telemetry import anatomy as JA
from torchft_tpu_torch import telemetry as P
from torchft_tpu_torch.telemetry import anatomy as PA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr("time.perf_counter", c)
    return c


def _drive(pkg_anatomy, clock, script):
    """Run ``script`` (a list of ("record", phase, s, wire_total) /
    ("heal", stage, s) / ("advance", s) / ("tick", step) / ("thread",
    phase, s)) on a fresh ledger; returns (ticks, dump, summary,
    heal stages, wire stages)."""
    led = pkg_anatomy.StepLedger(window=8)
    clock.t = 1000.0
    ticks = []
    for op in script:
        kind = op[0]
        if kind == "record":
            led.record(op[1], op[2], wire_total=op[3])
        elif kind == "thread":
            # a record_wire_stage from another thread: totals only
            th = threading.Thread(target=led.record, args=(op[1], op[2]),
                                  kwargs={"wire_total": True})
            th.start()
            th.join()
        elif kind == "heal":
            led.record_heal_stage(op[1], op[2])
        elif kind == "advance":
            clock.t += op[1]
        elif kind == "tick":
            ticks.append(led.tick(op[1]))
    return (ticks, led.dump(), led.summary(), led.heal_stage_snapshot(),
            led.wire_stage_snapshot(), led.local_p50(), led.last_row())


def _script(seed):
    rng = np.random.default_rng(seed)
    out = [("tick", 0)]
    for step in range(1, 13):
        wall = float(rng.uniform(0.02, 0.08))
        spent = 0.0
        for phase in ("compute", "host_copy", "quantize", "wire", "quorum_wait",
                      "commit_barrier", "heal"):
            if rng.random() < 0.6:
                s = float(rng.uniform(0.0, wall / 9))
                spent += s
                out.append(("record", phase, s, phase in JA.WIRE_STAGES and rng.random() < 0.5))
        if rng.random() < 0.3:
            out.append(("thread", "wire", float(rng.uniform(0.0, 0.01))))
        if rng.random() < 0.2:
            out.append(("heal", str(rng.choice(["meta", "recv", "decode", "device_put"])),
                        float(rng.uniform(0.0, 0.1))))
        if step == 7:
            # phases that overlap the boundary: idle clamps at 0
            out.append(("record", "compute", wall * 2, False))
        out.append(("advance", wall))
        out.append(("tick", step))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_matches_jax_under_an_injected_clock(clock, seed):
    script = _script(seed)
    ref = _drive(JA, clock, script)
    got = _drive(PA, clock, script)
    assert got == ref
    ticks = got[0]
    assert ticks[0] is None and len(ticks) == 13
    for row in ticks[1:]:
        if row["step"] != 7:
            assert sum(row["phases"].values()) == pytest.approx(row["wall_s"], abs=1e-12)


def test_outlier_digest_rides_the_summary(clock):
    """The Manager attaches its StepTimer; both packages' summaries carry
    the same tagged-outlier digest."""
    from torchft_tpu.profiling import StepTimer as JTimer
    from torchft_tpu_torch.profiling import StepTimer as PTimer

    out = []
    for anatomy, timer_cls in ((JA, JTimer), (PA, PTimer)):
        clock.t = 50.0
        led, timer = anatomy.StepLedger(), timer_cls(record_metrics=False)
        led.attach_timer(timer)
        for i in range(6):
            if i == 2:
                timer.mark_quorum()
            if i == 4:
                timer.mark_heal()
            clock.t += 0.01 * (i + 1)
            timer.tick()
            led.record("compute", 0.001)
            led.tick(i)
        out.append((led.summary(), timer.steps_per_sec(), timer.steps_per_sec_all(),
                    timer.outliers()))
    assert out[0] == out[1]
    assert [o["tags"] for o in out[1][0]["outliers"]] == [["quorum"], ["heal"]]


def _hist(rng, n, sum_key):
    counts = [int(x) for x in rng.integers(0, 50, n)]
    h = {"counts": counts, "count": sum(counts)}
    ns = int(rng.integers(0, 10**12))
    if sum_key == "sum_ns":
        h["sum_ns"] = ns
    else:
        h["sum_s"] = ns / 1e9
    return h


@pytest.mark.parametrize("seed", range(4))
def test_lathist_merge_and_quantiles_match_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    n = len(PA.LOG2_BUCKETS) + 1
    a = {op: _hist(rng, n, "sum_ns") for op in ("dp.hop", "rpc.serve", "quorum.fanout")}
    b = {op: _hist(rng, n, "sum_s") for op in ("dp.hop", "dp.stripe")}
    merged = PA.merge_lathist(a, b)
    assert merged == JA.merge_lathist(a, b)
    for h in merged.values():
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert PA.lathist_quantile(h, q) == JA.lathist_quantile(h, q)
    bad = {"dp.hop": {"counts": [1, 2], "count": 3, "sum_ns": 5}}
    for mod in (PA, JA):
        with pytest.raises(ValueError, match="bucket count mismatch"):
            mod.merge_lathist(a, bad)


def test_log2_grid_is_the_native_cores():
    from torchft_tpu_torch import _native

    assert PA.LOG2_BUCKETS == JA.LOG2_BUCKETS == _native.LATHIST_BOUNDS_S
    assert (PA.PHASES, PA.WIRE_STAGES, PA.BARRIER_PHASES) == (
        JA.PHASES, JA.WIRE_STAGES, JA.BARRIER_PHASES)
    snap = _native.lathist_snapshot()
    assert set(snap) >= {"dp.hop", "dp.stripe", "rpc.serve", "quorum.fanout"}
    assert all(len(h["counts"]) == len(PA.LOG2_BUCKETS) + 1 for h in snap.values())


def test_wire_stage_shim_matches_jax():
    from torchft_tpu.collectives import record_wire_stage as jrec
    from torchft_tpu.collectives import wire_stage_snapshot as jsnap
    from torchft_tpu_torch.collectives import record_wire_stage as prec
    from torchft_tpu_torch.collectives import wire_stage_snapshot as psnap

    for rec, snap in ((jrec, jsnap), (prec, psnap)):
        snap(reset=True)
        rec("host_copy", 0.25)
        rec("wire", 0.5)
        th = threading.Thread(target=rec, args=("dequant_reduce", 0.125))
        th.start()
        th.join()
    assert psnap() == jsnap() == {"host_copy": 0.25, "wire": 0.5, "dequant_reduce": 0.125}
    assert (P.WIRE_STAGE_SECONDS.labels(stage="wire").value
            == J.WIRE_STAGE_SECONDS.labels(stage="wire").value == 0.5)
    # the op-thread record stays out of the step row on both
    for led in (P.LEDGER, J.LEDGER):
        assert "dequant_reduce" not in led._interval


# ---------------------------------------------------------------------------
# the port's runtime feeding its ledger
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)


def _one_group_run(plane, steps=6):
    """One group on the CPU through FTTrainer on ``plane``; returns the
    ledger's rows (unrounded) and its summary."""
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.collectives_device import CollectivesDevice
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.transformer import TransformerConfig
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep
    from torchft_tpu_torch.store import StoreServer

    timeout = timedelta(seconds=30)
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    store = StoreServer()
    coll = (CollectivesDevice(timeout=timeout, device="cpu") if plane == "device"
            else CollectivesTcp(timeout=timeout, native_plane=True))
    manager = Manager(collectives=coll, load_state_dict=None, state_dict=None,
                      min_replica_size=1, replica_id=f"anatomy_{plane}",
                      store_addr=store.address(), rank=0, world_size=1,
                      lighthouse_addr=lighthouse.address(), timeout=timeout,
                      checkpoint_transport=HTTPTransport(timeout=timeout, hostname="localhost"))
    try:
        cfg = TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
        trainer = FTTrainer(manager, TrainStep(cfg, device="cpu"))
        trainer.init(seed=0)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 128)))
        P.reset()
        for _ in range(steps):
            assert trainer.step(tokens)[1]
        with P.LEDGER._lock:
            rows = [dict(r) for r in P.LEDGER._rows]
        return rows, P.LEDGER.summary()
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


@pytest.mark.parametrize("plane", ["device", "tcp"])
def test_one_group_rows_sum_to_wall(plane):
    rows, summary = _one_group_run(plane)
    assert len(rows) == 5 and summary["steps"] == 5
    for r in rows:
        assert sum(r["phases"].values()) == pytest.approx(r["wall_s"], rel=1e-9, abs=1e-12)
        assert {"compute", "commit_barrier", "wire"} <= set(r["phases"]), r
    if plane == "tcp":
        # the bucket staging and the wait on the averaged buckets
        assert all("host_copy" in r["phases"] for r in rows)
    assert [r["step"] for r in rows] == list(range(1, 6))


def _jax_row_keys():
    """The keys of the JAX bench's step_anatomy row (``bench.py``: the dict
    literal that carries ``_gate_presence``, and ``native_latency``)."""
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "_gate_presence" in keys and "reconciliation_pct" in keys:
                return keys | {"native_latency"}
    raise AssertionError("bench.py has no step_anatomy row")


def test_bench_step_anatomy_row_has_the_jax_rows_keys(monkeypatch):
    from torchft_tpu_torch import bench
    from torchft_tpu_torch.models.transformer import TransformerConfig

    monkeypatch.setenv("DEVICE", "cpu")
    cfg = TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    P.reset()
    for averaging in (True, False):
        bench.train_bench(cfg, 2, 128, steps=4, warmup=1, averaging=averaging)
    row = bench.step_anatomy_row()
    assert set(row) == _jax_row_keys()
    assert row["steps"] == 9
    assert set(row["phases"]) >= {"compute", "commit_barrier", "idle"}
    assert row["reconciliation_pct"] is not None
    assert set(row["native_latency"]) >= {"quorum.fanout", "rpc.serve"}
    summary = P.summary()
    assert summary["quorums"] == 10 and summary["commits"]["committed"] == 10
