"""The fleet plane's bench rows of the port on the CPU, beside the JAX
package's: ``benchmarks/quorum_scale.py`` (quorum fan-out and the full-JSON
and delta telemetry legs against the group count) run through the bench's
own subprocess runner at small N, its row's keys against the JAX harness's
run at the same N; and ``benchmarks/telemetry_overhead.py`` (the headline
loop with the piggyback armed and disarmed) at a tiny model, its row's keys
against the dict the JAX harness returns, parsed from its source. No
timing is asserted: the structure, the counts and the byte legs.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from torchft_tpu_torch import bench, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (2, 4)


def _jax_quorum_scale():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "torchft_tpu.benchmarks.quorum_scale",
                           "--groups", ",".join(map(str, GROUPS)), "--rounds", "2"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    return json.loads(proc.stdout.strip().splitlines()[-1])["quorum_scale"]


def test_quorum_scale_row_carries_the_jax_keys():
    port = bench._run_json_subprocess(
        bench._module("quorum_scale", "--groups", ",".join(map(str, GROUPS)), "--rounds", "2"),
        300)["quorum_scale"]
    ref = _jax_quorum_scale()
    assert set(port) == set(ref)
    for n in GROUPS:
        p, j = port[f"groups_{n}"], ref[f"groups_{n}"]
        assert set(p) == set(j) and set(p["telemetry"]) == set(j["telemetry"])
        assert p["errors"] == 0 and p["fanout_count"] >= n * 2
        tel = p["telemetry"]
        # the delta leg's steady rounds ship less than the full JSON, and its
        # first (full) round more than its steady ones
        assert 0 < tel["delta_bytes_per_step_per_replica"] < tel["full_bytes_per_step_per_replica"]
        assert tel["delta_first_full_bytes_per_replica"] > tel["delta_bytes_per_step_per_replica"]
        # the same synthetic report: the same bytes on both packages' legs
        for key in ("full_bytes_per_step_per_replica", "delta_first_full_bytes_per_replica",
                    "delta_bytes_per_step_per_replica"):
            assert tel[key] == j["telemetry"][key], key


def test_raise_fd_limit_goes_toward_the_hard_limit():
    import resource

    from torchft_tpu_torch.benchmarks.quorum_scale import _raise_fd_limit

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        _raise_fd_limit(soft + 1)
        now = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        assert now == min(hard, soft + 1) or now >= soft
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def _jax_overhead_keys():
    """The keys of the dict ``torchft_tpu/benchmarks/telemetry_overhead.py``'s
    ``measure`` returns, from its source."""
    path = os.path.join(REPO, "torchft_tpu", "benchmarks", "telemetry_overhead.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_telemetry_overhead_row_carries_the_jax_keys(monkeypatch):
    from torchft_tpu_torch.benchmarks import telemetry_overhead
    from torchft_tpu_torch.models.transformer import TransformerConfig

    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("TORCHFT_TELEMETRY_PIGGYBACK", "1")  # restored after the test
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                            d_ff=64, dtype=torch.float32, attention_impl="flash")
    try:
        row = telemetry_overhead.measure(runs=2, steps=2, warmup=1, batch=2, seq=16, cfg=cfg)
    finally:
        telemetry.reset()
    assert set(row) == _jax_overhead_keys()
    assert len(row["runs_armed"]) == len(row["runs_disarmed"]) == 2
    assert row["steps_per_sec"] > 0 and row["steps_per_sec_disarmed"] > 0
    # the armed legs shipped blobs; the disarmed ones none (the counters
    # are reset after the throwaway leg, which ran disarmed)
    assert row["piggyback_bytes"] > 0
    assert row["gate_pct"] == telemetry_overhead.GATE_PCT
    assert row["within_gate"] == (row["overhead_pct"] <= row["gate_pct"])
    assert os.environ["TORCHFT_TELEMETRY_PIGGYBACK"] == "1"


@pytest.mark.parametrize("armed", [True, False])
def test_overhead_legs_switch_the_piggyback(monkeypatch, armed):
    """One leg of each kind: armed, the Manager's quorums carry delta blobs
    (``tft_telemetry_bytes_total{channel="piggyback"}`` grows); disarmed,
    nothing is built."""
    from torchft_tpu_torch.models.transformer import TransformerConfig

    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("TORCHFT_TELEMETRY_PIGGYBACK", "1" if armed else "0")
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, head_dim=16,
                            d_ff=64, dtype=torch.float32, attention_impl="flash")
    telemetry.reset()
    try:
        bench.train_bench(cfg, 2, 16, 2, 1, averaging=True)
        shipped = telemetry.TELEMETRY_BYTES.labels(channel="piggyback").value
    finally:
        telemetry.reset()
    assert (shipped > 0) == armed
