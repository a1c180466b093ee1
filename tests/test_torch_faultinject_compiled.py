"""Replay the model checker's compiled fault schedules through the port's
runner, as ``tests/test_faultinject_compiled.py`` does through the JAX
runner: the port's copies under ``torchft_tpu_torch/faultinject/compiled/``
run green with ``--device cpu`` workers: each site fires, the victim dies
and respawns, the survivors converge with bit-identical checksums.
Slow-marked as its JAX counterpart: three multi-process scenarios (about a
minute on the CPU)."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


def test_compiled_schedules_replay_green(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.faultinject.runner", "--compiled",
         "--device", "cpu", "--outdir", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fault matrix clean" in proc.stdout
    with open(tmp_path / "faultmatrix.json", encoding="utf-8") as f:
        report = json.load(f)
    by_name = {r["scenario"]: r for r in report["results"]}
    expected = {"compiled_kill_quorum_reply", "compiled_kill_commit_vote",
                "compiled_kill_next_collective"}
    assert expected <= set(by_name), sorted(by_name)
    for name in expected:
        res = by_name[name]
        assert res["status"] == "passed", res
        assert res["fired"] >= 1 and res["respawns"] >= 1, res
