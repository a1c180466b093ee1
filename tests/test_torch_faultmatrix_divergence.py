"""The port's runner on ``corrupt_divergence`` and under a sanitizer, on the
CPU (see ``test_torch_faultmatrix.py``).

``corrupt_divergence``: the sentinel leg latches within one commit of the
corrupted average, the fence leg vetoes it (an abort, identical
checksums), the control leg latches nothing; the JAX checker replays every
leg's trails and boxes.

``--sanitize=asan`` on ``kill_allreduce_cma``: the runner builds the native
core under ASan into the port's build directory, the numpy worker loads it
(``TORCHFT_NATIVE_LIB``, the runtime in ``LD_PRELOAD``), the scenario
passes and no sanitizer report is written. The build takes about two
minutes of one core.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from tests.test_torch_faultmatrix import run_checked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.faultmatrix
def test_scenario(tmp_path):
    res = run_checked("corrupt_divergence", str(tmp_path / "corrupt_divergence"), steps=10,
                      timeout_s=420)
    m = re.search(r"sentinel latched at step (\d+) \(corrupt at (\d+)\)", res.detail)
    assert m and int(m.group(1)) <= int(m.group(2)) + 1, res.detail
    assert res.fired == 2  # one corruption in each injected leg
    assert res.checksums[0] == res.checksums[1]  # the fence leg's


@pytest.mark.faultmatrix
def test_sanitized_kill_allreduce_cma(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.faultinject.runner", "--sanitize=asan",
         "--scenario", "kill_allreduce_cma", "--steps", "10", "--timeout", "420",
         "--outdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "sanitizer: no reports" in proc.stdout
    with open(tmp_path / "faultmatrix.json") as f:
        report = json.load(f)
    assert report["sanitize"] == "asan" and report["sanitizer_reports"] == []
    assert report["conformance"] == "not run"
    (res,) = report["results"]
    assert res["status"] == "passed" and res["respawns"] >= 1 and res["fired"] >= 1
    # every worker incarnation mapped the ASan build, none the plain core
    logs = "".join(open(tmp_path / "kill_allreduce_cma" / f"g{g}.log").read() for g in (0, 1))
    cores = re.findall(r"native core (\S+)", logs)
    assert len(cores) == 3 and all(c.endswith("libtftcore_asan.so") for c in cores), cores
