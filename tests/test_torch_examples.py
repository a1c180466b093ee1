"""The port's examples under its launcher on the CPU, against the JAX
package's (``tests/test_examples.py:85``).

* DiLoCo with 4 groups (``train_diloco``, 2 outer steps of 2 inner AdamW
  steps, every quorum all 4 groups: the launcher's lighthouse asks for
  ``--groups`` replicas): every group ends with one checksum, and it equals
  the JAX example's, run beside it under the JAX launcher, within
  ``CHECKSUM_RTOL`` (float32 AdamW and Nesterov SGD; the packages' sums
  differ in order).
* ``train_ddp`` with 2 groups under ``python -m torchft_tpu_torch.launcher``:
  both groups end at the step asked with one checksum.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from conftest import scaled_timeout

# multi-process soak tier, as tests/test_examples.py
pytestmark = pytest.mark.soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKSUM_RTOL = 1e-4
_DONE = re.compile(r"done: (?:outer_)?step=(\d+) param_checksum=(-?\d+\.\d+)")


def _launch(argv, env_extra, log_dir):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", DEVICE="cpu", **env_extra)
    proc = subprocess.run(argv, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=scaled_timeout(240))
    texts = ({p.name: p.read_text(errors="replace") for p in sorted(log_dir.iterdir())}
             if log_dir is not None else {"launcher": proc.stdout + proc.stderr})
    assert proc.returncode == 0, (proc.stderr[-2000:], {k: v[-1000:] for k, v in texts.items()})
    return texts


def _done(texts):
    out = []
    for text in texts.values():
        out += _DONE.findall(text)
    return out


def test_diloco_four_groups_as_jax(tmp_path):
    env = {"OUTER_STEPS": "2", "SYNC_EVERY": "2"}
    port_logs = tmp_path / "port"
    port_argv = [sys.executable, "-m", "torchft_tpu_torch.launcher", "--groups", "4",
                 "--max-restarts", "0", "--log-dir", str(port_logs), "--",
                 sys.executable, "-m", "torchft_tpu_torch.examples.train_diloco"]
    jax_argv = [sys.executable, "-m", "torchft_tpu.launcher", "--groups", "4",
                "--max-restarts", "0", "--", sys.executable,
                os.path.join(REPO, "examples", "train_diloco.py")]
    with ThreadPoolExecutor(max_workers=2) as pool:
        port_f = pool.submit(_launch, port_argv, env, port_logs)
        jax_f = pool.submit(_launch, jax_argv, env, None)
        port, jax = _done(port_f.result()), _done(jax_f.result())
    assert len(port) == 4 and len(jax) == 4, (port, jax)
    assert {s for s, _ in port} == {"2"} and {s for s, _ in jax} == {"2"}
    # the pseudogradients were averaged across all 4 groups: one outer state
    assert len({c for _, c in port}) == 1, port
    assert len({c for _, c in jax}) == 1, jax
    assert float(port[0][1]) == pytest.approx(float(jax[0][1]), rel=CHECKSUM_RTOL)


def test_train_ddp_two_groups_under_the_launcher(tmp_path):
    logs = tmp_path / "logs"
    texts = _launch([sys.executable, "-m", "torchft_tpu_torch.launcher", "--groups", "2",
                     "--max-restarts", "0", "--log-dir", str(logs), "--",
                     sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp"],
                    {"STEPS": "4"}, logs)
    done = _done(texts)
    assert len(done) == 2 and {s for s, _ in done} == {"4"}, done
    assert len({c for _, c in done}) == 1, done
