"""Periodic disk checkpoint -> total failure -> resume, on the port
(``tests/test_resume.py``'s bar): ``torchft_tpu_torch.examples.train_ddp``
as real processes on the CPU.

* A straight 6-step run is the reference; a 3-step run that checkpoints
  every step, then a fresh process resuming to step 6 from the directory
  alone, ends with a bit-identical ``param_checksum`` (params, Adam state
  and sampler position all round-trip), its first committed step being 4.
* The port's 6-step checksum equals the JAX ``examples/train_ddp.py``'s
  within ``CHECKSUM_RTOL`` (float32 Adam; the packages' matmul and softmax
  sums differ in order), run beside it.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading

import pytest

from conftest import scaled_timeout

# multi-process soak tier, as tests/test_resume.py
pytestmark = pytest.mark.soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKSUM_RTOL = 1e-4


def _run(argv, lighthouse_addr, steps, ckpt_dir=None, env_extra=None) -> str:
    env = dict(os.environ)
    env.update(TORCHFT_LIGHTHOUSE=lighthouse_addr, REPLICA_GROUP_ID="0",
               NUM_REPLICA_GROUPS="1", STEPS=str(steps), DEVICE="cpu", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    env.update(env_extra or {})
    if ckpt_dir:
        env.update(CKPT_DIR=str(ckpt_dir), CKPT_EVERY="1")
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=scaled_timeout(180), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stderr + proc.stdout  # logging goes to stderr


def _checksum(log: str):
    m = re.search(r"done: step=(\d+) param_checksum=(-?\d+\.\d+)", log)
    assert m, log[-2000:]
    return m.group(1), m.group(2)


def test_disk_checkpoint_resume_bit_identical_and_as_jax(tmp_path):
    from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
    from torchft_tpu_torch.coordination import LighthouseServer

    port_argv = [sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp"]
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    jax_lighthouse = JaxLighthouse(bind="[::]:0", min_replicas=1)
    jax_log = {}

    def jax_run():
        try:
            jax_log["log"] = _run([sys.executable, os.path.join(REPO, "examples", "train_ddp.py")],
                                  jax_lighthouse.address().split("//", 1)[-1], steps=6)
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            jax_log["error"] = e

    jax_thread = threading.Thread(target=jax_run, name="jax_train_ddp")
    jax_thread.start()
    addr = lighthouse.address().split("//", 1)[-1]
    try:
        ref_step, ref_sum = _checksum(_run(port_argv, addr, steps=6))
        assert ref_step == "6"

        # run to step 3 with per-step checkpoints, "lose everything"
        step3, _ = _checksum(_run(port_argv, addr, steps=3, ckpt_dir=tmp_path))
        assert step3 == "3"
        assert (tmp_path / "group0_step3.ckpt").exists()

        # a fresh process resumes from disk and continues to step 6
        resumed = _run(port_argv, addr, steps=6, ckpt_dir=tmp_path)
        assert "resumed from" in resumed and "at step 3" in resumed
        first_commit = re.search(r"step=(\d+) batches_committed", resumed)
        assert first_commit and first_commit.group(1) == "4", resumed[-2000:]
        end_step, end_sum = _checksum(resumed)
        assert end_step == "6"
        assert end_sum == ref_sum  # bit-identical to the continuous run
    finally:
        jax_thread.join(timeout=scaled_timeout(200))
        lighthouse.shutdown()
        jax_lighthouse.shutdown()
    if "error" in jax_log:
        raise jax_log["error"]
    jax_step, jax_sum = _checksum(jax_log["log"])
    assert jax_step == "6"
    assert float(ref_sum) == pytest.approx(float(jax_sum), rel=CHECKSUM_RTOL)
