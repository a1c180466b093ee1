"""The port's ``train_hsdp`` example under the port's launcher on the CPU,
one process per in-group rank, gloo inside a group, the Manager's TCP ring
across groups.

* The counterpart of ``tests/test_examples.py::test_hsdp_example_two_groups``:
  two groups of four processes on an (fsdp 2, tp 2) mesh end with one
  checksum on all eight ranks.
* The counterpart of ``tests/test_multihost.py``'s kill, respawn and
  sharded heal: two groups of two processes (fsdp 2); group 1's rank 0
  takes SIGKILL at step 4, the launcher respawns the whole group, whose
  ranks heal from their same-rank peers with the sharded transfer (each
  receives its own shards: fewer bytes than the dense state) and end on
  the survivors' checksum.
* The same kill on two inner meshes of four processes: JAX's ``sp_ring``
  variant (``tests/test_hsdp.py:52``, sp 2 x tp 2, ring attention) and
  pp 2 x tp 2 (the GPipe ring): every rank of both groups ends on one
  checksum, each respawned rank healing its own shards.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 params and the two AdamW moments of the tiny preset, dense
TINY_PARAMS = 64 * 16 + 2 * (2 * 16 + 4 * 16 * 16 + 3 * 16 * 32) + 16 + 16 * 64
DENSE_STATE_BYTES = 3 * 4 * TINY_PARAMS


def _env(**extra):
    env = dict(os.environ, DEVICE="cpu", MODEL="tiny", BATCH="8", SEQ="16", **extra)
    env.pop("TORCHFT_LIGHTHOUSE", None)
    return env


def _wrapper(tmp_path):
    """A worker command whose log file carries the group, the rank and the
    pid (the kill targets one process by its pid)."""
    wrapper = tmp_path / "wrap.sh"
    wrapper.write_text(
        "#!/bin/bash\n"
        f"cd {REPO}\n"
        f"exec {sys.executable} -m torchft_tpu_torch.examples.train_hsdp >> "
        f"{tmp_path}/g${{REPLICA_GROUP_ID}}_r${{RANK}}.$$.log 2>&1\n"
    )
    wrapper.chmod(0o755)
    return str(wrapper)


def _launcher(tmp_path, nproc, env):
    return subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.launcher", "--groups", "2",
         "--nproc", str(nproc), "--", _wrapper(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def _stop(launcher):
    if launcher.poll() is None:
        launcher.send_signal(signal.SIGINT)
        try:
            launcher.wait(timeout=20)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait(timeout=20)


def _checksums(tmp_path):
    sums = []
    for p in sorted(tmp_path.glob("g*_r*.log")):
        found = re.findall(r"param_checksum=(-?\d+\.\d+)", p.read_text())
        if found:
            sums.append(found[-1])
    return sums


def test_hsdp_example_two_groups(tmp_path):
    launcher = _launcher(tmp_path, 4, _env(STEPS="3", FSDP="2", TP="2"))
    try:
        assert launcher.wait(timeout=60) == 0
    finally:
        _stop(launcher)
    sums = _checksums(tmp_path)
    assert len(sums) == 8, sums  # every rank of both groups finished
    assert len(set(sums)) == 1, sums


def test_hsdp_kill_respawn_sharded_heal(tmp_path):
    _kill_respawn_heal(tmp_path, 2, _env(STEPS="12", FSDP="2", TP="1"), budget_s=50)


@pytest.mark.parametrize("axes", [dict(SP="2", TP="2"), dict(PP="2", TP="2")],
                         ids=["sp_ring", "pp2-tp2"])
def test_hsdp_inner_mesh_kill_respawn_heal(tmp_path, axes):
    # eight processes start slower than four on a loaded host
    _kill_respawn_heal(tmp_path, 4, _env(STEPS="10", FSDP="1", **axes), budget_s=120)


def _kill_respawn_heal(tmp_path, nproc, env, budget_s):
    """Group 1's rank 0 takes SIGKILL at step 4 (within ``budget_s``); the
    launcher respawns the group, whose ranks heal their shards and end on
    the survivors' checksum (within ``budget_s`` more)."""
    launcher = _launcher(tmp_path, nproc, env)
    try:
        deadline = time.monotonic() + budget_s
        victim = None
        while victim is None:
            assert time.monotonic() < deadline, "group 1 never reached step 4"
            assert launcher.poll() is None, "launcher died early"
            for p in tmp_path.glob("g1_r0.*.log"):
                if "step=4 " in p.read_text():
                    victim = p
            time.sleep(0.2)
        assert "done:" not in victim.read_text(), "the run outpaced the kill"
        os.kill(int(victim.name.split(".")[1]), signal.SIGKILL)
        assert launcher.wait(timeout=budget_s + 5) == 0
    finally:
        _stop(launcher)

    sums = _checksums(tmp_path)
    # every rank of group 0, and of group 1's respawn (the killed ranks'
    # logs end without a checksum)
    assert len(sums) == 2 * nproc, sums
    assert len(set(sums)) == 1, sums
    respawned = [p for p in tmp_path.glob("g1_r*.log") if "param_checksum" in p.read_text()]
    assert len(respawned) == nproc
    for p in respawned:
        text = p.read_text()
        assert "healing: fetching checkpoint metadata" in text
        healed = [int(n) for n in re.findall(r"healed: mode=\S+ nsources=\d+ bytes=(\d+)", text)]
        # each rank received its own shards, not the gathered state
        assert healed and max(healed) < 0.75 * DENSE_STATE_BYTES, (healed, DENSE_STATE_BYTES)
