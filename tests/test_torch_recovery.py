"""Kill and rejoin for real, on the CPU: ``measure_recovery`` of the port
(``torchft_tpu_torch/benchmarks/recovery.py``) with ``DEVICE=cpu`` and the
tiny transformer. Each group is a worker process training through
``FTTrainer`` on a ``Manager`` over ``CollectivesTcp`` with the HTTP heal;
the last group takes SIGKILL and is respawned.

The default-tier case asserts the mechanism only, so that it holds on a
loaded box: every group exits 0 (``measure_recovery`` raises otherwise),
the survivor commits after the kill, the respawned group heals and
commits, every group ends with one sha256 of params and optimizer state,
and a survivor's eviction report came back accepted (the lighthouse's
5 s lease cannot lapse first).

The ``soak`` cases copy ``tests/test_recovery.py``'s bounds (blackout
under 6 s, rejoin under 20 s, with its 1 s op timeout and 1 s lease) and
its 1-of-4 shape, as the JAX file marks them, with the same mechanism
checks but the eviction's: with a 1 s lease, or with four groups on a
loaded host (a straggler is left out of a quorum at the 100 ms join
timeout, the victim too), the lease can end the victim's membership
before a report lands, and the JAX tests do not ask for one either. A
straggler left out rejoins at the next quorum without failing a step
(``tests/test_torch_death_path.py::test_straggler_rejoins_without_an_op_timeout``).
"""

import os
import subprocess
import sys

import pytest
import torch

from torchft_tpu_torch.benchmarks.recovery import measure_recovery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DEVICE", "cpu")


def _held(r, num_groups, evicted=False):
    assert r.survivor_commits_after_kill > 0, r
    assert r.rejoiner_commits > 0, r
    rejoiner = r.finals[num_groups - 1]
    assert rejoiner["heal"] and rejoiner["heal"]["bytes"] > 0, "the respawned group did not heal"
    assert sorted(r.finals) == list(range(num_groups)), r.finals
    assert len({f["digest"] for f in r.finals.values()}) == 1, "groups ended with different state"
    assert len({f["step"] for f in r.finals.values()}) == 1
    if evicted:
        assert any(ok for _, _, ok in r.evictions), r.evictions


def test_sigkill_and_rejoin(cpu):
    r = measure_recovery(total_steps=16, kill_at_step=5, step_sleep=0.05, op_timeout=5.0,
                         heartbeat_timeout_ms=5000, timeout_s=120.0)
    _held(r, 2, evicted=True)
    assert set(r.as_dict()) >= {"survivor_blackout_s", "rejoin_to_commit_s", "steady_step_s",
                                "blackout_steps", "survivor_steps_lost", "timeout_retries",
                                "deadline_aborts"}
    assert sorted(r.timeout_retries) == sorted(r.deadline_aborts) == [0, 1]
    assert sum(r.rejoin_parts_s.values()) == pytest.approx(r.rejoin_to_commit_s)


def test_kill_waits_for_a_late_group(cpu, monkeypatch):
    """A group that starts 3 s late joins after the first quorums; the
    victim is killed only once every group has committed a step. A kill
    during the late group's first join lands in an open fault of both
    packages (ROADMAP queue 3; held by
    ``tests/test_torch_death_path.py::test_member_dead_before_the_plane_joins_waits_out_the_op_timeout``):
    the quorum counts the victim in a plane it never joins, and the
    survivors wait out the op timeout ("peers never connected")."""
    from torchft_tpu_torch.benchmarks import recovery

    popen = recovery.subprocess.Popen
    delayed = []

    def late_group_1(cmd, env=None, **kwargs):
        if env is not None and env.get("REPLICA_GROUP_ID") == "1" and not delayed:
            delayed.append(True)
            cmd = ["/bin/sh", "-c", 'sleep 3; exec "$0" "$@"', *cmd]
        return popen(cmd, env=env, **kwargs)

    monkeypatch.setattr(recovery.subprocess, "Popen", late_group_1)
    # the two others take about 75 steps while group 1 starts: the kill
    # must come well before the last step. The harness's lighthouse waits
    # 1 s for a straggler with three groups (recovery.JOIN_TIMEOUT_MANY_MS):
    # a step longer than the join timeout, as on a loaded host, may keep
    # three groups from ever taking part in one quorum again (queue 3 of
    # ROADMAP.md)
    r = measure_recovery(total_steps=150, kill_at_step=4, step_sleep=0.05, op_timeout=5.0,
                         heartbeat_timeout_ms=5000, timeout_s=120.0, num_groups=3)
    assert delayed
    _held(r, 3)
    victim = recovery._read_events(r.log_paths[2])
    respawn = [e for e in victim if e["event"] == "start"][1]
    late_first = next(e for e in recovery._read_events(r.log_paths[1]) if e["event"] == "commit")
    assert late_first["t"] < respawn["t"], (late_first, respawn)
    assert not any(r.timeout_retries.values()) and not any(r.deadline_aborts.values())


def test_participants_read_survives_a_quorum_timeout():
    """The worker reads the step's participants after the step; an early
    re-quorum whose deadline passes there reads as None instead of ending
    the worker (a loaded 1-of-4 CPU run lost a survivor to it)."""
    from torchft_tpu_torch.benchmarks import recovery

    class Stub:
        def __init__(self, times_out):
            self.times_out = times_out

        def num_participants(self):
            if self.times_out:
                raise TimeoutError("mgr.quorum: mgr.quorum response truncated/timed out")
            return 3

    assert recovery._participants(Stub(False)) == 3
    assert recovery._participants(Stub(True)) is None


def test_cleanup_ends_when_a_server_shutdown_blocks():
    """The harness's cleanup waits a bounded time for its servers: one
    whose shutdown never returns (a store's did once, ROADMAP queue 3)
    is left behind, and the others still shut down."""
    import threading
    import time

    from torchft_tpu_torch.benchmarks import recovery

    release = threading.Event()
    done = []

    class Blocked:
        def shutdown(self):
            release.wait()

    class Quick:
        def shutdown(self):
            done.append(True)

    t0 = time.monotonic()
    try:
        assert recovery._shutdown_bounded([Blocked(), Quick()], timeout_s=0.5) == 1
        assert time.monotonic() - t0 < 5.0
        assert done == [True]
    finally:
        release.set()


def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("only meaningful where CUDA is absent")
    monkeypatch.delenv("DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_recovery()
    env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    env.update(PYTHONPATH=REPO, TORCHFT_EVENT_LOG=str(tmp_path / "g0.jsonl"),
               REPLICA_GROUP_ID="0", NUM_REPLICA_GROUPS="2", TORCHFT_BENCH_STEPS="1",
               TORCHFT_BENCH_OP_TIMEOUT="1")
    proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.benchmarks.recovery"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.soak
def test_recovery_envelope(cpu):
    r = measure_recovery(total_steps=25, kill_at_step=6, step_sleep=0.05, op_timeout=1.0,
                         heartbeat_timeout_ms=1000, timeout_s=120.0)
    _held(r, 2)
    assert r.survivor_blackout_s < 6.0, r
    assert r.rejoin_to_commit_s < 20.0, r
    assert r.steady_step_s > 0


@pytest.mark.soak
def test_recovery_1of4_north_star_shape(cpu):
    """Three survivors keep committing through the blackout; the fourth
    group rejoins and commits."""
    r = measure_recovery(total_steps=25, kill_at_step=6, step_sleep=0.05, op_timeout=1.0,
                         heartbeat_timeout_ms=1000, timeout_s=120.0, num_groups=4)
    _held(r, 4)
    assert r.survivor_blackout_s < 6.0, r
    assert r.rejoin_to_commit_s < 20.0, r
