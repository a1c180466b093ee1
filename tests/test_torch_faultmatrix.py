"""The port's fault-injection runner on the CPU, as ``tests/test_faultinject.py``'s
``TestFaultMatrix`` runs the JAX runner: ``DEVICE=cpu`` workers of the
port's ``train_bytes`` example, each scenario ``passed``, and each passed
workdir replayed through the JAX package's protocol checker
(``torchft_tpu.analysis.protocol.check_tree``) on the test side, through the
runner's ``conformance`` hook. The scenarios are spread over files
(``--dist loadfile`` gives a file to one worker): this file holds the
quick kill and torn-pull cases; ``test_torch_faultmatrix_fleet.py`` the
straggler and diagnosis legs, ``test_torch_faultmatrix_perf.py`` the
perf-regression legs, ``test_torch_faultmatrix_divergence.py`` the
sentinel's three legs and the sanitized run.
"""

from __future__ import annotations

from typing import Optional

import pytest

from torchft_tpu_torch.faultinject import runner


def jax_conformance(workdir: str) -> Optional[str]:
    """The JAX checker over a workdir's trails and black boxes: None when
    every transition is legal, else the rendered findings."""
    from torchft_tpu.analysis.protocol import check_tree

    rep = check_tree(workdir)
    return None if rep.ok else rep.render()


def run_checked(name: str, workdir: str, steps: int, timeout_s: float):
    """One scenario through the runner on the CPU, replayed by the checker;
    an environmental run (the documented corruption, no evidence) skips as
    the JAX matrix does."""
    scn = {s.name: s for s in runner.SCENARIOS}[name]
    res, verdict = runner.run_one(scn, workdir, steps, timeout_s, device="cpu",
                                  conformance=jax_conformance)
    if res.status == "environmental":
        pytest.skip(f"documented environmental corruption: {res.detail}")
    assert res.status == "passed", res
    assert verdict == "clean", verdict
    return res


@pytest.mark.faultmatrix
@pytest.mark.parametrize("name", ["torn_cma_pull", "kill_allreduce_cma", "ckpt_serve_death"])
def test_scenario(tmp_path, name):
    res = run_checked(name, str(tmp_path / name), steps=10, timeout_s=420)
    # the runner holds the respawn a kill scenario expects; the victim of a
    # torn pull survives
    assert res.fired >= 1 and (res.respawns == 0) == (name == "torn_cma_pull")
