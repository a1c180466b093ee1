"""The port's runner on the fleet plane's scenarios (CPU workers, the JAX
checker on every passed workdir; see ``test_torch_faultmatrix.py``):
``straggler_group`` (the runner hosts the straggler detector: one latch on
the skewed group, a clean control soak) and ``diagnose_straggler`` (the
victim's own latch captures exactly one diagnosis bundle with the delay
frame dominant in its native hot stack; the control soak captures none)."""

from __future__ import annotations

import pytest

from tests.test_torch_faultmatrix import run_checked


@pytest.mark.faultmatrix
@pytest.mark.parametrize("name,steps", [("straggler_group", 12), ("diagnose_straggler", 24)])
def test_scenario(tmp_path, name, steps):
    res = run_checked(name, str(tmp_path / name), steps=steps, timeout_s=420)
    assert res.fired >= 1
