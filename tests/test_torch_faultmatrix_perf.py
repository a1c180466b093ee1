"""The port's runner on ``perf_regression`` (CPU workers, the JAX checker
on the passed workdir; see ``test_torch_faultmatrix.py``): the runner hosts
the regression sentinel and the critical-path monitor over the live
lighthouse's ``/timeseries.json``; the control soak latches nothing, the
mid-run onset latches on the delayed group within K commits with >=80% of
the blame on it, and the kill/respawn leg's history is still served."""

from __future__ import annotations

import pytest

from tests.test_torch_faultmatrix import run_checked


@pytest.mark.faultmatrix
def test_scenario(tmp_path):
    res = run_checked("perf_regression", str(tmp_path / "perf_regression"), steps=16,
                      timeout_s=600)
    assert res.fired >= 1
