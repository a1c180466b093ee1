"""The port's fault matrix as data, against the JAX runner's: the same
scenarios (names, order, environments, schedules, the victim's expected
death, the quick subset), the same compiled descriptors (equal after
loading, and the same scenarios from ``load_compiled_scenarios``), the
same ``--list``; the runner's ``conformance`` hook: without a checker the
report and the printed line say it was not run, a clean checker reads
``clean``, and a finding fails the scenario; and the loader's
``TORCHFT_NATIVE_LIB`` (the sanitizer's hook): the named library is the
one mapped, and a missing file or another ABI fails loudly."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest

from torchft_tpu.faultinject import runner as jax_runner
from torchft_tpu_torch.faultinject import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIELDS = ("name", "victim_env", "survivor_env", "common_env", "victim_schedule",
           "survivor_schedule", "expect_victim_death", "quick")


def _spec(scenarios):
    return [{f: getattr(s, f) for f in _FIELDS} for s in scenarios]


def test_scenarios_equal_the_jax_runners():
    assert _spec(runner.SCENARIOS) == _spec(jax_runner.SCENARIOS)


def test_compiled_descriptors_equal_the_jax_runners():
    mine = sorted(glob.glob(os.path.join(runner.COMPILED_DIR, "*.json")))
    theirs = sorted(glob.glob(os.path.join(jax_runner.COMPILED_DIR, "*.json")))
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
    assert len(mine) == 3
    for a, b in zip(mine, theirs):
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb), a
    assert (_spec(runner.load_compiled_scenarios(runner.COMPILED_DIR))
            == _spec(jax_runner.load_compiled_scenarios(jax_runner.COMPILED_DIR)))


def test_list_names_the_jax_runners_scenarios():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.faultinject.runner",
                           "--list"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = [line.split()[0] for line in proc.stdout.splitlines() if line.strip()]
    assert names == [s.name for s in jax_runner.SCENARIOS]
    quick = [line.split()[0] for line in proc.stdout.splitlines() if "[quick]" in line]
    assert quick == [s.name for s in jax_runner.SCENARIOS if s.quick]


@pytest.mark.parametrize("checker,status,verdict,rc", [
    (None, "passed", "not run", 0),
    (lambda wd: None, "passed", "clean", 0),
    (lambda wd: "illegal transition", "failed", "illegal transition", 1),
], ids=["no-checker", "clean", "finding"])
def test_conformance_hook(tmp_path, monkeypatch, capsys, checker, status, verdict, rc):
    seen = []

    def fake_run(scn, workdir, **kwargs):
        seen.append((scn.name, kwargs["device"]))
        return runner.Result(scn.name, "passed", "stub", fired=1, respawns=1)

    monkeypatch.setattr(runner, "run_scenario", fake_run)
    got = runner.main(["--scenario", "kill_allreduce_cma", "--device", "cpu", "--outdir",
                       str(tmp_path)], conformance=checker)
    assert got == rc and seen == [("kill_allreduce_cma", "cpu")]
    with open(tmp_path / "faultmatrix.json") as f:
        report = json.load(f)
    assert report["conformance"] == ("not run" if checker is None else "checked")
    (res,) = report["results"]
    assert res["status"] == status
    assert res["conformance"] == (verdict if status == "passed" else "not run")
    out = capsys.readouterr().out
    if checker is None:
        assert "conformance not run" in out and "fault matrix clean (conformance not run)" in out
    elif status == "failed":
        assert "spec-conformance violation: illegal transition" in out


def _load_with(lib: str):
    """Load the native core in a fresh process with ``TORCHFT_NATIVE_LIB``
    set; returns the process (its stderr holds the error)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(TORCHFT_NATIVE_LIB=lib, PYTHONPATH=REPO)
    code = ("from torchft_tpu_torch import _native\n"
            "_native.tsdb_reset()\n"
            "import sys\n"
            "maps = open('/proc/self/maps').read()\n"
            "print(sorted({l.split()[-1] for l in maps.splitlines() if 'libtftcore' in l}))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_native_lib_override_loads_that_library():
    """``TORCHFT_NATIVE_LIB`` names the library to map instead of the
    build: a copy of the built core loads, and is the only core mapped."""
    import shutil
    import tempfile

    from torchft_tpu_torch import _native

    with tempfile.TemporaryDirectory() as tmp:
        lib = shutil.copy(_native.build(), os.path.join(tmp, "libtftcore_copy.so"))
        proc = _load_with(lib)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip() == repr([lib])


def test_native_lib_override_missing_or_wrong_abi_fails_loudly(tmp_path):
    proc = _load_with(str(tmp_path / "absent.so"))
    assert proc.returncode != 0 and "TORCHFT_NATIVE_LIB" in proc.stderr
    assert "does not exist" in proc.stderr
    src = tmp_path / "abi.c"
    src.write_text("int tft_abi_version(void) { return 1; }\n")
    lib = tmp_path / "libtftcore_old.so"
    subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    proc = _load_with(str(lib))
    assert proc.returncode != 0 and "reports ABI 1" in proc.stderr, proc.stderr[-2000:]
