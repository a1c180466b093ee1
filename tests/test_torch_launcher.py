"""The port's launcher and Kubernetes manifests against the JAX package's:
the cases of ``tests/test_launcher.py`` on ``torchft_tpu_torch.launcher`` and
``torchft_tpu_torch.k8s``, and ``tests/test_multihost.py:176``'s two groups
of two processes on ``torch.distributed``.

* ``launch``: a clean run, a restart on failure, restart exhaustion, the
  "too few peers left to re-quorum" exit (no respawn, exit 1), the env
  contract (``MASTER_ADDR`` / ``MASTER_PORT`` fresh per group and per
  incarnation for ``--nproc 2``, none for one process), ``--log-dir``, and
  ``--shared-runtime`` refused with a message naming queue 1 item 6.
* The k8s apply / status / down round trip against a fake ``kubectl``;
  ``k8s_worker`` hosting the store; the emitted manifests equal the JAX
  ones once the module names are mapped and the accelerator lines (the JAX
  GKE TPU node selector; the port's ``nvidia.com/gpu`` limit and product
  selector) are taken out.
* Two groups of two ``train_ddp`` processes under the launcher on the CPU:
  ``initialize_group()`` forms each group over gloo, a Manager per rank
  spans the groups, and all four processes end with one checksum.
"""

from __future__ import annotations

import json
import os
import re
import sys

import pytest

from conftest import scaled_timeout
from torchft_tpu_torch.launcher import k8s_worker, launch, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_clean_run():
    code = launch([sys.executable, "-c", "import sys; sys.exit(0)"], num_groups=2, nproc=1,
                  lighthouse_addr="localhost:1")  # unused by the trivial cmd
    assert code == 0


def test_restart_on_failure(tmp_path):
    # the first run of group 0 fails (marker absent), the restart succeeds
    marker = tmp_path / "marker"
    script = (
        "import os, sys\n"
        f"m = {str(marker)!r} + os.environ['REPLICA_GROUP_ID']\n"
        "if os.environ['REPLICA_GROUP_ID'] == '0' and not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(3)\n"
        "sys.exit(0)\n"
    )
    code = launch([sys.executable, "-c", script], num_groups=2, nproc=1,
                  lighthouse_addr="localhost:1", max_restarts=2)
    assert code == 0
    assert (tmp_path / "marker0").exists()


def test_restart_exhaustion():
    code = launch([sys.executable, "-c", "import sys; sys.exit(2)"], num_groups=1, nproc=1,
                  lighthouse_addr="localhost:1", max_restarts=1)
    assert code == 1


def test_too_few_peers_left_exits_without_respawn(tmp_path):
    """With the launcher's own lighthouse, a group that dies after its
    peers finished can never re-quorum: no respawn, and exit 1."""
    script = (
        "import os, sys, time\n"
        f"open(os.path.join({str(tmp_path)!r}, 'run' + os.environ['REPLICA_GROUP_ID'] + "
        "'_' + str(os.getpid())), 'w').close()\n"
        "if os.environ['REPLICA_GROUP_ID'] == '1':\n"
        "    time.sleep(2.0)\n"
        "    sys.exit(5)\n"
        "sys.exit(0)\n"
    )
    code = launch([sys.executable, "-c", script], num_groups=2, nproc=1, max_restarts=5)
    assert code == 1
    runs = sorted(p.name.split("_")[0] for p in tmp_path.iterdir())
    assert runs == ["run0", "run1"]  # group 1 ran once: never respawned


def test_env_contract_and_log_dir(tmp_path):
    """Every worker gets the contract; a multi-process group a fresh
    rendezvous endpoint per incarnation, shared by its ranks and by no
    other group; ``--log-dir`` keeps each incarnation's output apart."""
    keys = ("TORCHFT_LIGHTHOUSE", "TORCHFT_STORE_ADDR", "REPLICA_GROUP_ID",
            "NUM_REPLICA_GROUPS", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    script = (
        "import json, os, sys\n"
        f"keys = {keys!r}\n"
        "env = {k: os.environ.get(k) for k in keys}\n"
        "print('ENV ' + json.dumps(env), flush=True)\n"
        f"m = os.path.join({str(tmp_path)!r}, 'failed' + env['REPLICA_GROUP_ID'] + env['RANK'])\n"
        "if env['REPLICA_GROUP_ID'] == '1' and env['RANK'] == '1' and not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(4)\n"
    )
    logs = tmp_path / "logs"
    code = launch([sys.executable, "-c", script], num_groups=2, nproc=2,
                  lighthouse_addr="localhost:7", max_restarts=1, log_dir=str(logs))
    assert code == 0
    names = sorted(p.name for p in logs.iterdir())
    assert names == ["g0_r0_i0.log", "g0_r1_i0.log", "g1_r0_i0.log", "g1_r0_i1.log",
                     "g1_r1_i0.log", "g1_r1_i1.log"]
    env = {}
    for name in names:
        line = next(ln for ln in (logs / name).read_text().splitlines() if ln.startswith("ENV "))
        env[name] = json.loads(line[4:])
    for name, e in env.items():
        g, r = name[1], name[4]
        assert e["REPLICA_GROUP_ID"] == g and e["RANK"] == r
        assert e["NUM_REPLICA_GROUPS"] == "2" and e["WORLD_SIZE"] == "2"
        assert e["TORCHFT_LIGHTHOUSE"] == "localhost:7"
        assert e["MASTER_ADDR"] == "localhost" and e["MASTER_PORT"]
    endpoints = {name[:2] + name[6:8]: (e["MASTER_PORT"], e["TORCHFT_STORE_ADDR"])
                 for name, e in env.items()}
    assert endpoints["g0i0"] == (env["g0_r1_i0.log"]["MASTER_PORT"],
                                 env["g0_r1_i0.log"]["TORCHFT_STORE_ADDR"])
    # ranks of one incarnation share it; groups and incarnations do not
    assert len({endpoints[k] for k in ("g0i0", "g1i0", "g1i1")}) == 3
    assert len({v[0] for v in endpoints.values()}) == 3

    # one process per group: no rendezvous endpoint
    script1 = "import os, sys; sys.exit(0 if 'MASTER_PORT' not in os.environ else 9)"
    assert launch([sys.executable, "-c", script1], num_groups=1, nproc=1,
                  lighthouse_addr="localhost:7") == 0


def test_shared_runtime_names_its_queue_item(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--shared-runtime", "--", sys.executable, "-c", "pass"])
    assert e.value.code == 2
    assert "queue 1 item 6" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Kubernetes
# ---------------------------------------------------------------------------


def test_emitted_manifests_equal_the_jax_ones_but_module_and_accelerator():
    yaml = pytest.importorskip("yaml")
    from torchft_tpu import k8s as jk8s
    from torchft_tpu_torch import k8s as pk8s

    common = dict(name="job", image="registry.example/i:v1", num_groups=3, nproc=4,
                  min_replicas=2, max_restarts=5, namespace="ft")
    cmd = ["python", "-m", "torchft_tpu_torch.examples.train_ddp"]
    port = list(yaml.safe_load_all(pk8s.emit_manifests(
        cmd, gpu_accelerator="NVIDIA-H100-80GB-HBM3", **common)))
    jax = list(yaml.safe_load_all(jk8s.emit_manifests(
        cmd, tpu_accelerator="tpu-v5-lite-podslice", tpu_topology="2x4", **common)))
    assert [(d["kind"], d["metadata"]["name"]) for d in port] == [
        (d["kind"], d["metadata"]["name"]) for d in jax]

    def pod_spec(d):
        return d["spec"]["template"]["spec"] if d["kind"] in ("Job", "Deployment") else None

    accel = []
    for d in port:
        spec = pod_spec(d)
        if d["kind"] == "Job":
            accel.append((spec.pop("nodeSelector"),
                          spec["containers"][0].pop("resources")))
    for d in jax:
        spec = pod_spec(d)
        if d["kind"] == "Job":
            assert "cloud.google.com/gke-tpu-accelerator" in spec.pop("nodeSelector")
    assert accel == [({"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"},
                      {"limits": {"nvidia.com/gpu": 1}})] * 3
    mapped = json.loads(json.dumps(port).replace("torchft_tpu_torch.", "torchft_tpu."))
    # the user's command is the user's: map it back
    mapped_jax = json.loads(json.dumps(jax).replace("torchft_tpu_torch.", "torchft_tpu."))
    assert mapped == mapped_jax
    job = next(d for d in port if d["kind"] == "Job")
    assert job["spec"]["template"]["spec"]["containers"][0]["command"][:4] == [
        "python", "-m", "torchft_tpu_torch.launcher", "--k8s-worker"]
    lh = next(d for d in port if d["kind"] == "Deployment")
    assert lh["spec"]["template"]["spec"]["containers"][0]["command"] == [
        "python", "-m", "torchft_tpu_torch.lighthouse"]
    # no node selector without a product
    assert "nodeSelector" not in pk8s.emit_manifests(cmd, **common)


def test_k8s_apply_status_down_roundtrip(tmp_path, capsys):
    """The launcher's apply / status / down verbs against a fake kubectl
    that records its invocations and serves canned API JSON."""
    yaml = pytest.importorskip("yaml")

    log = tmp_path / "kubectl.log"
    stdin_copy = tmp_path / "applied.yaml"
    canned = {"items": [
        {"kind": "Job", "metadata": {"name": "sess-g0"},
         "status": {"active": 2, "succeeded": 0, "failed": 1}},
        {"kind": "Deployment", "metadata": {"name": "sess-lighthouse"},
         "status": {"availableReplicas": 1}},
    ]}
    fake = tmp_path / "kubectl"
    fake.write_text(
        "#!/bin/bash\n"
        f"echo \"$@\" >> {log}\n"
        "if [ \"$1\" = apply ]; then\n"
        f"  cat > {stdin_copy}\n"
        "elif [ \"$1\" = get ]; then\n"
        f"  cat {tmp_path}/canned.json\n"
        "fi\n"
    )
    fake.chmod(0o755)
    (tmp_path / "canned.json").write_text(json.dumps(canned))

    main(["--k8s-apply", "--name", "sess", "--groups", "2", "--kubectl", str(fake), "--",
          "python", "train.py"])
    docs = list(yaml.safe_load_all(stdin_copy.read_text()))
    assert len(docs) == 6
    for d in docs:
        assert d["metadata"]["labels"]["torchft-session"] == "sess", d

    main(["--k8s-status", "--name", "sess", "--kubectl", str(fake)])
    st = json.loads(capsys.readouterr().out)
    assert st["jobs"]["sess-g0"] == {"active": 2, "succeeded": 0, "failed": 1}
    assert st["lighthouse"]["sess-lighthouse"] == {"available": 1}

    main(["--k8s-down", "--name", "sess", "--kubectl", str(fake)])
    lines = log.read_text().splitlines()
    assert lines[0].startswith("apply -n default -f -")
    assert "get jobs,deployments -n default -l torchft-session=sess" in lines[1]
    assert "delete jobs,services,deployments -n default -l torchft-session=sess" in lines[2]


def test_k8s_worker_bootstrap_hosts_store(monkeypatch):
    """Rank 0's bootstrap hosts a reachable KV store and points the child at
    it; a nonzero child exit propagates."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("TORCHFT_GROUP_HOST0", "localhost")
    monkeypatch.setenv("TORCHFT_STORE_PORT", "0")  # ephemeral: parallel runs
    child = (
        "import os, sys\n"
        "from datetime import timedelta\n"
        "from torchft_tpu_torch.store import StoreClient\n"
        "assert 'MASTER_PORT' not in os.environ\n"
        "c = StoreClient(os.environ['TORCHFT_STORE_ADDR'], connect_timeout=timedelta(seconds=5))\n"
        "c.set('k8s', 'ok')\n"
        "assert c.get('k8s') == b'ok'\n"
        "c.close()\n"
        "sys.exit(7)\n"
    )
    monkeypatch.setenv("PYTHONPATH", REPO)
    assert k8s_worker([sys.executable, "-c", child]) == 7


# ---------------------------------------------------------------------------
# two groups of two processes
# ---------------------------------------------------------------------------


@pytest.mark.soak
def test_two_groups_of_two_processes_over_gloo(tmp_path, monkeypatch):
    """``tests/test_multihost.py:176`` on the port: ``train_ddp`` under
    ``launcher --groups 2 --nproc 2`` on the CPU. Each group's ranks join a
    gloo group (they average their halves of the group's batch in it), the
    Managers of same-rank peers average across the groups, and all four
    processes end at step 3 with one checksum."""
    import subprocess

    logs = tmp_path / "logs"
    env = dict(os.environ, DEVICE="cpu", STEPS="3", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.launcher", "--groups", "2", "--nproc", "2",
         "--max-restarts", "0", "--log-dir", str(logs), "--",
         sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=scaled_timeout(180))
    texts = {p.name: p.read_text(errors="replace") for p in sorted(logs.iterdir())}
    assert proc.returncode == 0, (proc.stderr[-2000:], {k: v[-1500:] for k, v in texts.items()})
    assert sorted(texts) == ["g0_r0_i0.log", "g0_r1_i0.log", "g1_r0_i0.log", "g1_r1_i0.log"]
    sums = set()
    for name, text in texts.items():
        assert re.search(r"joined the group's torch.distributed group \(gloo, rank "
                         rf"{name[4]} of 2\)", text), text[-1500:]
        m = re.search(r"done: step=(\d+) param_checksum=(-?\d+\.\d+)", text)
        assert m and m.group(1) == "3", text[-1500:]
        sums.add(m.group(2))
    assert len(sums) == 1, sums
