"""Kubernetes deployment artifact — the TorchX component analogue; the
port's copy of ``torchft_tpu/k8s.py``.

Reference: torchft/torchx.py:11-76 maps N replica-group roles (each under
``torchrun --max_restarts=10``) onto a TorchX scheduler. This module
renders plain core-v1/batch-v1
manifests (no CRDs required; the shapes line up 1:1 with a JobSet if you
prefer one) that materialize the launcher's documented env contract
(launcher.py module docstring) for ``N groups × M hosts``:

* a **lighthouse** Deployment + Service (the global quorum seed);
* per replica group: a headless Service + an **Indexed Job** of M pods.
  Pod index 0 hosts the group's KV store and its ``torch.distributed``
  rendezvous (via ``launcher --k8s-worker``); every pod derives ``RANK`` from the Job
  completion index and finds its peers through stable DNS
  (``{job}-{index}.{headless-svc}``).

Restart semantics: the Job's ``backoffLimit`` plays launcher
``--max-restarts``; pods of a group share fate through the FT runtime
itself (a dead rank wedges the group's quorum participation, the
lighthouse evicts it, survivors re-quorum — the same flow the launcher
drives locally).

Each worker pod asks for one card (an ``nvidia.com/gpu`` resource limit
of ``GPUS_PER_POD``: a pod is one rank) and, with
``gpu_accelerator``, lands on nodes whose ``nvidia.com/gpu.product`` label
names that card (the label NVIDIA's GPU feature discovery sets). These
lines take the place of the JAX manifest's GKE TPU node selector; nothing
else differs but the module names.

Render with::

    python -m torchft_tpu_torch.launcher --emit-k8s --groups 4 --nproc 8 \\
        --image registry.example/trainer:latest \\
        -- python -m torchft_tpu_torch.examples.train_ddp

Runnable workflow (the ``torchx run`` analogue — shells out to
``kubectl``, which owns auth/context exactly as TorchX defers to its
scheduler):

    # render + submit
    python -m torchft_tpu_torch.launcher --emit-k8s ... -- python train.py \\
        | kubectl apply -f -
    # or in one step, plus status/teardown:
    python -m torchft_tpu_torch.launcher --k8s-apply ... -- python train.py
    python -m torchft_tpu_torch.launcher --k8s-status --name torchft
    python -m torchft_tpu_torch.launcher --k8s-down --name torchft

Every emitted object carries the ``torchft-session: {name}`` label;
status and teardown select on it.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List, Optional, Sequence

__all__ = [
    "emit_manifests",
    "submit",
    "status",
    "teardown",
    "LIGHTHOUSE_PORT",
    "STORE_PORT",
    "COORD_PORT",
]

# selector label stamped on every emitted object: status/teardown key
SESSION_LABEL = "torchft-session"

LIGHTHOUSE_PORT = 29510
STORE_PORT = 29511
COORD_PORT = 29512
# a worker pod is one rank of its group, and a rank drives one card
GPUS_PER_POD = 1


def _indent(block: str, n: int) -> str:
    pad = " " * n
    return "\n".join(pad + line if line else line for line in block.splitlines())


def _q(s: str) -> str:
    """YAML-safe string literal: JSON string escaping is a subset of YAML
    double-quoted scalars (repr() is NOT — backslashes/mixed quotes break)."""
    return json.dumps(s)


def _env_yaml(env: List[tuple]) -> str:
    out = []
    for name, value in env:
        if isinstance(value, dict):  # fieldRef
            out.append(
                f"- name: {name}\n"
                f"  valueFrom:\n"
                f"    fieldRef:\n"
                f"      fieldPath: {_q(value['fieldPath'])}"
            )
        else:
            out.append(f"- name: {name}\n  value: {_q(value)}")
    return "\n".join(out)


def emit_manifests(
    cmd: Sequence[str],
    *,
    name: str = "torchft",
    image: str = "IMAGE",
    num_groups: int = 2,
    nproc: int = 1,
    min_replicas: Optional[int] = None,
    max_restarts: int = 10,
    namespace: str = "default",
    gpu_accelerator: Optional[str] = None,
) -> str:
    """Render the full multi-document YAML for N groups × M hosts."""
    min_needed = min_replicas or num_groups
    docs: List[str] = []

    # -- lighthouse --------------------------------------------------------
    docs.append(
        f"""apiVersion: apps/v1
kind: Deployment
metadata:
  name: {name}-lighthouse
  namespace: {namespace}
  labels: {{app: {name}-lighthouse, {SESSION_LABEL}: {name}}}
spec:
  replicas: 1
  selector:
    matchLabels: {{app: {name}-lighthouse}}
  template:
    metadata:
      labels: {{app: {name}-lighthouse}}
    spec:
      containers:
      - name: lighthouse
        image: {image}
        command: ["python", "-m", "torchft_tpu_torch.lighthouse"]
        args: ["--bind", "[::]:{LIGHTHOUSE_PORT}", "--min_replicas", "{min_needed}"]
        ports:
        - containerPort: {LIGHTHOUSE_PORT}"""
    )
    docs.append(
        f"""apiVersion: v1
kind: Service
metadata:
  name: {name}-lighthouse
  namespace: {namespace}
  labels: {{{SESSION_LABEL}: {name}}}
spec:
  selector: {{app: {name}-lighthouse}}
  ports:
  - port: {LIGHTHOUSE_PORT}
    targetPort: {LIGHTHOUSE_PORT}"""
    )

    # -- replica groups ----------------------------------------------------
    worker_cmd = [
        "python",
        "-m",
        "torchft_tpu_torch.launcher",
        "--k8s-worker",
        "--",
        *cmd,
    ]
    # exec-form command: no shell, tokens rendered verbatim (JSON-escaped —
    # valid YAML double-quoted scalars for any token content)
    args_yaml = ", ".join(_q(a) for a in worker_cmd)
    for gid in range(num_groups):
        job = f"{name}-g{gid}"
        docs.append(
            f"""apiVersion: v1
kind: Service
metadata:
  name: {job}
  namespace: {namespace}
  labels: {{{SESSION_LABEL}: {name}}}
spec:
  clusterIP: None  # headless: stable {job}-{{index}}.{job} pod DNS
  selector: {{job-name: {job}}}
  ports:
  - name: store
    port: {STORE_PORT}
  - name: coord
    port: {COORD_PORT}"""
        )
        env = [
            ("TORCHFT_LIGHTHOUSE", f"{name}-lighthouse:{LIGHTHOUSE_PORT}"),
            ("REPLICA_GROUP_ID", str(gid)),
            ("NUM_REPLICA_GROUPS", str(num_groups)),
            ("WORLD_SIZE", str(nproc)),
            (
                "RANK",
                {
                    "fieldPath": (
                        "metadata.annotations"
                        "['batch.kubernetes.io/job-completion-index']"
                    )
                },
            ),
            # index-0 pod's stable DNS: hosts the group store + rendezvous
            ("TORCHFT_GROUP_HOST0", f"{job}-0.{job}"),
        ]
        node_lines = ""
        if gpu_accelerator:
            node_lines = f"""
      nodeSelector:
        nvidia.com/gpu.product: {_q(gpu_accelerator)}"""
        docs.append(
            f"""apiVersion: batch/v1
kind: Job
metadata:
  name: {job}
  namespace: {namespace}
  labels: {{{SESSION_LABEL}: {name}}}
spec:
  completionMode: Indexed
  completions: {nproc}
  parallelism: {nproc}
  backoffLimit: {max_restarts * max(1, nproc)}
  template:
    metadata:
      labels: {{job-name: {job}}}
    spec:
      subdomain: {job}
      restartPolicy: OnFailure{node_lines}
      containers:
      - name: trainer
        image: {image}
        command: [{args_yaml}]
        env:
{_indent(_env_yaml(env), 8)}
        resources:
          limits:
            nvidia.com/gpu: {GPUS_PER_POD}
        ports:
        - containerPort: {STORE_PORT}
        - containerPort: {COORD_PORT}"""
        )
    return "\n---\n".join(docs) + "\n"


# ---------------------------------------------------------------------------
# runnable workflow: submit / status / teardown
# ---------------------------------------------------------------------------


def submit(
    manifests: str, *, namespace: str = "default", kubectl: str = "kubectl"
) -> None:
    """``kubectl apply`` the rendered manifests (stdin — nothing touches
    disk). Raises CalledProcessError on a rejected apply."""
    subprocess.run(
        [kubectl, "apply", "-n", namespace, "-f", "-"],
        input=manifests.encode(),
        check=True,
    )


def status(
    name: str, *, namespace: str = "default", kubectl: str = "kubectl"
) -> Dict[str, Dict[str, Dict[str, int]]]:
    """Session status by the ``torchft-session`` label: per-Job
    active/succeeded/failed pod counts + lighthouse availability."""
    proc = subprocess.run(
        [
            kubectl, "get", "jobs,deployments", "-n", namespace,
            "-l", f"{SESSION_LABEL}={name}", "-o", "json",
        ],
        capture_output=True,
    )
    if proc.returncode != 0:
        # surface kubectl's own diagnostic (bad context, missing ns, ...)
        raise RuntimeError(
            f"kubectl get failed (rc={proc.returncode}): "
            f"{proc.stderr.decode().strip()}"
        )
    out = proc.stdout
    res: Dict[str, Dict[str, Dict[str, int]]] = {"jobs": {}, "lighthouse": {}}
    for item in json.loads(out).get("items", []):
        kind = item.get("kind", "")
        iname = item.get("metadata", {}).get("name", "?")
        st = item.get("status", {}) or {}
        if kind == "Job":
            res["jobs"][iname] = {
                "active": int(st.get("active") or 0),
                "succeeded": int(st.get("succeeded") or 0),
                "failed": int(st.get("failed") or 0),
            }
        elif kind == "Deployment":
            res["lighthouse"][iname] = {
                "available": int(st.get("availableReplicas") or 0),
            }
    return res


def teardown(
    name: str, *, namespace: str = "default", kubectl: str = "kubectl"
) -> None:
    """Delete every object of the session (label-selected)."""
    subprocess.run(
        [
            kubectl, "delete", "jobs,services,deployments",
            "-n", namespace, "-l", f"{SESSION_LABEL}={name}",
            "--ignore-not-found",
        ],
        check=True,
    )
