"""Job launcher — the TorchX/torchrun analogue; the port's copy of
``torchft_tpu/launcher.py``.

Reference: torchft/torchx.py:11-76 (N replica-group roles, each under
``torchrun --max_restarts=10``). This supervisor fills both roles for
single-host runs and documents the env contract for cluster schedulers:

    TORCHFT_LIGHTHOUSE   lighthouse host:port
    TORCHFT_STORE_ADDR   per-replica-group KV store host:port
    REPLICA_GROUP_ID     group index
    NUM_REPLICA_GROUPS   total groups
    RANK / WORLD_SIZE    rank within the group
    MASTER_ADDR / MASTER_PORT   (``--nproc > 1``) the group's
                         ``torch.distributed`` rendezvous, fresh per group
                         and per incarnation (``parallel.multihost``)

Each replica group gets its own StoreServer and worker subprocesses; a
group whose worker dies is torn down and relaunched whole (the reference's
torchelastic restart) up to ``--max-restarts`` times. The lighthouse is
spawned automatically unless an address is given; it waits
``JOIN_TIMEOUT_MS`` (60 s, the lighthouse CLI's default) for groups that
heartbeat but have not joined yet, so groups that start late still meet the
others' first quorum when ``--min-replicas`` is below ``--groups``.
``--log-dir`` sends each
worker's output to ``g<group>_r<rank>_i<incarnation>.log`` there (the
workers inherit the launcher's otherwise).

CLI::

    python -m torchft_tpu_torch.launcher --groups 2 --nproc 1 -- \\
        python -m torchft_tpu_torch.examples.train_ddp

``--emit-k8s`` prints the Kubernetes manifests of the same topology
(``k8s.py``); ``--k8s-apply``, ``--k8s-status`` and ``--k8s-down`` drive
them through ``kubectl``. ``--shared-runtime`` (one runtime across the
groups, ``CollectivesDeviceDist``) is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["launch", "k8s_worker", "main"]

# the launcher's lighthouse waits this long for groups that heartbeat but
# have not asked for the quorum yet (the lighthouse CLI's default, and the
# reference's). With --min-replicas below --groups, a short wait lets the
# groups that start first form quorums, and finish, without the others.
JOIN_TIMEOUT_MS = 60000

SHARED_RUNTIME_MISSING = (
    "--shared-runtime (all groups in one runtime, CollectivesDeviceDist) is not "
    "ported yet: ROADMAP queue 1 item 6"
)


@dataclass
class _Group:
    gid: int
    store: object
    procs: List[subprocess.Popen] = field(default_factory=list)
    restarts: int = 0


def _free_port() -> int:
    # bind/close races another process onto the port before rank 0 binds
    # it — rare, and self-healing: the group dies at startup and the
    # supervisor loop respawns it with a fresh port
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _spawn_group(
    gid: int,
    cmd: Sequence[str],
    num_groups: int,
    nproc: int,
    lighthouse_addr: str,
    base_env: Dict[str, str],
    log_dir: Optional[str] = None,
    incarnation: int = 0,
) -> _Group:
    from torchft_tpu_torch.store import StoreServer

    store = StoreServer()
    group = _Group(gid=gid, store=store, restarts=incarnation)
    # multi-process group: a fresh rendezvous endpoint, so the workers form
    # one torch.distributed group (parallel.multihost.initialize_group).
    # Single-host launcher -> localhost; a cluster scheduler sets
    # MASTER_ADDR / MASTER_PORT to the group's rank-0 host itself.
    master_port = _free_port() if nproc > 1 else None
    for rank in range(nproc):
        env = dict(base_env)
        env.update(
            TORCHFT_LIGHTHOUSE=lighthouse_addr,
            TORCHFT_STORE_ADDR=store.address(),
            REPLICA_GROUP_ID=str(gid),
            NUM_REPLICA_GROUPS=str(num_groups),
            RANK=str(rank),
            WORLD_SIZE=str(nproc),
        )
        if master_port is not None:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(master_port))
        out = None
        if log_dir is not None:
            out = open(os.path.join(log_dir, f"g{gid}_r{rank}_i{incarnation}.log"), "ab",
                       buffering=0)
        try:
            group.procs.append(subprocess.Popen(
                list(cmd), env=env, stdout=out, stderr=subprocess.STDOUT if out else None))
        finally:
            if out is not None:
                out.close()  # the child holds its own descriptor
    return group


def _teardown_group(group: _Group) -> None:
    for p in group.procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 5
    for p in group.procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    group.store.shutdown()


def _maybe_spawn_lighthouse(lighthouse_addr: Optional[str], min_replicas: int):
    """Launcher-owned lighthouse when no external address was given;
    returns (server_or_None, host:port)."""
    if lighthouse_addr is not None:
        return None, lighthouse_addr
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=min_replicas,
                                  join_timeout_ms=JOIN_TIMEOUT_MS)
    # address() is http://host:port — the env var carries host:port
    addr = lighthouse.address().split("//", 1)[-1]
    logger.info("spawned lighthouse at %s", addr)
    return lighthouse, addr


def launch(
    cmd: Sequence[str],
    num_groups: int = 2,
    nproc: int = 1,
    lighthouse_addr: Optional[str] = None,
    max_restarts: int = 10,
    min_replicas: Optional[int] = None,
    log_dir: Optional[str] = None,
) -> int:
    """Run ``cmd`` as ``num_groups`` fault-tolerant replica groups of
    ``nproc`` workers. Returns the exit code (0 iff every group finished
    clean)."""
    lighthouse, lighthouse_addr = _maybe_spawn_lighthouse(
        lighthouse_addr, min_replicas or num_groups
    )
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    base_env = dict(os.environ)
    groups = [
        _spawn_group(g, cmd, num_groups, nproc, lighthouse_addr, base_env, log_dir)
        for g in range(num_groups)
    ]
    exit_code = 0
    min_needed = min_replicas or num_groups
    try:
        while groups:
            time.sleep(0.5)
            for group in list(groups):
                codes = [p.poll() for p in group.procs]
                if all(c == 0 for c in codes):
                    logger.info("group %d finished clean", group.gid)
                    _teardown_group(group)
                    groups.remove(group)
                elif any(c is not None and c != 0 for c in codes):
                    logger.warning("group %d worker died (codes %s)", group.gid, codes)
                    _teardown_group(group)
                    groups.remove(group)
                    if lighthouse is not None and len(groups) + 1 < min_needed:
                        # this launcher owns the quorum and a respawn plus
                        # every still-running group cannot reach
                        # min_replicas (the peers finished and left): the
                        # respawn could never re-quorum and would hang to
                        # max_restarts. The peers could only finish with
                        # this group in their quorums, so the cohort's work
                        # is complete; but this group crashed at the tail,
                        # so the exit code is still 1. (With an external
                        # lighthouse, other launchers' groups may keep the
                        # quorum alive — always respawn then.)
                        logger.info(
                            "group %d died with too few peers left to ever re-quorum "
                            "(%d alive < min_replicas %d); job complete, not respawning",
                            group.gid, len(groups) + 1, min_needed,
                        )
                        exit_code = 1
                        continue
                    if group.restarts < max_restarts:
                        fresh = _spawn_group(
                            group.gid, cmd, num_groups, nproc, lighthouse_addr, base_env,
                            log_dir, incarnation=group.restarts + 1,
                        )
                        groups.append(fresh)
                        logger.info("restarted group %d (restart %d/%d)",
                                    group.gid, fresh.restarts, max_restarts)
                    else:
                        logger.error("group %d exhausted restarts", group.gid)
                        exit_code = 1
    except KeyboardInterrupt:
        exit_code = 130
    finally:
        for group in groups:
            _teardown_group(group)
        if lighthouse is not None:
            lighthouse.shutdown()
    return exit_code


def k8s_worker(cmd: Sequence[str]) -> int:
    """In-cluster per-pod bootstrap (the pod command the ``--emit-k8s``
    manifests render). Completes the env contract a scheduler can't:

    * pod index 0 hosts the replica group's KV store (and, for a
      multi-process group, the rendezvous endpoint is its host);
    * every pod resolves both through the index-0 pod's stable DNS
      (``TORCHFT_GROUP_HOST0``, set by the manifest) and runs the training
      command with ``TORCHFT_STORE_ADDR`` (and ``MASTER_ADDR`` /
      ``MASTER_PORT``) filled in.
    """
    import signal

    from torchft_tpu_torch.k8s import COORD_PORT, STORE_PORT

    rank = int(os.environ.get("RANK", "0") or "0")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    host0 = os.environ.get("TORCHFT_GROUP_HOST0", "localhost")
    # TORCHFT_STORE_PORT=0 -> ephemeral (tests and single-pod runs only:
    # peer pods can't guess an ephemeral port)
    port = int(os.environ.get("TORCHFT_STORE_PORT", STORE_PORT))

    env = dict(os.environ)
    env["RANK"] = str(rank)
    store = None
    if rank == 0:
        from torchft_tpu_torch.store import StoreServer

        store = StoreServer(bind=f"[::]:{port}")
        port = store.port
    env["TORCHFT_STORE_ADDR"] = f"{host0}:{port}"
    if world > 1:
        env.update(MASTER_ADDR=host0, MASTER_PORT=str(COORD_PORT))

    proc = subprocess.Popen(list(cmd), env=env)

    # this bootstrap is the container's PID 1: forward termination signals
    # so the trainer gets its graceful-shutdown window (checkpoint flush,
    # clean quorum leave) before kubelet's grace period expires
    def _forward(signum, frame):  # noqa: ARG001
        try:
            proc.send_signal(signum)
        except OSError:
            pass

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _forward)

    try:
        return proc.wait()
    finally:
        if store is not None:
            store.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Launch N fault-tolerant replica groups of a training script"
    )
    parser.add_argument("--groups", type=int, default=2)
    parser.add_argument("--nproc", type=int, default=1, help="workers per group")
    parser.add_argument("--lighthouse", default=None, help="existing host:port")
    parser.add_argument("--max-restarts", type=int, default=10)
    parser.add_argument("--min-replicas", type=int, default=None)
    parser.add_argument(
        "--log-dir", default=None,
        help="write each worker's output to g<group>_r<rank>_i<incarnation>.log here",
    )
    parser.add_argument(
        "--shared-runtime", action="store_true",
        help="join all groups to one runtime (CollectivesDeviceDist): not ported yet",
    )
    parser.add_argument(
        "--emit-k8s", action="store_true",
        help="print Kubernetes manifests for this topology instead of launching "
        "locally (the TorchX-component analogue, reference torchx.py:11-76)",
    )
    parser.add_argument(
        "--k8s-worker", action="store_true",
        help="internal: in-cluster per-pod bootstrap (store hosting + env "
        "completion); used by the emitted manifests",
    )
    parser.add_argument(
        "--k8s-apply", action="store_true",
        help="render the manifests and kubectl-apply them (torchx run analogue; "
        "kubectl owns auth/context)",
    )
    parser.add_argument(
        "--k8s-status", action="store_true",
        help="print the session's Job/lighthouse status as JSON (selects on the "
        "torchft-session label; use --name)",
    )
    parser.add_argument(
        "--k8s-down", action="store_true",
        help="delete every object of the session (label-selected)",
    )
    parser.add_argument("--kubectl", default="kubectl", help="kubectl binary to shell to")
    parser.add_argument("--image", default="IMAGE", help="--emit-k8s: container image")
    parser.add_argument("--name", default="torchft", help="--emit-k8s: resource prefix")
    parser.add_argument("--namespace", default="default")
    parser.add_argument(
        "--gpu-accelerator", default=None,
        help="--emit-k8s: node selector on the GPU product label (e.g. NVIDIA-H100-80GB-HBM3)",
    )
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    logging.basicConfig(level=logging.INFO)
    if args.shared_runtime:
        parser.error(SHARED_RUNTIME_MISSING)
    if args.k8s_status or args.k8s_down:
        # cmd-less verbs: operate on an existing session by name
        import json

        from torchft_tpu_torch.k8s import status, teardown

        if args.k8s_status:
            print(json.dumps(status(args.name, namespace=args.namespace,
                                    kubectl=args.kubectl), indent=1))
        if args.k8s_down:
            teardown(args.name, namespace=args.namespace, kubectl=args.kubectl)
        return
    if not cmd:
        parser.error("no command given (use: launcher [opts] -- cmd ...)")
    if args.emit_k8s or args.k8s_apply:
        from torchft_tpu_torch.k8s import emit_manifests, submit

        manifests = emit_manifests(
            cmd,
            name=args.name,
            image=args.image,
            num_groups=args.groups,
            nproc=args.nproc,
            min_replicas=args.min_replicas,
            max_restarts=args.max_restarts,
            namespace=args.namespace,
            gpu_accelerator=args.gpu_accelerator,
        )
        if args.k8s_apply:
            submit(manifests, namespace=args.namespace, kubectl=args.kubectl)
        else:
            print(manifests, end="")
        return
    if args.k8s_worker:
        sys.exit(k8s_worker(cmd))
    sys.exit(
        launch(
            cmd,
            num_groups=args.groups,
            nproc=args.nproc,
            lighthouse_addr=args.lighthouse,
            max_restarts=args.max_restarts,
            min_replicas=args.min_replicas,
            log_dir=args.log_dir,
        )
    )


if __name__ == "__main__":
    main()
