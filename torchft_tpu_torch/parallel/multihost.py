"""Multi-process replica groups — ``torch.distributed`` wiring; the port's
counterpart of ``torchft_tpu/parallel/multihost.py``.

The reference's replica groups span hosts through torchrun: each group is
``torchrun --nnodes=1 --nproc_per_node=M`` and torch.distributed carries
the intra-group collectives (torchft/torchx.py:11-76). Here every process
of a group calls :func:`initialize_group`, which joins the group's
``torch.distributed`` process group at the rendezvous endpoint the
launcher hands out: ``gloo`` on the CPU, ``nccl`` on the card. The elastic
cross-group axis stays outside (a Manager and its host collectives per
rank, same-rank peers across groups), so group membership changes never
touch the group's process group.

Env contract (set by ``torchft_tpu_torch.launcher`` for ``--nproc > 1``,
or by a cluster scheduler):

    MASTER_ADDR / MASTER_PORT   the group's rendezvous endpoint (fresh per
                                group and per incarnation)
    RANK / WORLD_SIZE           this process's index / process count in group

:func:`global_mesh` is the group-wide device mesh over that process group
(one rank a process, one device a rank).
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["initialize_group", "is_initialized", "global_mesh", "ENDPOINT_ENV"]

# the rendezvous endpoint: the counterpart of TORCHFT_JAX_COORDINATOR
ENDPOINT_ENV = ("MASTER_ADDR", "MASTER_PORT")

# how long init_process_group waits for the group's other processes
JOIN_TIMEOUT = timedelta(seconds=120)

_initialized = False


def is_initialized() -> bool:
    return _initialized


def initialize_group(
    endpoint: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Join this replica group's ``torch.distributed`` process group.
    Reads the launcher env (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE)
    unless given explicitly (``endpoint`` is ``host:port``); a no-op for a
    single-process group (no endpoint set, or ``WORLD_SIZE`` 1) and when
    already initialized (idempotent, so library code may call it freely).

    ``device`` picks the backend: ``"cpu"`` gloo, ``"cuda"`` nccl (the
    default is ``DEVICE`` from the environment, else the card)."""
    global _initialized
    if _initialized:
        return
    if endpoint is None:
        addr, port = (os.environ.get(k) for k in ENDPOINT_ENV)
        if not addr or not port:
            return  # single-process group
        endpoint = f"{addr}:{port}"
    num_processes = (
        num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    )
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if num_processes <= 1:
        return
    import torch.distributed as dist

    from torchft_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device or os.environ.get("DEVICE", "cuda"))
    if dev.type == "cuda":
        import torch

        # one card per rank when the host has several; ranks share it
        # otherwise (NCCL refuses two ranks on one card: ROADMAP item 6)
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    host, _, port = endpoint.rpartition(":")
    host = host.strip("[]")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://[{host}]:{port}" if ":" in host else f"tcp://{host}:{port}",
        world_size=num_processes,
        rank=process_id,
        timeout=JOIN_TIMEOUT,
    )
    _initialized = True
    logger.info("joined the group's torch.distributed group (%s, rank %d of %d) at %s",
                backend, process_id, num_processes, endpoint)


def global_mesh(config, device: Optional[str] = None):
    """The group-wide mesh: :func:`~torchft_tpu_torch.parallel.mesh.make_mesh`
    over the ranks of the group that :func:`initialize_group` joined (a
    one-rank group of its own when the group is one process). ``device``:
    ``"cuda"`` or ``"cpu"`` (default ``DEVICE`` from the environment, else
    the card). All processes must call with the same config."""
    from torchft_tpu_torch.parallel.mesh import make_mesh
    from torchft_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device or os.environ.get("DEVICE", "cuda"))
    return make_mesh(config, devices=dev.type)
