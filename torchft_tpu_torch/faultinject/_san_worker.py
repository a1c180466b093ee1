"""The fault matrix's worker under a sanitizer — the port's copy of
``torchft_tpu/faultinject/_san_worker.py``.

``--sanitize`` loads an ASan or TSan build of the native core into every
worker (``TORCHFT_NATIVE_LIB``, the runtime in ``LD_PRELOAD``). This worker
drives the same Manager / CollectivesTcp / quorum / heal / commit path as
the ``train_bytes`` example with numpy state and no model, on the CPU:
the suspects a sanitizer hunts (the native data plane, the RPC layer, the
CMA pulls, the blob plane) are all on that path, and nothing here needs the
card.

The launcher environment is the example's (``REPLICA_GROUP_ID``,
``NUM_REPLICA_GROUPS``, ``STEPS``, ``TORCHFT_LIGHTHOUSE``,
``TORCHFT_WIRE_CODEC``) and so is the
last line, ``done: step=N param_checksum=X``, which the runner's
cross-group check reads. Gradients are a pure function of ``(group,
step)``, so a retried, healed or respawned step regenerates the same bytes
and the checksums stay bit-identical through any injection.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import timedelta

import numpy as np

logger = logging.getLogger("san_worker")

SHAPE = (256, 256)  # 256 KiB of float32: large enough for striped and CMA hops


def _loaded_core() -> str:
    """The native core this process mapped (a sanitized build under
    ``--sanitize``), read from ``/proc/self/maps``."""
    try:
        with open("/proc/self/maps") as f:
            paths = {line.split()[-1] for line in f if "libtftcore" in line}
    except OSError:
        return "unknown"
    return ",".join(sorted(paths)) or "none"


def main() -> None:
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.store import StoreServer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    gid = int(os.environ["REPLICA_GROUP_ID"])
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", "2"))
    steps = int(os.environ.get("STEPS", "10"))

    params = {"w": np.zeros(SHAPE, np.float32), "steps_seen": 0}

    def state_dict():
        return {"w": params["w"].copy(), "steps_seen": params["steps_seen"]}

    def load_state_dict(state) -> None:
        params["w"] = np.asarray(state["w"], np.float32).copy()
        params["steps_seen"] = int(state["steps_seen"])

    store = StoreServer()
    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30),
                                   wire_dtype=os.environ.get("TORCHFT_WIRE_CODEC") or None),
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=min(2, num_groups),
        replica_id=f"san_worker_{gid}",
        store_addr=store.address(),
        rank=0,
        world_size=1,
        timeout=timedelta(seconds=30),
    )
    logger.info("start: gid=%d pid=%d steps=%d native core %s", gid, os.getpid(), steps,
                _loaded_core())
    try:
        while manager.current_step() < steps:
            step = manager.current_step()
            try:
                manager.start_quorum()
                # a pure function of (gid, step): every committed step's
                # average, and so the final checksum, is the same in all
                # groups through retries and respawns
                rng = np.random.default_rng((gid << 24) ^ step)
                grad = rng.standard_normal(SHAPE).astype(np.float32)
                manager.allreduce(grad).wait()
                committed = manager.should_commit()
            except TimeoutError as e:
                # a deadline blown while a peer is down is a retry; the
                # runner's own deadline bounds a real wedge
                logger.info("timeout, retrying step %d: %s", step, e)
                continue
            if committed:
                params["w"] -= 0.01 * grad
                params["steps_seen"] += 1
            else:
                time.sleep(0.2)  # the same step retries
        checksum = float(np.asarray(params["w"], np.float64).sum())
        logger.info("done: step=%d param_checksum=%.6f", manager.current_step(), checksum)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


if __name__ == "__main__":
    main()
