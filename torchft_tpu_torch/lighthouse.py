"""Standalone lighthouse CLI — ``python -m torchft_tpu_torch.lighthouse``;
the port's copy of ``torchft_tpu/lighthouse.py``.

Serves the quorum coordinator of the port's C++ core
(:class:`~torchft_tpu_torch.coordination.LighthouseServer`) until SIGINT or
SIGTERM. Trainers find it through ``TORCHFT_LIGHTHOUSE`` (host:port).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="torchft-tpu lighthouse: quorum coordinator + dashboard"
    )
    parser.add_argument("--bind", default="[::]:29510", help="host:port to bind")
    parser.add_argument(
        "--min_replicas", type=int, required=True,
        help="minimum replica groups required to form a quorum",
    )
    parser.add_argument("--join_timeout_ms", type=int, default=60000)
    parser.add_argument("--quorum_tick_ms", type=int, default=100)
    parser.add_argument("--heartbeat_timeout_ms", type=int, default=5000)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from torchft_tpu_torch.coordination import LighthouseServer

    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
    )
    logging.info(
        "lighthouse listening on %s (dashboard at /, Prometheus exposition "
        "at /metrics, JSON counters at /status.json)",
        server.address(),
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    server.shutdown()


if __name__ == "__main__":
    main()
