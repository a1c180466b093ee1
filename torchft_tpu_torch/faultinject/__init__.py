"""Deterministic fault-injection plane of the port — the copy of
``torchft_tpu/faultinject/__init__.py``.

``faultinject.core`` is the site registry and seeded schedule engine: the
port's runtime layers consult it through
:func:`~torchft_tpu_torch.faultinject.core.fault_point` (the Manager's
commit drain, the coordination client's quorum reply and vote, the host
and device collectives, the futures' deadlines and the HTTP checkpoint
transport). ``faultinject.runner`` drives the scenario matrix over worker
processes of the ``train_bytes`` example (``python -m
torchft_tpu_torch.faultinject.runner --list``), and ``_san_worker`` is its
numpy worker under a sanitizer.
"""

from torchft_tpu_torch.faultinject.core import (
    ACTIONS,
    ENV_EVIDENCE_DIR,
    ENV_SCHEDULE,
    SITES,
    FaultPlane,
    Injection,
    active,
    configure,
    fault_point,
    read_evidence,
)

__all__ = [
    "ACTIONS",
    "ENV_EVIDENCE_DIR",
    "ENV_SCHEDULE",
    "SITES",
    "FaultPlane",
    "Injection",
    "active",
    "configure",
    "fault_point",
    "read_evidence",
]
