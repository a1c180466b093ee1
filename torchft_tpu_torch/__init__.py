"""torchft_tpu_torch — the PyTorch/CUDA port of ``torchft_tpu``.

Per-step fault tolerance for replicated training (quorum, cross-group
gradient averaging, commit vote, live heal) around a PyTorch transformer
whose attention runs on hand-written Hopper kernels. The layout mirrors
``torchft_tpu`` module for module; this package imports neither JAX nor
``torchft_tpu`` (it keeps its own copies of what it needs).

The public names are the JAX package's (``torchft_tpu/__init__.py``): the
Manager, the sampler and the host collectives load with the package, the
heavier wrappers (``CollectivesProxy`` and ``ParameterServer`` among them)
at first access. Not exported until its module is ported (ROADMAP queue 1
item 6): ``CollectivesDeviceDist``.

Importing the package starts nothing: no thread runs, and the native
coordination core and the CUDA kernels are built at first use.
"""

from torchft_tpu_torch.collectives import (  # noqa: E402
    Collectives,
    CollectivesDummy,
    CollectivesTcp,
    ErrorSwallowingCollectives,
    ManagedCollectives,
)
from torchft_tpu_torch.data import DistributedSampler  # noqa: E402
from torchft_tpu_torch.manager import Manager, WorldSizeMode  # noqa: E402

__all__ = [
    "Manager",
    "WorldSizeMode",
    "DistributedSampler",
    "Collectives",
    "CollectivesTcp",
    "CollectivesDevice",
    "CollectivesDummy",
    "ErrorSwallowingCollectives",
    "ManagedCollectives",
]

_LAZY = {
    "ManagedOptimizer": "torchft_tpu_torch.optim",
    "LocalSGD": "torchft_tpu_torch.local_sgd",
    "DiLoCo": "torchft_tpu_torch.local_sgd",
    "CollectivesDevice": "torchft_tpu_torch.collectives_device",
    "FTTrainer": "torchft_tpu_torch.parallel.ft",
    "CollectivesProxy": "torchft_tpu_torch.proxy",
    "ParameterServer": "torchft_tpu_torch.parameter_server",
}


def __getattr__(name):
    import importlib

    if name == "telemetry":
        return importlib.import_module("torchft_tpu_torch.telemetry")
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'torchft_tpu_torch' has no attribute {name!r}")
