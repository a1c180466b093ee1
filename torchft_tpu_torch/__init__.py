"""torchft_tpu_torch — the PyTorch/CUDA port of ``torchft_tpu``.

Per-step fault tolerance for replicated training (quorum, cross-group
gradient averaging, commit vote, live heal) around a PyTorch transformer
whose attention runs on hand-written Hopper kernels. The layout mirrors
``torchft_tpu`` module for module; this package imports neither JAX nor
``torchft_tpu`` (it keeps its own copies of what it needs).

Importing the package starts nothing: the native coordination core and
the CUDA kernels are built at first use.
"""
