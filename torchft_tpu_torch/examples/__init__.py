"""Example trainers of the port, runnable with ``python -m torchft_tpu_torch.examples.<name>``."""
