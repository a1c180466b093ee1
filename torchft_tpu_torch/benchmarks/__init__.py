"""Measurement harnesses of the port (``python -m torchft_tpu_torch.benchmarks.<name>``)."""
