"""PyTorch ops: plain layers and attention, and the flash attention kernels."""
