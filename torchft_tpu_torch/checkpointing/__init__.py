"""Checkpoint serialization and transport for live heal."""

from torchft_tpu_torch.checkpointing.collectives_transport import CollectivesTransport
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

__all__ = ["CollectivesTransport", "HTTPTransport"]
