"""Helpers shared across the port: wire codec, pytree walks, device selection."""
