"""Checkpoint serialization and transport for live heal."""
