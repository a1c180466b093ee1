"""Train step and fault-tolerant trainer."""
