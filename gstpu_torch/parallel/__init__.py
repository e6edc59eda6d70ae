"""Fused device chains (element chains as one batched step), streams
and time sharded over a device mesh, and stream-state checkpoints."""
