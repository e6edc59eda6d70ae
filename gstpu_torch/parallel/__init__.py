"""Fused device chains: element chains as one batched step."""
