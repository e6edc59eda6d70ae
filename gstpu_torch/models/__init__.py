"""The port's own language models, written on torch ops: a model here
runs a published configuration without transformers and serves a batch
of streams in one forward pass (`deepseek_v3`)."""
