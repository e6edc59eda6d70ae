"""The port's own language models, written on torch ops: a model here
runs a published configuration without transformers and serves a batch
of streams in one forward pass (`deepseek_v3`, `kimi_linear`).

`config_only(path)` is the config of a directory that holds a
config.json of one of these model types and no weights; `port_model`
the class that runs it.
"""

from __future__ import annotations

import importlib
import json
import os

# model_type -> (module of this package, class)
PORT_MODELS = {"deepseek_v3": ("deepseek_v3", "DeepseekV3Lm"),
               "kimi_linear": ("kimi_linear", "KimiLinearLm")}
WEIGHT_SUFFIXES = (".safetensors", ".bin", ".pt", ".pth", ".gguf")


def config_only(path: str) -> dict | None:
    """The config of a model directory of one of PORT_MODELS' types that
    holds a config.json and no weights; None for any other directory."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        return None
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg.get("model_type") not in PORT_MODELS:
        return None
    if any(n.endswith(WEIGHT_SUFFIXES) for n in os.listdir(path)):
        return None
    return cfg


def port_model(model_type: str):
    """The class of the port's model of `model_type`."""
    module, name = PORT_MODELS[model_type]
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
