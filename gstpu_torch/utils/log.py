"""Structured leveled logging, GST_DEBUG-style env filtering.

Rebuilds the per-element DebugCategory pattern (reference
tutorial/src/rgb2gray/imp.rs:24-30 `CAT` statics) on top of Python
logging. Filter with GSTPU_DEBUG, e.g.:
    GSTPU_DEBUG=3                  # global level
    GSTPU_DEBUG=audioecho:5,*:2    # per-category
Levels: 0=none 1=error 2=warning 3=info 4=debug 5=trace
"""

from __future__ import annotations

import logging
import os
import sys

_LEVEL_MAP = {0: logging.CRITICAL + 10, 1: logging.ERROR, 2: logging.WARNING,
              3: logging.INFO, 4: logging.DEBUG, 5: logging.DEBUG - 5}

logging.addLevelName(logging.DEBUG - 5, "TRACE")

_configured = False
_rules: list[tuple[str, int]] = []


def _configure() -> None:
    global _configured, _rules
    if _configured:
        return
    _configured = True
    spec = os.environ.get("GSTPU_DEBUG", "")
    default = 2
    for part in filter(None, spec.split(",")):
        if ":" in part:
            pat, lvl = part.rsplit(":", 1)
            _rules.append((pat, int(lvl)))
        else:
            default = int(part)
    _rules.append(("*", default))
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)5s %(name)s: %(message)s"))
    root = logging.getLogger("gstpu_torch")
    root.addHandler(h)
    root.setLevel(1)  # per-category levels do the filtering


def _level_for(name: str) -> int:
    for pat, lvl in _rules:
        if pat == "*" or pat == name or name.startswith(pat.rstrip("*")):
            return _LEVEL_MAP.get(lvl, logging.WARNING)
    return logging.WARNING


class DebugCategory:
    def __init__(self, name: str):
        _configure()
        self.name = name
        self.logger = logging.getLogger(f"gstpu_torch.{name}")
        self.logger.setLevel(_level_for(name))

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def trace(self, msg, *args):
        self.logger.log(logging.DEBUG - 5, msg, *args)

    log = debug


def debug_category(name: str) -> DebugCategory:
    return DebugCategory(name)
