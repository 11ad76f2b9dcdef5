"""The package's logger with wall-clock offsets.

Counterpart of ``clima_oceananigans_jl_tpu/utils/logger.py`` (Oceananigans'
``OceananigansLogger``): ``configure_logger()`` gives the
``clima_oceananigans_jl_torch`` logger lines such as
``[      1.234 s ] INFO ...``.
"""
from __future__ import annotations

import logging
import time

_START = time.monotonic()


class _ElapsedFormatter(logging.Formatter):
    def format(self, record):
        record.elapsed = f"{time.monotonic() - _START:10.3f} s"
        return super().format(record)


def configure_logger(level=logging.INFO, show_source=False):
    logger = logging.getLogger("clima_oceananigans_jl_torch")
    logger.setLevel(level)
    handler = logging.StreamHandler()
    fmt = "[ %(elapsed)s ] %(levelname)s %(message)s"
    if show_source:
        fmt += "  (%(name)s:%(lineno)d)"
    handler.setFormatter(_ElapsedFormatter(fmt))
    logger.handlers[:] = [handler]
    logger.propagate = False
    return logger
