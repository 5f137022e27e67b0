"""Obs logger: the one stdout logging setup the launch drivers share (a copy
of ``repro/obs/log.py``, under the ``repro_torch.obs`` logger names).

``launch/serve.py`` and ``launch/train.py`` used raw ``print(f"[serve] ...")``
lines for their status/timing output; routing them through a logger keeps
the familiar ``[name] message`` format while making the stream filterable
(``REPRO_LOG=WARNING`` silences info chatter in batch jobs) and giving every
obs component one place to write human-readable status.
"""

from __future__ import annotations

import logging
import os
import sys


class _PrefixFormatter(logging.Formatter):
    def format(self, record):
        # "[serve] message" — the exact shape the drivers always printed
        tag = record.name.rsplit(".", 1)[-1]
        return f"[{tag}] {record.getMessage()}"


def get_logger(name: str) -> logging.Logger:
    """A ``repro_torch.obs.<name>`` stdout logger printing ``[name] message`` lines.

    Idempotent (repeat calls return the same configured logger, no duplicate
    handlers).  Level comes from the ``REPRO_LOG`` env var (default INFO),
    so scripted runs can silence or expand the stream without code changes.
    """
    logger = logging.getLogger(f"repro_torch.obs.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_PrefixFormatter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("REPRO_LOG", "INFO").upper())
        logger.propagate = False
    return logger
