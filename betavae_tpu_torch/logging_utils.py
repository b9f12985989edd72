"""Structured logging: the ``CONFIG {json}`` / ``METRICS {json}`` protocol.

The port's own copy of ``betavae_tpu/logging_utils.py``: every record is one
line ``<ts> | <LEVEL> | METRICS {"phase": ..., "step": ..., ...}``, so the
repo's plot and repair scripts parse either package's logs.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from .config import get_config

_logger = None

_LINE_FORMAT = "%(asctime)s | %(levelname)s | %(message)s"


def _build_handlers(cfg) -> list:
    """stdout always; plus the per-run log file when ``log_to_file`` is on."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if cfg.logging.log_to_file:
        log_dir = os.path.join(cfg.paths.outputs_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(log_dir, f"{cfg.paths.run_id}.log")))
    fmt = logging.Formatter(_LINE_FORMAT)
    for h in handlers:
        h.setFormatter(fmt)
    return handlers


def init_logger(name: str = "beta_vae_se_torch") -> logging.Logger:
    """Process-wide singleton emitting the protocol line shape."""
    global _logger
    if _logger is None:
        cfg = get_config()
        logger = logging.getLogger(name)
        logger.setLevel(getattr(logging, str(cfg.logging.log_level).upper(),
                                logging.INFO))
        logger.propagate = False
        if not logger.handlers:
            for h in _build_handlers(cfg):
                logger.addHandler(h)
        _logger = logger
    return _logger


def reset_logger() -> None:
    """Drop the logger singleton and close its handlers."""
    global _logger
    if _logger is not None:
        for h in list(_logger.handlers):
            h.close()
            _logger.removeHandler(h)
    _logger = None


def log_config(extras: dict | None = None) -> None:
    """``CONFIG {json}`` line: the active config, plus ``extras`` (facts the
    YAML alone does not show, such as the LPIPS weight source) as added
    top-level keys."""
    cfg = get_config().to_dict()
    if extras:
        cfg.update(extras)
    init_logger().info("CONFIG " + json.dumps(cfg))


def log_metrics(metrics: dict, step=None, phase: str = "train") -> None:
    """``METRICS {json}`` line with phase/step first."""
    payload = {"phase": phase, "step": step}
    payload.update(metrics)
    init_logger().info("METRICS " + json.dumps(payload))
