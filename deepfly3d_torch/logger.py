"""Thin logging wrappers: a jax-free copy of ``deepfly3d_tpu/logger.py``.

The port logs under its own name, ``deepfly3d_torch``.
"""

import logging

_logger = logging.getLogger("deepfly3d_torch")


def getLogger() -> logging.Logger:
    return _logger


def error(*args, **kwargs):
    _logger.error(*args, **kwargs)


def warning(*args, **kwargs):
    _logger.warning(*args, **kwargs)


def info(*args, **kwargs):
    _logger.info(*args, **kwargs)


def debug(*args, **kwargs):
    _logger.debug(*args, **kwargs)


def info_enabled() -> bool:
    return _logger.getEffectiveLevel() <= logging.INFO


def debug_enabled() -> bool:
    return _logger.getEffectiveLevel() <= logging.DEBUG
