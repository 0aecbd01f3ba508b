"""Logging and timing (the reference's logger.h and utils.h Timer), on
Python logging: the render driver's progress reports and the CLI write
through `get_logger()`."""

import logging
import sys
import time

_logger = None


def get_logger():
    """The package's logger, writing INFO and above to stderr."""
    global _logger
    if _logger is None:
        _logger = logging.getLogger("misaki_tpu_torch")
        if not _logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S"))
            _logger.addHandler(h)
            _logger.setLevel(logging.INFO)
    return _logger


class Timer:
    """Wall-clock timer (utils.h:42-63)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()

    def value(self):
        return time.perf_counter() - self.t0

    def __str__(self):
        return time_string(self.value())


def time_string(seconds):
    """Humanized duration (utils.cpp time_string)."""
    if seconds < 1:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 60:
        return f"{seconds:.2f}s"
    if seconds < 3600:
        return f"{seconds / 60:.2f}m"
    return f"{seconds / 3600:.2f}h"
