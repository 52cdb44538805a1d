"""Running-average meter and logging setup.

A copy of ``xclip_tpu/utils/meters.py`` (reference train.py:38-61,
logger.py:4-30) without its samples/s helpers, which the training CLI
computes in its log line: :class:`AverageMeter` keeps the last value and
the running average of a log window; :func:`setup_logging` puts a
console handler (and, given a path, a file handler) with the reference's
format on the root logger, dropping the handlers an earlier call left
there, and returns the handlers it added.
"""

from __future__ import annotations

import logging
import sys


class AverageMeter:
    """Running average over a log window."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def setup_logging(log_file, level=logging.INFO, include_host: bool = False) -> list:
    if include_host:
        import socket

        hostname = socket.gethostname()
        formatter = logging.Formatter(
            f"%(asctime)s | {hostname} | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S")
    else:
        formatter = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S")

    logging.root.setLevel(level)
    # drop handlers from previous sessions (repeated main() calls would
    # otherwise write to closed files)
    for handler in list(logging.root.handlers):
        logging.root.removeHandler(handler)

    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(filename=log_file))
    for handler in handlers:
        handler.setFormatter(formatter)
        logging.root.addHandler(handler)
    return handlers
