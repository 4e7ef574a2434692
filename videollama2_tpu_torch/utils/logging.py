"""Logging utilities of the serving plane (the port's copy of the JAX
package's utils/logging.py build_logger and pretty_print_semaphore).

Parity: reference videollama2/utils.py:17-99 — named loggers with
timed-rotating file handlers under LOGDIR, stdout/stderr redirection, and
pretty-print helpers.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

from ..constants import LOGDIR

handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True)
        handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    logger.addHandler(handler)
    return logger


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    # threading.Semaphore has _value but no .locked() (asyncio's does)
    value = getattr(semaphore, "_value", "?")
    return f"Semaphore(value={value})"

