"""The package logger: console output plus an optional timestamped file
in a run directory (copy of deepim_tpu/utils/logger.py under the logger
name "deepim_tpu_torch").

Run-directory layout: <output_path>/<cfg_name>/<image_set>/, with a
log_<date>_<time>.txt file in it.
"""
from __future__ import annotations

import logging
import os
import sys
import time

logger = logging.getLogger("deepim_tpu_torch")
logger.setLevel(logging.INFO)
logger.propagate = False


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.WARNING: "\033[33m",
        logging.ERROR: "\033[31m",
        logging.CRITICAL: "\033[31m",
    }

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelno)
        return f"{color}{msg}\033[0m" if color and sys.stderr.isatty() else msg


if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(_ColorFormatter("[%(asctime)s] %(message)s", datefmt="%m%d %H:%M:%S"))
    logger.addHandler(_h)


def set_logger_dir(dirname: str) -> str:
    """Attach a file handler writing into `dirname` (a new timestamped
    file; existing logs are kept).  Returns the file's path."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, time.strftime("log_%Y%m%d_%H%M%S.txt"))
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", datefmt="%m%d %H:%M:%S"))
    logger.addHandler(fh)
    logger.info("logging to %s", path)
    return path


def run_directory(output_path: str, cfg_name: str, image_set: str) -> str:
    """<output_path>/<cfg_name>/<image_set>/, the run directory (not
    created)."""
    return os.path.join(output_path, cfg_name, image_set)


def create_logger(output_path: str, cfg_name: str, image_set: str) -> str:
    """Create <output_path>/<cfg_name>/<image_set>/, log into it, and
    return it (the run directory)."""
    run_dir = run_directory(output_path, cfg_name, image_set)
    os.makedirs(run_dir, exist_ok=True)
    set_logger_dir(run_dir)
    return run_dir
