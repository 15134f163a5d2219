"""File+stream logger (mirror of ``founddiff_tpu/utils/logger.py``; reference
``get_logger`` src/util.py:274-290)."""

from __future__ import annotations

import logging


def get_logger(filename: str, verbosity: int = 1, name: str | None = None):
    level_dict = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING}
    formatter = logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] %(message)s"
    )
    logger = logging.getLogger(name or filename)
    logger.setLevel(level_dict[verbosity])
    # avoid duplicate handlers on repeated calls
    logger.handlers.clear()

    fh = logging.FileHandler(filename, "a")
    fh.setFormatter(formatter)
    logger.addHandler(fh)

    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    return logger
