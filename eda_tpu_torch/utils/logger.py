"""Run logging (counterpart of ``eda_tpu/utils/logger.py``, reference ``utils/logger.py:35-99``).

The console and ``log.txt`` in the log directory, in the JAX package's
format. One process runs the port, so there is no per-rank file yet.
"""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(log_dir: str, name: str = "eda_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False

    fmt = logging.Formatter("[%(asctime)s %(levelname)s] %(message)s", datefmt="%H:%M:%S")
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(fmt)
    logger.addHandler(console)

    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger
