"""Host-side training loop: so far its logger, which the inference CLI
shares (counterpart of ``ceigm_unet_tpu/train/loop.py`` ``setup_logger``)."""
from __future__ import annotations

import logging
import os
import sys


def setup_logger(log_dir: str, name: str) -> logging.Logger:
    """Logger ``ceigm.<name>`` writing to ``<log_dir>/<name>.log`` and to
    stderr; a second call with the same name replaces its handlers."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"ceigm.{name}")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
