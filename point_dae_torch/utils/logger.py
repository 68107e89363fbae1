"""Logging and scalar metric sinks (the port's copy of
``point_dae_tpu/utils/logger.py``).

Log-line formats are an API in the reference (``parse_test_res.py`` regex-
scrapes '[Validation] EPOCH:', '[TEST] acc = ' lines); we keep the same
formats in the engine so the same aggregation tooling works. Scalars go to a
JSONL sink (always) and TensorBoard where ``torch.utils.tensorboard``
imports (the reference used tensorboardX, ``main.py:37-43``); a host without
the ``tensorboard`` package writes the JSONL sink alone.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

from ..parallel.mesh import get_mesh

_loggers: Dict[str, logging.Logger] = {}


def get_logger(name: str = "PointDAE", log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """The named logger, to the console and ``log_file``; under a process
    group only rank 0 opens the file."""
    if not get_mesh().is_main:
        log_file = None
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if name in _loggers:
        logger = _loggers[name]
        # a cached logger must still honor a NEW log_file (a second
        # experiment run in the same process would otherwise write into the
        # first run's file and leave its own experiment dir without a log —
        # the log-line formats are an API scraped per experiment dir).
        # The previous run's file handler is REPLACED, not kept: appending
        # run 2's lines to run 1's file would make run 1's directory report
        # run 2's results to the scraper.
        if log_file is not None and not any(
                isinstance(h, logging.FileHandler)
                and h.baseFilename == os.path.abspath(log_file)
                for h in logger.handlers):
            for h in [h for h in logger.handlers
                      if isinstance(h, logging.FileHandler)]:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(log_file), exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        return logger
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _loggers[name] = logger
    return logger


def print_log(msg: str, logger: Optional[str | logging.Logger] = None,
              level: int = logging.INFO) -> None:
    """Log ``msg``; under a process group rank 0 alone logs."""
    if not get_mesh().is_main:
        return
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    else:
        get_logger(logger).log(level, msg)


class ScalarWriter:
    """Writes scalars to <dir>/scalars.jsonl and TensorBoard when available;
    under a process group rank 0 alone writes."""

    def __init__(self, log_dir: Optional[str]):
        self._jsonl = None
        self._tb = None
        if log_dir is None or not get_mesh().is_main:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "t": time.time()}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
