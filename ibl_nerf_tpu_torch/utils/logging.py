"""Console logging and scalar metric writing.

Counterpart of ibl_nerf_tpu/utils/logging.py: named console loggers,
and scalars written to an append-only `metrics.jsonl` in the logdir --
and to TensorBoard when `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import json
import logging
import os

_LOGGERS: dict[str, logging.Logger] = {}


def load_logger(name: str) -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s|%(name)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


class ScalarWriter:
    """metrics.jsonl (+ TensorBoard) scalar writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            pass

    def write(self, step: int, scalars: dict):
        self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(k, v, step)
                except Exception:
                    pass

    def write_images(self, tag: str, images, step: int):
        if self._tb is not None:
            try:
                self._tb.add_images(tag, images, step, dataformats="NHWC")
            except Exception:
                pass

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
