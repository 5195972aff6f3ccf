"""Experiment management: save directories, logging, metric writers.

Counterpart of ``causal_gen_tpu/train/experiment.py`` (reference
src/train_setup.py:56-134): non-interactive, and the metric writer always
writes JSONL, with TensorBoard as a second sink only where its package is
installed.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def setup_directories(save_dir: str, exist_ok: bool = True) -> str:
    os.makedirs(save_dir, exist_ok=exist_ok)
    return save_dir


def setup_logging(save_dir: Optional[str] = None, name: str = "causal_gen_tpu_torch"):
    """File + stream logging (reference train_setup.py:119-134)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s | %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if save_dir:
        path = os.path.abspath(os.path.join(save_dir, "trainlog.txt"))
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == path
                   for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricWriter:
    """JSONL metric stream, plus TensorBoard when it is installed
    (reference train_setup.py:81-116)."""

    def __init__(self, save_dir: Optional[str] = None, tensorboard: bool = True):
        self.save_dir = save_dir
        self._jsonl = None
        self._tb = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:  # the tensorboard package is optional
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir=save_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"ts": time.time(), "tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.add_scalar(f"{prefix}{k}" if prefix else k, v, step)

    def add_hparams(self, hparams: Dict[str, Any]) -> None:
        if self.save_dir:
            with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
                json.dump(hparams, f, indent=2, default=str)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
