"""Training observability: meters, a metrics file, logger setup, step timer.

Counterpart of `range_tpu/utils/metrics.py` (reference `AverageMeter`,
`csp/main/utils.py:416-436`; the file + console logger,
`csp/main/utils.py:158-189`).  `StepTimer` fences with a CUDA synchronize
where the work ran on the card.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch


class AverageMeter:
    """Running average (csp/main/utils.py:416-436 semantics)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / float(self.count)


def setup_logger(name: str = "range_tpu_torch", log_file: Optional[str] = None,
                 console: bool = True, level=logging.INFO) -> logging.Logger:
    """File + console logger (csp/main/utils.py:158-189 equivalent)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    return logger


class MetricsWriter:
    """Append-only JSONL scalar history: one ``{"step": .., "ts": ..,
    <name>: <value>, ...}`` object per line (the reference's
    TensorBoardLogger/`self.log` analog, satclip/main_old.py:69-77)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fh = open(path, "a")

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str):
    """Load a MetricsWriter file back as a list of dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


class StepTimer:
    """Wall-clock timer for steps; `stop(tensor)` first waits for the card
    when the tensor lies on one."""

    def __init__(self):
        self.meter = AverageMeter()
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, fence: Optional[torch.Tensor] = None) -> float:
        if fence is not None and fence.is_cuda:
            torch.cuda.synchronize(fence.device)
        dt = time.perf_counter() - self._t0
        self.meter.update(dt)
        return dt
