"""Throughput logging (deepim/core/callback.py:11-43 Speedometer; the
message format of deepim_tpu/utils/speedometer.py, through the port's
logger)."""
from __future__ import annotations

import time

from deepim_tpu_torch.utils.logger import logger


class Speedometer:
    """Called once per batch; every `frequent` batches logs the samples/s
    since the last report and the metrics it is given."""

    def __init__(self, batch_size: int, frequent: int = 20):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, epoch: int, nbatch: int, metrics: dict | None = None) -> None:
        if nbatch < self.last_count:
            self.init = False
        self.last_count = nbatch
        if self.init:
            if nbatch % self.frequent == 0:
                speed = self.frequent * self.batch_size / (time.time() - self.tic)
                msg = f"Epoch[{epoch}] Batch [{nbatch}]\tSpeed: {speed:.2f} samples/sec"
                if metrics:
                    msg += "\t" + "\t".join(f"{k}={v:.6f}" for k, v in metrics.items())
                logger.info(msg)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()
