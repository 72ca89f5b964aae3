"""TensorBoard scalar logging (TRAIN.TENSORBOARD_LOG; counterpart of
deepim_tpu/utils/tb.py).

The reference logs lr and the per-batch losses when TENSORBOARD_LOG is set
(deepim/core/module.py:1096-1158), plus the L2 norm of every weight
(:1113-1122).  The scalars go through torch.utils.tensorboard when it
imports; without it the logger is a no-op, so training never depends on
TensorBoard being installed.
"""
from __future__ import annotations

import torch


class TBLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard not installed: stay a no-op
            return
        self._writer = SummaryWriter(log_dir=log_dir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def scalars(self, metrics: dict[str, float], step: int, prefix: str = "train") -> None:
        if self._writer is None:
            return
        for name, value in metrics.items():
            self._writer.add_scalar(f"{prefix}/{name}", float(value), step)

    def weight_norms(self, model: torch.nn.Module, step: int) -> None:
        """The L2 norm of every state_dict entry, as weights/<name>."""
        if self._writer is None:
            return
        for name, tensor in model.state_dict().items():
            self._writer.add_scalar(f"weights/{name}", float(torch.linalg.vector_norm(tensor.float())), step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
