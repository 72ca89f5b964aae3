"""Per-sample channel-group selection for class-conditioned regressor heads
(PyTorch counterpart of deepim_tpu/ops/group_picker.py).

With REGRESSOR_NUM = num_classes the SE(3) head emits num_groups * C
channels and each sample keeps the group of its object class.  Autograd
of the gather gives the reference's scatter backward: the gradient reaches
the picked group and is zero elsewhere.
"""
from __future__ import annotations

import torch


def group_pick(x: torch.Tensor, class_index: torch.Tensor, num_groups: int) -> torch.Tensor:
    """x: (B, num_groups * C); class_index: (B,) ints, 0-based group ids or
    1-based class ids (the pairdb convention): values >= num_groups are
    read 1-based, as the JAX package folds them.  Returns (B, C)."""
    b, total = x.shape
    if total % num_groups:
        raise ValueError(f"{total} channels do not split into {num_groups} groups")
    idx = torch.as_tensor(class_index, device=x.device).long()
    idx = torch.where(idx >= num_groups, idx - 1, idx)
    grouped = x.reshape(b, num_groups, total // num_groups)
    return grouped[torch.arange(b, device=x.device), idx]
