"""Visibility masks from depth maps (PyTorch counterpart of
deepim_tpu/utils/visibility.py; Hodan's pysixd, the reference's
lib/utils/visibility.py).  Depths are compared in float32."""
from __future__ import annotations

import torch


def estimate_visib_mask(d_test: torch.Tensor, d_model: torch.Tensor, delta: float) -> torch.Tensor:
    """Model pixels visible in the test depth: both depths positive and the
    model's at most `delta` behind the test's.  -> bool, the inputs' shape."""
    valid = (d_test > 0) & (d_model > 0)
    return ((d_model.to(torch.float32) - d_test.to(torch.float32)) <= delta) & valid


def estimate_visib_mask_gt(d_test: torch.Tensor, d_gt: torch.Tensor, delta: float) -> torch.Tensor:
    return estimate_visib_mask(d_test, d_gt, delta)


def estimate_visib_mask_est(d_test: torch.Tensor, d_est: torch.Tensor, visib_gt: torch.Tensor,
                            delta: float) -> torch.Tensor:
    """The estimate's visible pixels, plus every gt-visible pixel the
    estimate covers."""
    visib_est = estimate_visib_mask(d_test, d_est, delta)
    return visib_est | (visib_gt & (d_est > 0))
