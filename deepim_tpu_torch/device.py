"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, raising if it names CUDA and no
    CUDA device is present (the port never falls back to the CPU on its
    own: the caller asks for it with device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepim_tpu_torch: CUDA was requested (device=%r) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path" % (str(device),)
        )
    return dev
