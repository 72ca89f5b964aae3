"""Device resolution and numeric precision shared by every entry point of
the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, raising if it names CUDA and no
    CUDA device is present (the port never falls back to the CPU on its
    own: the caller asks for it with device="cpu").  A CUDA device without
    an index gets the current one (torch.cuda.current_device(), which
    parallel.initialize_distributed sets to each rank's card), so tensors
    and launches land on that card and compare equal to its tensors'
    devices."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepim_tpu_torch: CUDA was requested (device=%r) but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path" % (str(device),)
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_explicit_precision() -> None:
    """Make the card compute in the dtype each tensor has, as the JAX
    package does: float32 convolutions and matmuls in float32, not TF32
    (cuDNN's default is TF32), and bfloat16 matmuls reduced in float32,
    never partly in bfloat16 (cuBLAS may do that through split-K unless
    told not to; fc6 reduces over 81,920 inputs).  Every entry point that
    builds a network calls this; the flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
