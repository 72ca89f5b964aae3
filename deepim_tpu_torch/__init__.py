"""PyTorch/CUDA port of deepim_tpu: the render-and-compare 6D pose refiner
on an NVIDIA H100.

The package mirrors deepim_tpu's module layout and function names
(geometry/, render/, ops/, models/, engine/, data/, eval/, tools/,
utils/) so each module's counterpart is easy to find.  It imports torch,
numpy and scipy only -- never JAX, nothing of deepim_tpu, and none of
cv2, PIL, yaml or torchvision (utils/imread.py, over utils/png.py and
utils/jpeg.py, reads images as cv2.imread does; utils/yaml_subset.py
reads configs).  The rasterizer's three kernels are CUDA C++
(csrc/raster.cu), built with nvcc at first use; every kernel has a plain
PyTorch twin that runs on CPU tensors.

Entry points take `device` (default "cuda") and raise when CUDA is absent
and the caller did not ask for the CPU.
"""
from deepim_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
