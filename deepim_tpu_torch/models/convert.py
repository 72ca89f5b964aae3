"""Weight bridge from the JAX model's parameter tree to FlowNetDeepIM's
state_dict.

The JAX tree is nested dicts of numpy arrays (`{"params": {...}}` or the
inner dict).  Leaves are found by layer name wherever they sit (flax wraps
convolutions as Conv_N/<name> and deconvolutions as
<name>/ConvTranspose_0).  Layouts:

* conv (kh, kw, in, out) -> (out, in, kh, kw);
* Dense (in, out) -> (out, in); fc6 needs no row permutation because the
  port flattens conv6_1 in the JAX order (H*W*C); the SE(3) heads of any
  width (REGRESSOR_NUM groups of 4 or 3 rotation and 3 translation
  outputs, group-major in both packages) bridge the same way;
* flax ConvTranspose (padding VALID, no kernel transpose) is a correlation
  of the dilated input, while nn.ConvTranspose2d(k=4, s=2, p=0) is the
  adjoint of a convolution: the kernel is spatially flipped and laid out
  (in, out, kh, kw).
"""
from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.models.flownet import _ENCODER

_CONVS = {name: f"convs.{name}" for name, *_ in _ENCODER}
_CONVS.update({n: n for n in ("Convolution1", "Convolution2", "Convolution3", "mask_conv3")})
_DECONVS = ("deconv5", "deconv4", "upsample_flow6to5", "upsample_flow5to4")
_DENSES = ("fc6", "fc7", "rot", "trans")


def _find(tree, name):
    """The {'kernel', 'bias'} leaf dict for layer `name` (depth-first)."""
    if not isinstance(tree, dict):
        return None
    if name in tree:
        node = tree[name]
        while isinstance(node, dict) and "kernel" not in node and len(node) == 1:
            node = next(iter(node.values()))
        if isinstance(node, dict) and "kernel" in node:
            return node
    for v in tree.values():
        hit = _find(v, name)
        if hit is not None:
            return hit
    return None


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """JAX FlowNetDeepIM parameters -> the port's state_dict (CPU tensors).
    Layers absent from `params` are absent from the result."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}

    def put(key, kernel, bias):
        for name, arr in (("weight", kernel), ("bias", bias)):
            out[f"{key}.{name}"] = torch.from_numpy(np.array(arr, np.float32, order="C", copy=True))

    for name, key in _CONVS.items():
        leaf = _find(tree, name)
        if leaf is not None:
            put(key, np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1), leaf["bias"])
    for name in _DECONVS:
        leaf = _find(tree, name)
        if leaf is not None:
            k = np.asarray(leaf["kernel"])[::-1, ::-1]
            put(f"{name}.deconv", k.transpose(2, 3, 0, 1), leaf["bias"])
    for name in _DENSES:
        leaf = _find(tree, name)
        if leaf is not None:
            put(name, np.asarray(leaf["kernel"]).T, leaf["bias"])
    return out
