"""Import reference MXNet checkpoints into the port's FlowNetDeepIM
state_dict and export it back (counterpart of
deepim_tpu/models/import_mxnet.py).

The reference initialises from a pretrained FlowNet ``.params`` file and
saves trained checkpoints in the same format (deepim/train.py:165-195,
deepim/symbols/deepIM_flownet.py:753-845 init_weights).  MXNet lays
convolutions out (O, I, kH, kW), deconvolutions (I, O, kH, kW) and FC
layers (O, I), which are torch's own layouts, and MXNet's Deconvolution is
the adjoint of a correlation, as nn.ConvTranspose2d is; so every weight
maps unchanged but for three deltas:

* fc6's input rows: MXNet flattens conv6_1 in (c, h, w) order, the port in
  (h, w, c) order (models/flownet.py), so its columns are permuted by the
  conv6 grid of `input_hw` (the identity where that grid is 1x1);
* the first convolution's channels: the reference reads BGR images (cv2),
  the port RGB, so each of its two 3-channel image blocks is reversed; a
  checkpoint with fewer input channels than the model (a vanilla 6-channel
  FlowNetS into the recipe's 8-channel INPUT_MASK model) is widened with
  zeros (init_weights :766-775);
* the fixed x16 bilinear upsamplers (``upsampling_weight``,
  ``mask_upsampling_weight``, lr_mult=0) are interpolation matrices in the
  port, not parameters: ignored on import and synthesised on export.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from deepim_tpu_torch.models.convert import _CONVS, _DECONVS, _DENSES
from deepim_tpu_torch.models.flownet import conv6_hw


def _bgr_perm(n_channels: int) -> np.ndarray:
    """Input-channel permutation reversing each of the two 3-channel image
    blocks (observed, rendered); depth and mask channels stay.  It is its
    own inverse."""
    perm = np.arange(n_channels)
    perm[0:3] = [2, 1, 0]
    if n_channels >= 6:
        perm[3:6] = [5, 4, 3]
    return perm


def _layer_keys(template: Mapping) -> list[tuple[str, str]]:
    """(mxnet name, state_dict prefix) of every layer in `template`, in the
    JAX module's order: convolutions, deconvolutions, dense."""
    layers = list(_CONVS.items()) + [(name, f"{name}.deconv") for name in _DECONVS] + [(n, n) for n in _DENSES]
    return [(name, key) for name, key in layers if f"{key}.weight" in template]


def state_dict_from_mxnet(mx_params: Mapping[str, np.ndarray], model: nn.Module | Mapping,
                          input_hw: tuple[int, int] = (480, 640), bgr_to_rgb: bool = True,
                          strict: bool = True) -> dict[str, torch.Tensor]:
    """The state_dict of `model` (a FlowNetDeepIM or its state_dict) with
    every layer that `mx_params` (name -> array, from
    utils/mxnet_io.load_mxnet_params) holds in its place: float32 CPU
    tensors, for model.load_state_dict.  A layer the checkpoint lacks (the
    fc6/fc7/rot/trans and mask heads of a vanilla FlowNet) keeps the
    model's value unless `strict`, where it raises KeyError; a missing
    bias is zero.  Equal, tensor for tensor, to
    state_dict_from_flax(flax_from_mxnet(...)) of the JAX package."""
    template = model.state_dict() if isinstance(model, nn.Module) else model
    out = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in template.items()}
    h6, w6 = conv6_hw(*input_hw)
    for name, key in _layer_keys(template):
        wk = f"{name}_weight"
        if wk not in mx_params:
            if strict:
                raise KeyError(f"checkpoint is missing {wk}")
            continue
        want = tuple(template[f"{key}.weight"].shape)
        w = np.asarray(mx_params[wk], np.float32)
        bias = mx_params.get(f"{name}_bias")
        b = np.zeros(tuple(template[f"{key}.bias"].shape), np.float32) if bias is None \
            else np.asarray(bias, np.float32)
        if name == "flow_conv1":
            c_model, c_ckpt = want[1], w.shape[1]
            if c_ckpt > c_model:
                raise ValueError(f"checkpoint flow_conv1 has {c_ckpt} input channels, model expects {c_model}")
            if c_ckpt < c_model:
                w = np.concatenate([w, np.zeros((w.shape[0], c_model - c_ckpt) + w.shape[2:], w.dtype)], axis=1)
            if bgr_to_rgb:
                w = w[:, _bgr_perm(w.shape[1])]
        elif name == "fc6":
            c = w.shape[1] // (h6 * w6)
            if c * h6 * w6 != w.shape[1]:
                raise ValueError(f"fc6 input {w.shape[1]} inconsistent with conv6 grid {h6}x{w6}")
            w = w.reshape(w.shape[0], c, h6, w6).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
        if w.shape != want:
            raise ValueError(f"{name}: shape {w.shape} != model {want}")
        out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{key}.bias"] = torch.from_numpy(np.array(b, np.float32, copy=True))
    return out


def bilinear_kernel(ch: int) -> np.ndarray:
    """The frozen x16 bilinear upsampler the reference symbol expects
    (deepIM_flownet.py:185-199, :328-335), (ch, ch, 32, 32)."""
    f, k = 16, 32
    c = (2 * 16 - 1 - 16 % 2) / 32.0
    line = 1 - np.abs(np.arange(k) / f - c)
    kern2d = np.outer(line, line).astype(np.float32)
    w = np.zeros((ch, ch, k, k), np.float32)
    for i in range(ch):
        w[i, i] = kern2d
    return w


def mxnet_from_state_dict(state_dict: Mapping[str, torch.Tensor], input_hw: tuple[int, int] = (480, 640),
                          rgb_to_bgr: bool = True) -> dict[str, np.ndarray]:
    """Inverse of state_dict_from_mxnet: the port's weights as a
    reference-format name -> array dict (writable with
    utils/mxnet_io.save_mxnet_params), with the bilinear upsamplers of the
    heads present synthesised; equal, array for array and in the same
    order, to the JAX package's mxnet_from_flax."""
    out: dict[str, np.ndarray] = {}
    h6, w6 = conv6_hw(*input_hw)
    for name, key in _layer_keys(state_dict):
        w = state_dict[f"{key}.weight"].detach().to("cpu", torch.float32).numpy()
        if name == "flow_conv1" and rgb_to_bgr:
            w = w[:, _bgr_perm(w.shape[1])]
        elif name == "fc6":
            c = w.shape[1] // (h6 * w6)
            w = w.reshape(w.shape[0], h6, w6, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
        out[f"{name}_weight"] = np.ascontiguousarray(w)
        out[f"{name}_bias"] = state_dict[f"{key}.bias"].detach().to("cpu", torch.float32).numpy().copy()
    if "Convolution3_weight" in out:
        out["upsampling_weight"] = bilinear_kernel(2)
    if "mask_conv3_weight" in out:
        out["mask_upsampling_weight"] = bilinear_kernel(1)
    return out
