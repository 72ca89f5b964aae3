"""FlowNetS-style matching network with SE(3), flow and mask heads
(PyTorch counterpart of deepim_tpu/models/flownet.py; NCHW inside).

* encoder: conv ladder 64/128/256/256/512/512/512/512/1024/1024,
  LeakyReLU(0.1), stride 2 at conv1/2/3/4/5/6, MXNet padding arithmetic
  (480x640 -> ... -> 8x10);
* SE(3) head: flatten conv6_1 in H*W*C order (as the JAX model does, so
  fc6 weights bridge unchanged at any input size) -> FC256 -> FC256 ->
  {FC4 L2-normalized quaternion, FC3 translation in zoomed pixels};
* flow decoder / mask head: deconv5/deconv4 skip refinement (k4 s2 then a
  crop at 1), per-scale flow convs, and the frozen x16 bilinear upsample +
  crop(8) as two interpolation-matrix products.

With pred_flow and pred_mask both off (the FAST_TEST eval graph) only the
encoder and the SE(3) head are built and run.

Precision follows flax's `dtype`: parameters are always float32; with
dtype=torch.bfloat16 the input is cast to bf16 and every convolution,
transposed convolution and dense layer multiplies bf16 input by the
bf16-cast weight with float32 accumulation, rounds to bf16 and then adds
the bf16-cast bias (two roundings, as XLA computes flax's layers, not
cuDNN's fused bias).  LeakyReLU and the concatenations run in bf16, the
x16 upsample rounds to bf16 after each of its two products, and the heads
leave the network as float32.  On the card the layers are cuDNN/cuBLAS
bf16 calls; on the CPU (the plain version) they are float32 calls on the
bf16-rounded operands, rounded once, which is what XLA's CPU compiler
does.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.ops.group_picker import group_pick


class _Leaky(torch.autograd.Function):
    """LeakyReLU(0.1) whose derivative at exactly 0 is 1, as JAX's
    where(x >= 0, x, 0.1 x) gives (torch's leaky_relu gives 0.1 there).  It
    matters at initialisation: with zero biases, the zero pixels outside a
    zoomed crop give exactly-zero pre-activations over most of the early
    feature maps, and the bias gradients of those layers then differ by up
    to 2x between the two slopes.  The slope is 0.1 in the tensor's dtype
    (bf16: 0.10009765625), as JAX casts its weak-typed constant; leaky_relu
    with slope 0.1 would multiply a bf16 tensor by float32 0.1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, negative_slope=_slope(x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * _slope(g))


def _slope(x: torch.Tensor) -> float:
    """0.1 rounded to x's dtype, as a Python number (a bf16 product by it is
    exact in the float32 arithmetic torch uses, then rounded once)."""
    return 0.1 if x.dtype == torch.float32 else _SLOPE_BF16


_SLOPE_BF16 = float(torch.tensor(0.1, dtype=torch.bfloat16))


def leaky(x):
    return _Leaky.apply(x)


@lru_cache(maxsize=None)
def _bilinear_matrix(size_in: int, size_out: int, factor: int, offset: int) -> np.ndarray:
    """(size_out, size_in) matrix of MXNet's fixed bilinear deconvolution
    (kernel 2f, stride f) followed by a crop at `offset`."""
    f = factor
    k = 2 * f
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    kern = np.array([1 - abs(i / f - c) for i in range(k)], np.float32)
    m = np.zeros((size_out, size_in), np.float32)
    for j in range(size_in):
        for ki in range(k):
            o = j * f + ki - offset
            if 0 <= o < size_out:
                m[o, j] += kern[ki]
    return m


def fixed_bilinear_upsample(x: torch.Tensor, out_h: int, out_w: int, factor: int = 16,
                            offset: int = 8) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, out_h, out_w) through the frozen x16 bilinear
    deconv + crop(8), as two matrix products, each accumulated in float32
    and rounded to x's dtype (the matrices' entries, multiples of 1/32, are
    exact in bf16)."""
    _, _, h, w = x.shape
    mh = torch.from_numpy(_bilinear_matrix(h, out_h, factor, offset)).to(x.device, x.dtype)
    mw = torch.from_numpy(_bilinear_matrix(w, out_w, factor, offset)).to(x.device, x.dtype)
    y = _rounded(torch.einsum, "oh,bchw->bcow", mh, x)
    return _rounded(torch.einsum, "pw,bcow->bcop", mw, y)


def _rounded(fn, *args, **kwargs) -> torch.Tensor:
    """fn on its tensor arguments, accumulated in float32 and rounded once to
    their dtype.  float32 and CUDA tensors go to fn as they are (cuDNN and
    cuBLAS accumulate bf16 products in float32, with
    allow_bf16_reduced_precision_reduction off); bf16 CPU tensors are
    widened first, the plain version of what the card computes."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dt = tensors[0].dtype
    if dt == torch.float32 or tensors[0].device.type != "cpu":
        return fn(*args, **kwargs)
    wide = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    return fn(*wide, **kwargs).to(dt)


def _layer(mod: nn.Module, x: torch.Tensor, fn, **kwargs) -> torch.Tensor:
    """A Conv2d, ConvTranspose2d or Linear (fn its functional form) in x's
    dtype: float32 as the module computes it; bf16 as flax does, the bias
    added after the product is rounded."""
    if x.dtype == torch.float32:
        return mod(x)
    y = _rounded(fn, x, mod.weight.to(x.dtype), None, **kwargs)
    bias = mod.bias.to(x.dtype)
    return y + (bias if fn is F.linear else bias[:, None, None])


def conv(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return _layer(mod, x, F.conv2d, stride=mod.stride, padding=mod.padding)


def dense(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return _layer(mod, x, F.linear)


class Deconv(nn.Module):
    """MXNet Deconvolution k4 s2 p0 (out = 2 in + 2) then Crop(1, 1) to the
    skip feature's size."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=0, device=device)

    def forward(self, x, out_h: int, out_w: int):
        y = _layer(self.deconv, x, F.conv_transpose2d, stride=self.deconv.stride)
        return y[:, :, 1:1 + out_h, 1:1 + out_w]


_ENCODER = (
    # name, cin, cout, kernel, stride, pad
    ("flow_conv1", None, 64, 7, 2, 3),
    ("conv2", 64, 128, 5, 2, 2),
    ("conv3", 128, 256, 5, 2, 2),
    ("conv3_1", 256, 256, 3, 1, 1),
    ("conv4", 256, 512, 3, 2, 1),
    ("conv4_1", 512, 512, 3, 1, 1),
    ("conv5", 512, 512, 3, 2, 1),
    ("conv5_1", 512, 512, 3, 1, 1),
    ("conv6", 512, 1024, 3, 2, 1),
    ("conv6_1", 1024, 1024, 3, 1, 1),
)


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv6_hw(height: int, width: int) -> tuple[int, int]:
    """Spatial size of conv6_1 for an (height, width) input."""
    for _, _, _, k, s, p in _ENCODER:
        height, width = conv_out(height, k, s, p), conv_out(width, k, s, p)
    return height, width


class FlowNetDeepIM(nn.Module):
    """The matching network.  Input (B, C, H, W): zoomed observed and
    rendered images (already /255) plus depth and mask channels
    (assemble_input).

    Returns a dict with 'rot' (B, 4) unit quaternion, or (B, 3) 'sxyz'
    Euler angles with rot_dim=3, 'trans' (B, 3) in zoomed-pixel units and,
    when enabled, 'flow' (B, 2, H, W) and 'mask_logit' (B, 1, H, W), all
    float32 whatever `dtype` the network computes in (float32 or bfloat16,
    see the module docstring).  With num_regressors > 1 the SE(3) head has
    one group of outputs per class and forward takes each sample's
    class_index (group_pick).  `input_hw` sizes fc6; weights are drawn from
    `generator` (a seeded torch.Generator) with the JAX model's init rules:
    Xavier-uniform FCs, the quaternion head's w-column trick (a zero EULER
    head: the identity rotation), a zero translation head and N(0, 0.01)
    mask conv; convolutions use LeCun normal, flax's default.  On the meta
    device no weights are drawn: the caller assigns them
    (load_state_dict(assign=True))."""

    def __init__(self, in_channels: int = 8, input_hw: tuple[int, int] = (480, 640),
                 pred_flow: bool = True, pred_mask: bool = True, num_regressors: int = 1,
                 rot_dim: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if rot_dim not in (3, 4):
            raise ValueError(f"rot_dim must be 3 (EULER) or 4 (QUAT), got {rot_dim}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        dev = resolve_device(device)
        self.pred_flow, self.pred_mask = pred_flow, pred_mask
        self.num_regressors, self.rot_dim, self.dtype = num_regressors, rot_dim, dtype
        self.input_hw = tuple(input_hw)
        convs = {}
        for name, cin, cout, k, s, p in _ENCODER:
            convs[name] = nn.Conv2d(cin or in_channels, cout, k, stride=s, padding=p, device=dev)
        self.convs = nn.ModuleDict(convs)
        h6, w6 = conv6_hw(*self.input_hw)
        self.fc6 = nn.Linear(1024 * h6 * w6, 256, device=dev)
        self.fc7 = nn.Linear(256, 256, device=dev)
        self.rot = nn.Linear(256, rot_dim * num_regressors, device=dev)
        self.trans = nn.Linear(256, 3 * num_regressors, device=dev)
        if pred_flow or pred_mask:
            self.Convolution1 = nn.Conv2d(1024, 2, 3, padding=1, device=dev)
            self.deconv5 = Deconv(1024, 512, device=dev)
            self.upsample_flow6to5 = Deconv(2, 2, device=dev)
            self.Convolution2 = nn.Conv2d(1026, 2, 3, padding=1, device=dev)
            self.deconv4 = Deconv(1026, 256, device=dev)
            self.upsample_flow5to4 = Deconv(2, 2, device=dev)
        if pred_flow:
            self.Convolution3 = nn.Conv2d(770, 2, 3, padding=1, device=dev)
        if pred_mask:
            self.mask_conv3 = nn.Conv2d(770, 1, 3, padding=1, device=dev)
        if dev.type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        g = generator
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # LeCun normal (flax's default): fan_in = in * kh * kw.
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncated-normal scale
                w = torch.empty(m.weight.shape, device="cpu")
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                m.weight.copy_(w * std)
                m.bias.zero_()
        for lin in (self.fc6, self.fc7):
            bound = math.sqrt(6.0 / (lin.in_features + lin.out_features))
            lin.weight.copy_(torch.empty(lin.weight.shape).uniform_(-bound, bound, generator=g))
            lin.bias.zero_()
        if self.rot_dim == 4:
            # Every 4th output row (each group's w) starts near 1.
            w = torch.rand(self.rot.weight.shape, generator=g) * 0.01
            w[0::4] = torch.rand(w[0::4].shape, generator=g) + 0.01
            self.rot.weight.copy_(w)
        else:
            self.rot.weight.zero_()
        self.rot.bias.zero_()
        self.trans.weight.zero_()
        self.trans.bias.zero_()
        if self.pred_mask:
            self.mask_conv3.weight.copy_(torch.randn(self.mask_conv3.weight.shape, generator=g) * 0.01)

    def forward(self, x: torch.Tensor, class_index: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        h_in, w_in = x.shape[2], x.shape[3]
        feats = {}
        y = x.to(self.dtype)
        for name, *_ in _ENCODER:
            y = leaky(conv(self.convs[name], y))
            feats[name] = y
        c6_1, c5_1, c4_1 = feats["conv6_1"], feats["conv5_1"], feats["conv4_1"]
        flat = c6_1.permute(0, 2, 3, 1).reshape(c6_1.shape[0], -1)  # H*W*C order
        fc7 = leaky(dense(self.fc7, leaky(dense(self.fc6, flat))))
        rot, trans = dense(self.rot, fc7), dense(self.trans, fc7)
        if self.num_regressors > 1:
            if class_index is None:
                raise ValueError("num_regressors > 1 requires class_index")
            rot = group_pick(rot, class_index, self.num_regressors)
            trans = group_pick(trans, class_index, self.num_regressors)
        rot = rot.float()
        if self.rot_dim == 4:
            rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True), min=1e-12)
        out = {"rot": rot, "trans": trans.float()}
        if self.pred_flow or self.pred_mask:
            flow6 = conv(self.Convolution1, c6_1)
            h5, w5 = c5_1.shape[2], c5_1.shape[3]
            d5 = leaky(self.deconv5(c6_1, h5, w5))
            up6 = self.upsample_flow6to5(flow6, h5, w5)
            cat2 = torch.cat([c5_1, d5, up6], dim=1)
            flow5 = conv(self.Convolution2, cat2)
            h4, w4 = c4_1.shape[2], c4_1.shape[3]
            d4 = leaky(self.deconv4(cat2, h4, w4))
            up5 = self.upsample_flow5to4(flow5, h4, w4)
            cat3 = torch.cat([c4_1, d4, up5], dim=1)
            if self.pred_flow:
                out["flow"] = fixed_bilinear_upsample(conv(self.Convolution3, cat3), h_in, w_in).float()
            if self.pred_mask:
                out["mask_logit"] = fixed_bilinear_upsample(conv(self.mask_conv3, cat3), h_in, w_in).float()
        return out


def assemble_input(image_observed, image_rendered, depth_observed=None, depth_rendered=None,
                   mask_observed=None, mask_rendered=None):
    """Concatenate NCHW network inputs; images raw [0, 255] and depths are
    scaled by 1/255 (a bf16 image is divided in bf16, as JAX's weak-typed
    constant keeps it; torch.cat then widens to float32 beside float32
    channels, as jnp.concatenate does)."""
    parts = [image_observed / 255.0, image_rendered / 255.0]
    if depth_observed is not None:
        parts += [depth_observed / 255.0, depth_rendered / 255.0]
    if mask_observed is not None:
        parts += [mask_observed, mask_rendered]
    return torch.cat(parts, dim=1)
