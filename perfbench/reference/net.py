"""Plain FlowNetS matching network of DeepIM, float32, as functions of a
parameter dict.

Encoder: convolutions 64/128/256/256/512/512/512/512/1024/1024 (kernels
7, 5, 5, 3, ...; stride 2 at conv1/2/3/4/5/6), LeakyReLU(0.1) after each.
SE(3) head: conv6_1 flattened in (H, W, C) order -> fc6 256 -> fc7 256
(LeakyReLU) -> a unit quaternion (4) and an untangled translation (3).
Flow and mask heads (training): deconv5 / deconv4 (kernel 4, stride 2,
cropped at 1) with the coarser flow upsampled alongside, concatenated with
the encoder's conv5_1 / conv4_1, a 3x3 convolution to 2 flow channels and
1 mask channel, and a fixed x16 bilinear upsample cropped at 8.

`quant` names a rounding applied to every convolution's and dense layer's
two operands (the control of the benchmark's comparison); None computes in
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ENCODER = (
    # name, cin (None: the input's), cout, kernel, stride, pad
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


def conv6_hw(h: int, w: int) -> tuple[int, int]:
    for _, _, _, k, s, p in ENCODER:
        h, w = conv_out(h, k, s, p), conv_out(w, k, s, p)
    return h, w


def param_shapes(in_ch: int, hw: tuple[int, int], heads: bool) -> dict[str, tuple]:
    """Parameter name -> shape, named as the measured network's state dict."""
    shapes = {}
    for name, cin, cout, k, _, _ in ENCODER:
        shapes[f"convs.{name}.weight"] = (cout, cin or in_ch, k, k)
        shapes[f"convs.{name}.bias"] = (cout,)
    h6, w6 = conv6_hw(*hw)
    for name, fin, fout in (("fc6", 1024 * h6 * w6, 256), ("fc7", 256, 256), ("rot", 256, 4), ("trans", 256, 3)):
        shapes[f"{name}.weight"] = (fout, fin)
        shapes[f"{name}.bias"] = (fout,)
    if heads:
        for name, cin, cout in (("Convolution1", 1024, 2), ("Convolution2", 1026, 2), ("Convolution3", 770, 2),
                                ("mask_conv3", 770, 1)):
            shapes[f"{name}.weight"] = (cout, cin, 3, 3)
            shapes[f"{name}.bias"] = (cout,)
        for name, cin, cout in (("deconv5", 1024, 512), ("upsample_flow6to5", 2, 2), ("deconv4", 1026, 256),
                                ("upsample_flow5to4", 2, 2)):
            shapes[f"{name}.deconv.weight"] = (cin, cout, 4, 4)
            shapes[f"{name}.deconv.bias"] = (cout,)
    return shapes


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), slope 1 at exactly 0."""
    return torch.where(x >= 0, x, 0.1 * x)


def _bilinear(size_in: int, size_out: int, dev, factor: int = 16, offset: int = 8) -> torch.Tensor:
    """(size_out, size_in) matrix of the fixed bilinear deconvolution
    (kernel 2f, stride f) cropped at `offset`."""
    c = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    kern = [1 - abs(i / factor - c) for i in range(2 * factor)]
    m = torch.zeros((size_out, size_in), dtype=torch.float32)
    for j in range(size_in):
        for ki, kv in enumerate(kern):
            o = j * factor + ki - offset
            if 0 <= o < size_out:
                m[o, j] += kv
    return m.to(dev)


def forward(p: dict, x: torch.Tensor, heads: bool, quant=None) -> dict:
    """x: (B, C, H, W) float32 -> {'rot' (B, 4) unit, 'trans' (B, 3)[, 'flow'
    (B, 2, H, W), 'mask_logit' (B, 1, H, W)]}."""
    q = quant or (lambda t: t)

    def conv(name, y, stride=1, pad=1):
        return F.conv2d(q(y), q(p[name + ".weight"]), p[name + ".bias"], stride=stride, padding=pad)

    def dense(name, y):
        return F.linear(q(y), q(p[name + ".weight"]), p[name + ".bias"])

    def deconv(name, y, h, w):
        out = F.conv_transpose2d(q(y), q(p[name + ".deconv.weight"]), p[name + ".deconv.bias"], stride=2)
        return out[:, :, 1:1 + h, 1:1 + w]

    h_in, w_in = x.shape[-2:]
    feats = {}
    y = x
    for name, _, _, _, s, pad in ENCODER:
        y = leaky(conv("convs." + name, y, s, pad))
        feats[name] = y
    c6 = feats["conv6_1"]
    flat = c6.permute(0, 2, 3, 1).reshape(c6.shape[0], -1)
    fc7 = leaky(dense("fc7", leaky(dense("fc6", flat))))
    rot = dense("rot", fc7)
    out = {"rot": rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True), min=1e-12),
           "trans": dense("trans", fc7)}
    if heads:
        c5, c4 = feats["conv5_1"], feats["conv4_1"]
        h5, w5, h4, w4 = c5.shape[2], c5.shape[3], c4.shape[2], c4.shape[3]
        flow6 = conv("Convolution1", c6)
        cat2 = torch.cat([c5, leaky(deconv("deconv5", c6, h5, w5)), deconv("upsample_flow6to5", flow6, h5, w5)], 1)
        flow5 = conv("Convolution2", cat2)
        cat3 = torch.cat([c4, leaky(deconv("deconv4", cat2, h4, w4)), deconv("upsample_flow5to4", flow5, h4, w4)], 1)
        mh = _bilinear(h4, h_in, x.device)
        mw = _bilinear(w4, w_in, x.device)
        for key, name in (("flow", "Convolution3"), ("mask_logit", "mask_conv3")):
            out[key] = torch.einsum("oh,bchw,pw->bcop", mh, conv(name, cat3), mw)
    return out


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448), as float32; gradients pass straight through."""
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / 448.0
    r = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (r - t).detach()


QUANT = {"float32": None, "fp8_e4m3": fp8_e4m3}

