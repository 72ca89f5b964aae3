"""Operation counts of the matching network and the H100's peaks: the
benchmark's frozen yardstick for rooflines and MFU.

conv_flops is a frozen copy of chip_smoke.conv_flops (2 operations a
multiply-add; a transposed convolution over its whole output before the
crop).  dense_flops adds fc6, fc7 and the SE(3) heads.  Training counts
each layer's input and weight gradients beside its forward (3x), less
flow_conv1's input gradient, which no update needs.
"""
from __future__ import annotations

from perfbench.reference.net import ENCODER, conv6_hw, conv_out

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOP_S = 989e12
PEAK_FP32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12


def conv_flops(hw: tuple[int, int], in_ch: int, full: bool) -> tuple[float, float]:
    """(forward operations of one sample through the convolutions and
    transposed convolutions, those of flow_conv1 alone)."""
    h, w = hw
    sizes, total = {}, 0.0
    for name, cin, cout, k, s, p in ENCODER:
        ho, wo = conv_out(h, k, s, p), conv_out(w, k, s, p)
        total += 2.0 * (cin or in_ch) * cout * k * k * ho * wo
        sizes[name], (h, w) = (ho, wo), (ho, wo)
    first = 2.0 * in_ch * 64 * 49 * sizes["flow_conv1"][0] * sizes["flow_conv1"][1]
    if full:
        (h6, w6), (h5, w5), (h4, w4) = sizes["conv6_1"], sizes["conv5_1"], sizes["conv4_1"]
        total += 2.0 * 1024 * 2 * 9 * h6 * w6                 # Convolution1
        total += 2.0 * (1024 * 512 + 2 * 2) * 16 * h6 * w6    # deconv5, upsample_flow6to5
        total += 2.0 * 1026 * 2 * 9 * h5 * w5                 # Convolution2
        total += 2.0 * (1026 * 256 + 2 * 2) * 16 * h5 * w5    # deconv4, upsample_flow5to4
        total += 2.0 * 770 * 3 * 9 * h4 * w4                  # Convolution3, mask_conv3
    return total, first


def dense_flops(hw: tuple[int, int]) -> float:
    """Forward operations of one sample through fc6, fc7 and the heads."""
    h6, w6 = conv6_hw(*hw)
    return 2.0 * (1024 * h6 * w6 * 256 + 256 * 256 + 256 * 7)


def call_flops(hw, in_ch: int, samples: int, iters: int, train: bool) -> tuple[float, float]:
    """(convolution operations, all network operations) of one refine call
    (the FAST_TEST forward) or one training call (the full network,
    forward and backward), `samples` a batch and `iters` iterations."""
    conv, first = conv_flops(hw, in_ch, full=train)
    dense = dense_flops(hw)
    if train:
        conv, dense = 3 * conv - first, 3 * dense
    return conv * samples * iters, (conv + dense) * samples * iters
