"""conv_roofline.<kind>: a call's convolution operations at the bf16 dense peak over the convolution kernels'
device time a call, %."""
from perfbench.yardstick.flops import PEAK_BF16_FLOP_S


def read(ctx):
    r = ctx.get("trace")
    if r is None:
        return None
    secs = r["family_s"]["convolutions"] / r["calls"]
    return None if secs <= 0 else ctx["conv_flops_call"] / PEAK_BF16_FLOP_S / secs * 100.0
