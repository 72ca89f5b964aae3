"""mfu.<kind>: the network's operations over the untraced window at the bf16 dense peak, %."""
from perfbench.yardstick.flops import PEAK_BF16_FLOP_S


def read(ctx):
    if "net_flops_call" not in ctx:
        return None
    return ctx["net_flops_call"] * ctx["calls"] / ctx["window_s"] / PEAK_BF16_FLOP_S * 100.0
