"""glue_ms.<kind>: device ms a call or step outside every named family (elementwise, index, copies, layout)."""
from perfbench.yardstick.trace import OTHER


def read(ctx):
    r = ctx.get("trace")
    return None if r is None else r["family_s"][OTHER] / r["calls"] * 1e3
