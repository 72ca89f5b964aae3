"""kernel_launches.<kind>: device kernels a call or step launches (the traced calls' kernel events, copies and memsets left out)."""


def read(ctx):
    r = ctx.get("trace")
    return None if r is None else r["launches"] / r["calls"]
