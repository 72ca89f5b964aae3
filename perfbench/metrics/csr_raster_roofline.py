"""csr_raster_roofline.<kind>: the traced calls' renders' least time (perfbench/yardstick/work.py) over
csr_raster's device time in them, %; nothing where csr_raster did not run."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or "raster_bound_s" not in ctx:
        return None
    secs = sum(s for name, s in r["op_s"].items() if "csr_raster_kernel" in name)
    return None if secs <= 0 else ctx["raster_bound_s"] / secs * 100.0
