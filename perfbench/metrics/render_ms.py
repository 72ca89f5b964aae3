"""render_ms.<kind>: device ms a call or step of the raster kernels and the binning's sort and scan kernels."""


def read(ctx):
    r = ctx.get("trace")
    return None if r is None else (r["family_s"]["raster"] + r["family_s"]["sort_scan"]) / r["calls"] * 1e3
