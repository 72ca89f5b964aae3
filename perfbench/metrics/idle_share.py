"""idle_share.<kind>: the share of a call's wall time in which no device operation ran, %: the traced calls'
device busy time a call over the untraced window's wall time a call, so the profiler's own host work does
not count as idle."""


def read(ctx):
    r = ctx.get("trace")
    if r is None:
        return None
    return (1.0 - (r["busy_s"] / r["calls"]) / (ctx["window_s"] / ctx["calls"])) * 100.0
