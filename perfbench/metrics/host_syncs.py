"""host_syncs.<kind>: host synchronisations in one call or step (set_sync_debug_mode warnings)."""


def read(ctx):
    return ctx.get("host_syncs")
