"""Share of the traced window in which the device runs nothing (%)."""


def read(ctx):
    if not ctx.trace.devices:
        return None
    return 100.0 * ctx.trace.idle_share
