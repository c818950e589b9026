"""The share of the traced decode window in which no operation ran on the
device, in %."""


def read(ctx):
    if ctx.trace is None or not any(r["kind"] == "decode"
                                    for r in ctx.trace_records):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
