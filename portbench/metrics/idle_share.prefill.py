"""The share of the traced prefill window in which no operation ran on
the device, in %."""


def read(ctx):
    if ctx.trace is None or not any(r["kind"] == "prefill"
                                    for r in ctx.trace_records):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
