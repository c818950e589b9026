"""The decode steps' share of their roofline over the traced batches: the
least time of every step (`roofline.decode_step_bound_ms`: the larger of
its operations over the bf16 peak and its bytes, the weights and the
written cache read once, over the HBM peak) over the traced window's
host seconds, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    recs = [r for r in ctx.trace_records if r["kind"] == "decode"]
    if not recs:
        return None
    rf = ctx.roofline
    ms = sum(rf.decode_step_bound_ms(ctx.cfg, r["batch"], pos)[0]
             for r in recs for pos in range(r["steps"]))
    return 100.0 * ms / 1e3 / ctx.trace.window_s
