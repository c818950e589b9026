"""The flash-attention kernels' share of their roofline in the traced
prefills: the summed least time of every call (`roofline.flash_bound_ms`,
one a layer) over the profiler's device time of the
kernels named flash_kernel* and no_key_rows_kernel, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    recs = [r for r in ctx.trace_records if r["kind"] == "prefill"]
    secs, n = ctx.trace.kernel_s("flash_kernel", "no_key_rows_kernel")
    if not recs or not n:
        return None
    c, rf = ctx.cfg, ctx.roofline
    ms = sum(c.n_layers * rf.flash_bound_ms(
        r["batch"], c.n_heads, r["length"], r["length"], c.head_dim,
        rf.BF16, c.n_kv_heads, c.sliding_window)[0] for r in recs)
    return 100.0 * ms / 1e3 / secs
