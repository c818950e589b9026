"""The prefill step's share of the bf16 peak over the traced batches:
the model's operations from shapes (`roofline.prefill_flops`: every
token through every block with the two chosen experts for MoE, causal
attention over the kept pairs, the LM head once a prompt) over the
traced window's host seconds, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    recs = [r for r in ctx.trace_records if r["kind"] == "prefill"]
    if not recs:
        return None
    rf = ctx.roofline
    ops = sum(rf.prefill_flops(ctx.cfg, r["batch"], r["length"])
              for r in recs)
    return 100.0 * ops / rf.BF16_OPS_PER_S / ctx.trace.window_s
