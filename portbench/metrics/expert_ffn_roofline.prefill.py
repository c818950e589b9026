"""The expert products' share of the roofline of their useful work, from
the program's own spans. For each layer of each whole batch among the
newest `len(ctx.records)` prefill batches the process's step tracer
holds: every token's k chosen experts, three products of 2*d*f
operations each, against the bf16 peak, or all E experts' weights read
once from HBM, whichever bounds (`roofline.bound`); summed, over the
device time of the "experts" spans (the three batched products and the
SiLU product), in %. The rows the capacity adds past T*k, and the
assignments it drops, count as no useful work. None where the program
has no step tracer or holds no batch."""


def read(ctx):
    try:
        from repro_torch.obs.tracing import STEP_TRACER
    except ImportError:
        return None
    batches = STEP_TRACER.batches("prefill_step", len(ctx.records))
    c, rf = ctx.cfg, ctx.roofline
    d, f = c.d_model, c.moe_d_ff or c.d_ff
    bound_ms = ns = 0.0
    for b in batches:
        experts = b[b["name"] == "experts"]
        tokens = int(b["tokens"][0])
        for layer in set(experts["layer"].tolist()):
            dispatches = int((experts["layer"] == layer).sum())
            bound_ms += rf.bound(
                dispatches * c.n_experts * 3 * d * f * rf.BF16,
                tokens * c.experts_per_token * 3 * 2.0 * d * f)[0]
        ns += experts["device_ns"].sum()
    if not ns:
        return None
    return 100.0 * bound_ms * 1e6 / ns
