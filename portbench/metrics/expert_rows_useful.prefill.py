"""The share of the expert buffers' rows that hold an assignment, from
the program's own counter: over the "experts" spans of the whole batches
among the newest `len(ctx.records)` prefill batches the process's step
tracer holds, the sum of `kept` (the (token, expert) assignments kept
under the capacity) over the sum of `rows` (the E*C rows the expert
products compute), in %. None where the program has no step tracer or
holds no batch."""


def read(ctx):
    try:
        from repro_torch.obs.tracing import STEP_TRACER
    except ImportError:
        return None
    batches = STEP_TRACER.batches("prefill_step", len(ctx.records))
    experts = [b[b["name"] == "experts"] for b in batches]
    rows = sum(int(e["rows"].sum()) for e in experts)
    if not rows:
        return None
    return 100.0 * sum(int(e["kept"].sum()) for e in experts) / rows
