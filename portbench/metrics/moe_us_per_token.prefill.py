"""The MoE layer's device time per prompt token, from the program's own
spans: the device microseconds of the "moe" spans (`models.moe.moe_apply`
under `models.transformer._ffn`) of the whole batches among the newest
`len(ctx.records)` prefill batches the process's step tracer holds (the
window's last ones), over those batches' `tokens` (B*L, the root span's
count). None where the program has no step tracer or holds no batch."""


def read(ctx):
    try:
        from repro_torch.obs.tracing import STEP_TRACER
    except ImportError:
        return None
    batches = STEP_TRACER.batches("prefill_step", len(ctx.records))
    if not batches:
        return None
    ns = sum(b["device_ns"][b["name"] == "moe"].sum() for b in batches)
    tokens = sum(int(b["tokens"][0]) for b in batches)
    return ns / 1e3 / tokens
