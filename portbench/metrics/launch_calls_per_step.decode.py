"""Host dispatch: the runtime's launch calls (cudaLaunchKernel*,
cuLaunchKernel*, cudaGraphLaunch) the profiler saw, per decode step of
the traced batches (a step a prompt token and a generated token)."""


def read(ctx):
    if ctx.trace is None:
        return None
    recs = [r for r in ctx.trace_records if r["kind"] == "decode"]
    if not recs:
        return None
    return ctx.trace.launch_calls / sum(r["steps"] for r in recs)
