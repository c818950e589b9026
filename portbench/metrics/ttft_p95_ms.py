"""95th percentile (nearest rank) over every request of the window of the
time from its batch's issue to its first token's id on the host."""
import math


def read(ctx):
    ttft = sorted(1e3 * (r["t1"] - r["t0"]) for r in ctx.records
                  if r["kind"] == "prefill" for _ in range(r["batch"]))
    if not ttft:
        return None
    return ttft[math.ceil(0.95 * len(ttft)) - 1]
