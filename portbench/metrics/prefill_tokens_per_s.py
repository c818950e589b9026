"""Prompt tokens prefilled over the window: every batch's tokens over the
host time from the first batch's issue to the last batch's first tokens
on the host."""


def read(ctx):
    recs = [r for r in ctx.records if r["kind"] == "prefill"]
    if not recs:
        return None
    tokens = sum(r["batch"] * r["length"] for r in recs)
    return tokens / (recs[-1]["t1"] - recs[0]["t0"])
