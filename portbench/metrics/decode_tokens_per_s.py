"""Generated tokens over the time of the batches that made them, from the
first batch's issue to the last batch's tokens on the host (the prompt
feed through the cache path included)."""


def read(ctx):
    recs = [r for r in ctx.records if r["kind"] == "decode"]
    if not recs:
        return None
    tokens = sum(r["batch"] * r["generated"] for r in recs)
    return tokens / (recs[-1]["t1"] - recs[0]["t0"])
