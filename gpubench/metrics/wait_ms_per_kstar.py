"""Batch step (`fitting._Fetcher.result`): host time blocked on the card
for each group's results (the program's `bf.wait` spans), per 1000
stars of the traced calls."""

from gpubench.spans import durations_ms, records


def read(ctx):
    recs = records(ctx)
    if recs is None or not any(s[0] == "bf.wait" for r in recs
                               for s in r["spans"]):
        return None
    return ctx.per_kstar(sum(durations_ms(recs, "bf.wait")) * 1e-3)
