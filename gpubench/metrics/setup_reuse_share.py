"""Entry layer: the share of the traced calls whose device tables the
`BruteForce` kept from an earlier call instead of building them (the
program's `setup_reused` counter, 1 or 0 a call).  None where no call's
record holds the counter (a program that keeps no such set-up)."""

from gpubench.spans import counter, records


def read(ctx):
    recs = records(ctx)
    if recs is None or not any("setup_reused" in r["counters"]
                               for r in recs):
        return None
    return counter(recs, "setup_reused") / len(recs)
