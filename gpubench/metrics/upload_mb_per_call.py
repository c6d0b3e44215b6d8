"""Entry layer: MB copied from the host to the device per traced call
(the program's `h2d_bytes` counter: the tables, each group's inputs and
the dust ladder)."""

from gpubench.spans import counter, records


def read(ctx):
    recs = records(ctx)
    if recs is None or not counter(recs, "h2d_bytes"):
        return None
    return counter(recs, "h2d_bytes") / 1e6 / len(recs)
