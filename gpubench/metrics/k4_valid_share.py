"""Kernels (K4, `ops/mc.py`): the share of the selected columns K4
integrates that hold a valid model (the program's `k4_valid` over its
`k4_columns`, over the traced calls)."""

from gpubench.spans import counter, records


def read(ctx):
    recs = records(ctx)
    if recs is None or not counter(recs, "k4_columns"):
        return None
    return counter(recs, "k4_valid") / counter(recs, "k4_columns")
