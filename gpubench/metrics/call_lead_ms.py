"""Entry layer (`fitting.BruteForce.fit`, `_setup`, the grid prior and
tables, the dust query): median over the traced calls of the host time
from the call's span to the launch of its first screen kernel (funnel)
or dense fit kernel (dense engine)."""

import numpy as np


def read(ctx):
    key = "screen_kernel" if ctx.engine == "funnel" else "fit_kernel"
    leads = []
    for call in ctx.calls:
        first = ctx.in_call(ctx.kernels_named(key), call)
        if first and first[0][3] in ctx.launch_ts:
            leads.append((ctx.launch_ts[first[0][3]] - call["t0"]) * 1e-3)
    return float(np.median(leads)) if leads else None
