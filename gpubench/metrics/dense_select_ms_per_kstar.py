"""Posterior and select (`posterior._select_grid` of the dense engine:
the priors, prefilter and culls over every model): device time of the
kernels launched inside the program's `bf.select` spans, per 1000
stars of the traced calls; nothing outside the dense engine or where
the program marks no `bf.select` there."""

from gpubench.spans import launched_in, program_spans
from gpubench.tracing import device_seconds


def read(ctx):
    if ctx.engine != "dense" or not ctx.kernels:
        return None
    spans = program_spans(ctx)
    if not spans or not any(s[0] == "bf.select" for s in spans):
        return None
    return ctx.per_kstar(device_seconds(launched_in(ctx, spans,
                                                    "bf.select")))
