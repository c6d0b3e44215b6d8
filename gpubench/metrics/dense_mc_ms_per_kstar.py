"""Posterior and select (the dense engine's selected models, in plain
PyTorch: `posterior.draw_noise` and its Philox, the covariance repair,
the Cholesky and the Monte Carlo integration of `lnpost_grid`, the
evidence and the resampling): device time of the kernels launched
inside the program's `bf.noise`, `bf.mc` and `bf.draws` spans, per
1000 stars of the traced calls; nothing outside the dense engine or
where the program does not mark all three."""

from gpubench.spans import launched_in, program_spans
from gpubench.tracing import device_seconds

STAGES = ("bf.noise", "bf.mc", "bf.draws")


def read(ctx):
    if ctx.engine != "dense" or not ctx.kernels:
        return None
    spans = program_spans(ctx)
    if not spans or not set(STAGES) <= {s[0] for s in spans}:
        return None
    return ctx.per_kstar(sum(device_seconds(launched_in(ctx, spans, name))
                             for name in STAGES))
