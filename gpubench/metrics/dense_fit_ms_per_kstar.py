"""Dense likelihood (`ops/fit.py`, K1 in dense mode over every padded
model): device time of the fit kernels launched inside the program's
`bf.likelihood` spans, per 1000 stars of the traced calls; nothing
outside the dense engine."""

from gpubench.spans import launched_in, program_spans
from gpubench.tracing import device_seconds


def read(ctx):
    if ctx.engine != "dense" or not ctx.kernels:
        return None
    spans = program_spans(ctx)
    if not spans:
        return None
    ev = [k for k in launched_in(ctx, spans, "bf.likelihood")
          if "fit_kernel" in k[0]]
    return ctx.per_kstar(device_seconds(ev)) if ev else None
