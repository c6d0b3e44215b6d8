"""Posterior and select (`posterior.draw_noise`, the plain Philox of
`ops/rng.py`): device time of the kernels launched inside the
program's `bf.noise` spans, per 1000 stars of the traced calls."""

from gpubench.spans import launched_in, program_spans
from gpubench.tracing import device_seconds


def read(ctx):
    spans = program_spans(ctx) if ctx.kernels else None
    if not spans:
        return None
    return ctx.per_kstar(device_seconds(launched_in(ctx, spans,
                                                    "bf.noise")))
