"""Posterior and select (the dense engine's `draw_noise` and
`lnpost_grid`): kernels launched inside the program's `bf.noise` and
`bf.posterior` spans, per star of the traced calls; nothing outside
the dense engine or where the program marks no `bf.noise` there."""

from gpubench.spans import launched_in, program_spans


def read(ctx):
    if ctx.engine != "dense" or not ctx.kernels:
        return None
    spans = program_spans(ctx)
    if not spans or not any(s[0] == "bf.noise" for s in spans):
        return None
    n = sum(len(launched_in(ctx, spans, name))
            for name in ("bf.noise", "bf.posterior"))
    return n / ctx.stars
