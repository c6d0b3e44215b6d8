"""Device (H100): the share of the traced window in which no kernel,
copy or memset ran on the card (1 - union of device intervals / window);
nothing where the trace holds no device event."""


def read(ctx):
    if not (ctx.kernels or ctx.copies or ctx.memsets):
        return None
    return 1.0 - ctx.busy_s / ctx.window_s
