"""Device (H100): the card's idle time inside the batch groups' launch
(the program's `bf.launch` spans, placed on the trace's clock), over
the traced window; nothing where the trace holds no device event."""

from gpubench.spans import overlap_us, program_spans


def read(ctx):
    if not (ctx.kernels or ctx.copies or ctx.memsets):
        return None
    spans = program_spans(ctx)
    if spans is None:
        return None
    launch = [(a, b) for n, a, b in spans if n == "bf.launch"]
    if not launch:
        return None
    return overlap_us(ctx.gaps, launch) * 1e-6 / ctx.window_s
