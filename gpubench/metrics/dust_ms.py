"""Entry layer (the dust map's query, `dustmap.uniform_profile` and the
ladder's upload): median over the traced calls of the time `fit`
spends in them (the program's `bf.dust` span), in ms."""

from gpubench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, "bf.dust")
