"""Entry layer (`convert.from_numpy_grid` and the other table builds):
median over the traced calls of the time `fit` spends building the
device tables, their upload included (the program's `bf.tables`
span), in ms."""

from gpubench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, "bf.tables")
