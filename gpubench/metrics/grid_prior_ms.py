"""Entry layer (`fitting.BruteForce._setup`): median over the traced
calls of the time `fit` spends in `convert.default_grid_lnprior` (the
program's `bf.grid_prior` span), in ms."""

from gpubench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, "bf.grid_prior")
