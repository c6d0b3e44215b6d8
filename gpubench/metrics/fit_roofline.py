"""Kernels: the stacked fit kernel K1's share of its roofline, in %: the
least time for fitting every star's shortlist (`screen_k` models, the
table's 3F + 3 rows gathered, a 15-row pack written; the polish's
re-expansions not counted), over the kernel's device time."""

from gpubench import counts
from gpubench.tracing import device_seconds

N_AUX = 3


def read(ctx):
    if ctx.engine != "funnel":
        return None
    ev = ctx.kernels_named("fit_kernel")
    if not ev:
        return None
    P = ctx.config["fit"]["screen_k"]
    C = 3 * ctx.n_band + N_AUX
    nbytes = ops = 0
    for call in ctx.calls:
        b, o = counts.fit_work(list(call["bands"]), P, C, 12 + N_AUX)
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * counts.bound(nbytes, ops)[0] / device_seconds(ev)
