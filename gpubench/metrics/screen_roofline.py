"""Kernels: the screen kernel K2's share of its roofline, in %: the least
time the card could take for the screens the traced calls need (each
star against every padded model, with its own usable bands; the table
read once per launch), over the kernel's device time."""

from gpubench import counts
from gpubench.tracing import device_seconds

TILE = 512


def read(ctx):
    if ctx.engine != "funnel":
        return None
    ev = ctx.kernels_named("screen_kernel")
    if not ev:
        return None
    F = ctx.n_band
    Mp = -(-ctx.n_model // TILE) * TILE
    block = ctx.config["fit"]["screen_block"]
    nbytes = ops = 0
    for call in ctx.calls:
        launches = len(ctx.in_call(ev, call))
        b, o = counts.screen_work(list(call["bands"]), Mp, F, block)
        table = 4 * (3 * F * Mp + Mp)
        nbytes += b + (launches - 1) * table
        ops += o + (launches - 1) * Mp * 7 * F
    least = counts.bound(nbytes, ops)[0]
    return 100.0 * least / device_seconds(ev)
