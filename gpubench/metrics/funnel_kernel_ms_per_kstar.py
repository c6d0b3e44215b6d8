"""Funnel likelihood (`ops/funnel.py`): device time of the screen (K2),
slab gather (K3) and stacked fit (K1) kernels per 1000 stars."""

from gpubench.tracing import device_seconds


def read(ctx):
    if ctx.engine != "funnel":
        return None
    ev = [k for k in ctx.kernels if any(
        n in k[0] for n in ("screen_kernel", "gather_kernel", "fit_kernel"))]
    return ctx.per_kstar(device_seconds(ev)) if ev else None
