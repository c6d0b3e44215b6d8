"""Posterior and select (`ops/posterior.py`, `ops/mc.py`, `ops/rng.py`,
in plain PyTorch): device time of every operation that is neither a
hand-written kernel nor a copy, per 1000 stars."""

from gpubench.tracing import HAND_WRITTEN, device_seconds


def read(ctx):
    ev = [k for k in ctx.kernels if not any(n in k[0] for n in HAND_WRITTEN)]
    ev += ctx.memsets
    return ctx.per_kstar(device_seconds(ev)) if ev else None
