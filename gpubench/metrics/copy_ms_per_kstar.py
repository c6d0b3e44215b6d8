"""Batch step: device time of host-device copies per 1000 stars."""

from gpubench.tracing import device_seconds


def read(ctx):
    return ctx.per_kstar(device_seconds(ctx.copies)) if ctx.copies else None
