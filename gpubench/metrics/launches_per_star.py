"""Batch step (`fitting._funnel_step` / `_dense_step`, `_pack_outputs`,
`_Fetcher`): device operations of every kind (kernels, copies, memsets)
per star of the traced calls."""


def read(ctx):
    n = len(ctx.kernels) + len(ctx.copies) + len(ctx.memsets)
    return n / ctx.stars if n else None
