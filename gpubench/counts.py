"""Operations and bytes each hand-written kernel needs, and the least
time the card could take for them.

Frozen copies of the repository's `chip_smoke.py` counting functions
(`bound`, `screen_bound`, `fit_ops`, `fit_bound`; K1 dense's, K3's
and K4's have no reader yet), with two changes: the per-pair work
is counted with each star's own usable bands (a masked band needs no
work), and K1's pairs that the polish moves are not counted: that needs
each star's shortlist and K1's magnitude phase, so K1's least time
counts no polish re-expansions (a lower bound, see PERF.md).  Every input byte is counted
read once and every output byte written once.
"""

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes, ops):
    """`(seconds, "bytes" | "operations")`: the larger of the bytes over
    the HBM rate and the float32 operations over the float32 rate."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(b, o), ("bytes" if b >= o else "operations")


def screen_work(bands, Mp, F, block):
    """K2 over the stars whose usable band counts are `bands`: per
    (star, model) 12 FMAs per band and ~70 of solve and score; per model
    its centred magnitude and six star-independent products per band.
    Returns `(bytes, operations)`."""
    B = len(bands)
    nbytes = 4 * (3 * F * Mp + Mp + B * Mp // block + B * (2 * F + 5))
    ops = sum(Mp * (24 * f + 70) for f in bands) + Mp * 7 * F
    return nbytes, ops


def fit_ops(F, mag_iters=6, flux_iters=6):
    """Float32 operations K1 needs for `F` bands, as `(per (star,
    model), per moving (star, model), per model)`: the direct seed, the
    magnitude-space solves, the first flux-space expansion, each polish
    step's update, the final expansion with the precision parts and the
    epilogue; a pair the freeze lets move also takes each polish step's
    re-expansion; per model exp(-0.4 ln10 mag) per band."""
    pair = (F * (23 + 21 * mag_iters + 11 + 34 + 41)
            + 55 + 37 * mag_iters + 4 + 24 * flux_iters + 7 + 10)
    return pair, flux_iters * (34 * F + 7), 2 * F


def fit_work(bands, P, C, n_rows):
    """K1 stacked: every star fits its own `P` shortlist models."""
    B = len(bands)
    nbytes = 4 * (C * B * P + B * P + n_rows * B * P)
    ops = 0
    for f in bands:
        pair, _, model = fit_ops(f)
        ops += P * (pair + model)
    return nbytes, ops
