#!/usr/bin/env python3
"""Where `bin_pdfs_distred` spends its time on the card, stage by stage.

    PYTHONPATH=. python3 tools/pdf_breakdown.py              # 2048 stars
    PYTHONPATH=. python3 tools/pdf_breakdown.py --stars 64 --device cpu

Saved-draws mode at the defaults (bins 750 x 300, distance modulus,
10% parallaxes), 250 draws per star from a seed.  The stars go through
`brutus_tpu_torch.pdf`'s own helpers in its blocks, and CUDA events time
each stage of a block: the draws' upload, the histogram, the x smoothing
matrices, the x product, the y product, the float32 copy back to the
host.  The whole `bin_pdfs_distred` call is timed too, on the host clock
after a synchronisation.  For comparison the x smoothing is also applied
tap by tap (one gathered, weighted slice of the histogram per offset of
the filter, no dense matrix), and its largest deviation from the matrix
form is printed.  On a card, the first line is its name and power limit.
"""

import argparse
import subprocess
import time

import numpy as np
import torch


def taps(sigma, n):
    """The filter of `pdf._smoothing_matrices` as `(B, 2R+1)` weights and
    the `(n, 2R+1)` reflected bin each offset of each row reads."""
    sigma = np.asarray(sigma, np.float64)
    radius = (4.0 * sigma + 0.5).astype(np.int64)
    R = int(radius.max())
    k = np.arange(-R, R + 1)
    phi = np.exp(-0.5 / (sigma * sigma)[:, None] * k[None] ** 2)
    phi = np.where(np.abs(k)[None] <= radius[:, None], phi, 0.0)
    phi = phi / phi.sum(axis=1, keepdims=True)
    m = (np.arange(n)[:, None] + k[None]) % (2 * n)
    return phi, np.where(m >= n, 2 * n - 1 - m, m)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stars", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from brutus_tpu_torch import pdf as TP
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(0)
    n, nd, xbin, ybin = args.stars, 250, 750, 300
    dm = r.uniform(6.5, 13.5, n)
    dist = 10 ** (dm[:, None] / 5 - 2 + r.normal(0, 0.04, (n, nd)))
    red = r.uniform(0.2, 1.7, n)[:, None] + r.normal(0, 0.1, (n, nd))
    plx = 1.0 / 10 ** (dm / 5 - 2)
    plxe = 0.1 * plx
    data = (dist, red, np.full((n, nd), 3.3))
    kw = dict(bins=(xbin, ybin), parallaxes=plx, parallax_errors=plxe,
              device=dev)

    TP.bin_pdfs_distred(tuple(v[:8] for v in data), **kw)   # warm up
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    whole = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        pdfs = TP.bin_pdfs_distred(data, **kw)[0]
        sync()
        whole.append(time.perf_counter() - t0)
    print(f"bin_pdfs_distred: {n} stars in {whole} s, "
          f"{[n / w for w in whole]} stars/s", flush=True)

    # The same work stage by stage, in the function's blocks.
    xe = np.linspace(4.0, 19.0, xbin + 1)
    ye = np.linspace(0.0, 6.0, ybin + 1)
    xsig = TP._x_smoothing(0.01 * 15.0, plx, plxe,
                           "distance_modulus") / (xe[1] - xe[0])
    Sy = TP._smoothing_matrices([0.01 * 6.0 / (ye[1] - ye[0])], ybin,
                                dev)[0]
    xe_t, ye_t = (torch.as_tensor(v, device=dev) for v in (xe, ye))
    nb = max(1, TP.BLOCK_ELEMENTS // (xbin * xbin + nd))
    names = ("upload", "histogram", "x matrices", "x product",
             "y product", "copy back", "x taps")
    spent = dict.fromkeys(names, 0.0)
    out_np = np.empty((n, xbin, ybin), np.float32)
    dev_max = 0.0
    for b0 in range(0, n, nb):
        sl = slice(b0, min(b0 + nb, n))
        ev = [torch.cuda.Event(enable_timing=True) if cuda else None
              for _ in range(len(names) + 1)]
        stamps = []

        def mark(i):
            if cuda:
                ev[i].record()
            else:
                stamps.append(time.perf_counter())

        mark(0)
        d, y = (torch.as_tensor(v[sl], device=dev) for v in data[:2])
        mark(1)
        H = TP._histogram(5.0 * torch.log10(d) + 10.0, y, None, xe_t,
                          ye_t) / nd
        H = H.to(torch.float32).to(torch.float64)
        mark(2)
        Sx = TP._smoothing_matrices(xsig[sl], xbin, dev)
        mark(3)
        X = Sx @ H
        mark(4)
        out = X @ Sy.T
        mark(5)
        torch.from_numpy(out_np[sl]).copy_(out.to(torch.float32))
        mark(6)
        phi, m = taps(xsig[sl], xbin)
        phi = torch.as_tensor(phi, device=dev)
        m = torch.as_tensor(m, device=dev)
        Xt = torch.zeros_like(H)
        for k in range(m.shape[1]):
            Xt += phi[:, k, None, None] * H[:, m[:, k], :]
        mark(7)
        if cuda:
            torch.cuda.synchronize()
            lap = [ev[i].elapsed_time(ev[i + 1]) / 1e3
                   for i in range(len(names))]
        else:
            lap = list(np.diff(stamps))
        for k, v in zip(names, lap):
            spent[k] += v
        dev_max = max(dev_max, float((Xt - X).abs().max()))
    print(f"stage by stage equals the call: {np.array_equal(out_np, pdfs)}",
          flush=True)
    total = sum(v for k, v in spent.items() if k != "x taps")
    print(f"stages over {n} stars in blocks of {nb} (s): "
          + ", ".join(f"{k} {v:.6f}" for k, v in spent.items())
          + f"; the matrix form's stages sum to {total:.6f} s", flush=True)
    print(f"x taps against the x product: largest deviation {dev_max:.3e}",
          flush=True)


if __name__ == "__main__":
    main()
