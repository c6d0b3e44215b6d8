#!/usr/bin/env python3
"""Whether a star's posterior draws depend on the size of its batch.

    PYTHONPATH=. python3 tools/cdf_batch_probe.py             # on the card
    PYTHONPATH=. python3 tools/cdf_batch_probe.py --device cpu --tiny

Fits the first 128 of `chip_smoke.py` phase 4's stars with the funnel,
once in one batch of 128 and once in two of 64 (a mesh's `data` axis of
2 splits each batch so), and counts the outputs that differ.  Then it
takes the first fit's inverse-CDF logits and uniforms and draws the
models both ways again, the CDF summed in float32 (the port before this
probe) and in float64 (`posterior._categorical_cdf`): for each it prints
whether the `(128, K)` cumsum equals the two `(64, K)` ones, and how
many draws differ.  On a card, the first line is its name and power
limit.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402


def draws(logits, u, dtype):
    wt = torch.softmax(logits, dim=1)
    cdf = torch.cumsum(wt.to(dtype), dim=1)
    v = (u.to(dtype) * cdf[:, -1:]).contiguous()
    return cdf, torch.searchsorted(cdf.contiguous(), v, side="left")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a 4000-model grid and 16 stars in batches of 8")
    args = ap.parse_args()
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.ops import posterior
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
    M, n, k, n_sel = ((4000, 16, 1024, 256) if args.tiny
                      else (750_000, 128, 12288, 2048))
    mc, labels = smoke.correlated_grid(M, 8)
    s = smoke.stars(mc, n if args.tiny else 512)
    s = {key: (v[:n] if np.ndim(v) else v) for key, v in s.items()}
    bf = BruteForce(mc, labels, device=dev)
    seen = []
    spy = posterior._evidence_and_draws

    def keep(lnp_sel, chi2_k, u, n_draws):
        seen.append((lnp_sel, chi2_k, u))
        return spy(lnp_sel, chi2_k, u, n_draws)
    posterior._evidence_and_draws = keep
    outs = []
    for batch in (n, n // 2):
        kw = smoke.fit_kwargs(s, batch, k, n_sel, return_results=True)
        outs.append(bf.fit(s["flux"], s["err"],
                           np.ones(s["flux"].shape, bool), **kw))
    posterior._evidence_and_draws = spy
    diff = {key: int((outs[0][key] != outs[1][key]).sum())
            for key in outs[0]}
    print(f"{n} stars in one batch against two of {n // 2}: outputs that "
          f"differ {diff}")
    lnp_sel, chi2_k, u = seen[0]
    chi2 = torch.where(torch.isfinite(chi2_k), chi2_k,
                       torch.full_like(chi2_k, 1e30))
    ok = posterior._is_valid(lnp_sel).any(1, keepdim=True)
    logits = torch.where(ok, lnp_sel, -0.5 * chi2)
    h = n // 2
    for dtype in (torch.float32, torch.float64):
        cdf, idx = draws(logits, u, dtype)
        parts = [draws(logits[i:i + h], u[i:i + h], dtype) for i in (0, h)]
        cdf2 = torch.cat([p[0] for p in parts])
        idx2 = torch.cat([p[1] for p in parts])
        print(f"CDF in {dtype}: cumsum of ({n}, K) equal to two ({h}, K) "
              f"{torch.equal(cdf, cdf2)} (rows differing "
              f"{int((cdf != cdf2).any(1).sum())}), draws differing "
              f"{int((idx != idx2).sum())} of {idx.numel()}")


if __name__ == "__main__":
    main()
