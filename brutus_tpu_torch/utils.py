"""
Numerical utilities of the PyTorch port (mirrors `brutus_tpu/utils.py`).

Elementwise over any leading batch dimensions.  The symmetric 3x3
"parts" toolkit works on the six unique components
`(p00, p11, p22, p01, p02, p12)` as a tuple of tensors; the MC kernel's
CUDA source (`csrc/mc.cu`) repeats the same operations in the same
order, so its plain version and the kernel agree to float32 rounding.
"""

import math

import numpy as np
import torch

LN10 = math.log(10.0)


def resolve_device(device):
    """The device an entry point runs on: CUDA unless the caller names
    another.  A CUDA request without a card raises; nothing falls back
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "brutus_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions")
    return dev


def magnitude(phot, err, zeropoints=1.0):
    """AB magnitudes (+errors) from flux densities (reference
    `brutus/utils.py:908-940`).  Takes numpy arrays or tensors."""
    if isinstance(phot, torch.Tensor):
        mag = -2.5 * torch.log10(phot / zeropoints)
        return mag, 2.5 / LN10 * err / phot
    phot = np.asarray(phot)
    mag = -2.5 * np.log10(phot / zeropoints)
    return mag, 2.5 / LN10 * np.asarray(err) / phot


# ---------------------------------------------------------------------------
# Parts-based symmetric 3x3 toolkit (brutus_tpu/utils.py:241-363)
# ---------------------------------------------------------------------------

def equilibrate3_parts(p):
    """Diagonally equilibrated parts plus the inverse scale factors."""
    p00, p11, p22, p01, p02, p12 = p
    e0 = 1.0 / torch.sqrt(torch.clamp(torch.abs(p00), min=1e-30))
    e1 = 1.0 / torch.sqrt(torch.clamp(torch.abs(p11), min=1e-30))
    e2 = 1.0 / torch.sqrt(torch.clamp(torch.abs(p22), min=1e-30))
    bp = (p00 * e0 * e0, p11 * e1 * e1, p22 * e2 * e2,
          p01 * e0 * e1, p02 * e0 * e2, p12 * e1 * e2)
    return bp, (e0, e1, e2)


def _inv3_sym_raw_parts(p):
    """Adjugate-over-determinant inverse; det = sum(adj * A) / 3."""
    a, d, f, b, c, e = p
    adj00 = d * f - e * e
    adj01 = e * c - b * f
    adj02 = b * e - d * c
    adj11 = f * a - c * c
    adj12 = c * b - e * a
    adj22 = a * d - b * b
    det = (adj00 * a + adj01 * b + adj02 * c
           + adj01 * b + adj11 * d + adj12 * e
           + adj02 * c + adj12 * e + adj22 * f) / 3.0
    return (adj00 / det, adj11 / det, adj22 / det,
            adj01 / det, adj02 / det, adj12 / det)


def inverse3_sym_parts(p):
    """Float32-stable inverse of symmetric 3x3 parts."""
    bp, (e0, e1, e2) = equilibrate3_parts(p)
    i00, i11, i22, i01, i02, i12 = _inv3_sym_raw_parts(bp)
    return (i00 * e0 * e0, i11 * e1 * e1, i22 * e2 * e2,
            i01 * e0 * e1, i02 * e0 * e2, i12 * e1 * e2)


def is_psd3_parts(p, eps=0.0):
    """Sylvester positive-definiteness test on equilibrated parts."""
    (a, e, i, b, c, f), _ = equilibrate3_parts(p)
    m1 = a
    m2 = a * e - b * b
    m3 = a * (e * i - f * f) - b * (b * i - f * c) + c * (b * f - e * c)
    return (m1 > eps) & (m2 > eps) & (m3 > eps)


def cholesky3_parts(p):
    """Stable Cholesky -> `(l00, l10, l11, l20, l21, l22)`."""
    bp, (e0, e1, e2) = equilibrate3_parts(p)
    a11, a22, a33, a21, a31, a32 = bp
    l11 = torch.sqrt(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(a33 - l31 * l31 - l32 * l32)
    return (l11 / e0, l21 / e1, l22 / e1, l31 / e2, l32 / e2, l33 / e2)


def psd_repair_parts(icov_p, scale, valid, width, max_passes,
                     mvn_eps=0.0):
    """Escalating diagonal-prior PSD repair of precision parts plus the
    positive-diagonal fallback (reference `brutus/fitting.py:
    1042-1065`); returns covariance parts with `mvn_eps` on the
    diagonal."""
    sfrac = scale * width
    cov_p = inverse3_sym_parts(icov_p)
    one = torch.ones_like(scale)
    zero = torch.zeros_like(scale)
    for i in range(max_passes):
        count = 2.0 ** i
        not_psd = (~is_psd3_parts(cov_p)) & valid
        d1 = cov_p[0] <= 0
        d2 = cov_p[1] <= 0
        d3 = cov_p[2] <= 0
        s1 = torch.where(d1, one, zero) + torch.where((~d2) & (~d3), one,
                                                      zero)
        s2 = torch.where(d2, one, zero) + torch.where((~d1) & (~d3), one,
                                                      zero)
        s3 = torch.where(d3, one, zero) + torch.where((~d1) & (~d2), one,
                                                      zero)
        add = (count / sfrac ** 2 * s1, count / width ** 2 * s2,
               count / width ** 2 * s3)
        icov_p = tuple(
            torch.where(not_psd, icov_p[j] + add[j], icov_p[j])
            for j in range(3)) + tuple(icov_p[3:])
        new_cov = inverse3_sym_parts(icov_p)
        cov_p = tuple(torch.where(not_psd, new_cov[j], cov_p[j])
                      for j in range(6))
    still_bad = ~is_psd3_parts(cov_p)
    d0, d1, d2 = cov_p[0], cov_p[1], cov_p[2]
    w0 = torch.clamp(sfrac ** 2, min=1e-30)
    wsq = torch.full_like(scale, width ** 2)
    f0 = torch.where((d0 > 0) & torch.isfinite(d0), d0, w0)
    f1 = torch.where((d1 > 0) & torch.isfinite(d1), d1, wsq)
    f2 = torch.where((d2 > 0) & torch.isfinite(d2), d2, wsq)
    return (torch.where(still_bad, f0, cov_p[0]) + mvn_eps,
            torch.where(still_bad, f1, cov_p[1]) + mvn_eps,
            torch.where(still_bad, f2, cov_p[2]) + mvn_eps,
            torch.where(still_bad, zero, cov_p[3]),
            torch.where(still_bad, zero, cov_p[4]),
            torch.where(still_bad, zero, cov_p[5]))


def sym3_from_parts(p):
    """`(..., 3, 3)` symmetric matrices from parts."""
    p00, p11, p22, p01, p02, p12 = p
    return torch.stack([
        torch.stack([p00, p01, p02], dim=-1),
        torch.stack([p01, p11, p12], dim=-1),
        torch.stack([p02, p12, p22], dim=-1),
    ], dim=-2)


def mvn3_transform(mean, L, z):
    """`mean + L @ z` for stacked 3x3 lower triangles, elementwise.

    mean : (..., 3); L : (..., 3, 3); z : (..., 3, S) -> (..., 3, S).
    """
    z0, z1, z2 = z[..., 0, :], z[..., 1, :], z[..., 2, :]
    s0 = mean[..., 0, None] + L[..., 0, 0, None] * z0
    s1 = (mean[..., 1, None] + L[..., 1, 0, None] * z0
          + L[..., 1, 1, None] * z1)
    s2 = (mean[..., 2, None] + L[..., 2, 0, None] * z0
          + L[..., 2, 1, None] * z1 + L[..., 2, 2, None] * z2)
    return torch.stack([s0, s1, s2], dim=-2)


# ---------------------------------------------------------------------------
# Statistical pdfs (reference brutus/utils.py:130-283)
# ---------------------------------------------------------------------------

def chi2_logpdf(x, df, loc=0.0, scale=1.0):
    """Chi-square log-pdf (reference `brutus/utils.py:130-176`)."""
    y = (x - loc) / scale
    halfdf = torch.as_tensor(df, dtype=y.dtype, device=y.device) / 2.0
    safe_y = torch.where(y > 0, y, torch.ones_like(y))
    ans = (-(halfdf * math.log(2.0) + torch.lgamma(halfdf))
           + (halfdf - 1.0) * torch.log(safe_y) - safe_y / 2.0
           - math.log(scale))
    return torch.where(y > 0, ans, torch.full_like(ans, -math.inf))


def truncnorm_logpdf(x, a, b, loc=0.0, scale=1.0):
    """Truncated-normal log-pdf with standardized cutoffs `a`, `b`
    (reference `brutus/utils.py:232-283`); `a, b, loc, scale` are
    Python floats."""
    lo = scale * a + loc
    hi = scale * b + loc
    xi = (x - loc) / scale
    lnphi = -math.log(math.sqrt(2.0 * math.pi)) - 0.5 * xi * xi
    lndenom = (math.log(scale / 2.0)
               + math.log(math.erf(b / math.sqrt(2.0))
                          - math.erf(a / math.sqrt(2.0))))
    ans = lnphi - lndenom
    return torch.where((x < lo) | (x > hi),
                       torch.full_like(ans, -math.inf), ans)


__all__ = [
    "resolve_device", "magnitude",
    "equilibrate3_parts", "inverse3_sym_parts", "is_psd3_parts",
    "cholesky3_parts", "psd_repair_parts", "sym3_from_parts",
    "mvn3_transform", "chi2_logpdf", "truncnorm_logpdf",
]
