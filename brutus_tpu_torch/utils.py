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


def _tensor(x):
    """`x` as a tensor; Python and numpy numbers keep float64 (torch
    would make Python floats float32)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


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


class function_wrapper:
    """Pickleable closure binding `args` / `kwargs` to `func` so it can
    cross process boundaries (mirrors `utils.function_wrapper`;
    reference `brutus/utils.py:43-68`): errors are re-raised after the
    offending inputs are printed."""

    def __init__(self, func, args=None, kwargs=None, name="input"):
        self.func = func
        self.args = args or []
        self.kwargs = kwargs or {}
        self.name = name

    def __call__(self, x):
        try:
            return self.func(x, *self.args, **self.kwargs)
        except Exception:
            import traceback
            print(f"Exception while calling {self.name} function:")
            print("  params:", x)
            print("  args:", self.args)
            print("  kwargs:", self.kwargs)
            traceback.print_exc()
            raise


def magnitude(phot, err, zeropoints=1.0):
    """AB magnitudes (+errors) from flux densities (reference
    `brutus/utils.py:908-940`).  Takes numpy arrays or tensors."""
    if isinstance(phot, torch.Tensor):
        mag = -2.5 * torch.log10(phot / zeropoints)
        return mag, 2.5 / LN10 * err / phot
    phot = np.asarray(phot)
    mag = -2.5 * np.log10(phot / zeropoints)
    return mag, 2.5 / LN10 * np.asarray(err) / phot


def inv_magnitude(mag, err, zeropoints=1.0):
    """Flux densities (+errors) from AB magnitudes (mirrors
    `utils.inv_magnitude`; reference `brutus/utils.py:943-975`)."""
    phot = torch.pow(10.0, -0.4 * _tensor(mag)) * zeropoints
    return phot, err * 0.4 * LN10 * phot


def luptitude(phot, err, skynoise=1.0, zeropoints=1.0):
    """Asinh magnitudes ("Luptitudes", Lupton et al. 1999) from fluxes
    (mirrors `utils.luptitude`; reference `brutus/utils.py:978-1017`)."""
    phot = _tensor(phot)
    mag = -2.5 / LN10 * (torch.asinh(phot / (2.0 * skynoise))
                         + math.log(skynoise / zeropoints))
    mag_err = torch.sqrt((2.5 * math.log10(math.e) * err) ** 2
                         / ((2.0 * skynoise) ** 2 + phot * phot))
    return mag, mag_err


def inv_luptitude(mag, err, skynoise=1.0, zeropoints=1.0):
    """Fluxes from asinh magnitudes (mirrors `utils.inv_luptitude`;
    reference `brutus/utils.py:1020-1058`)."""
    mag = _tensor(mag)
    phot = (2.0 * skynoise) * torch.sinh(LN10 / -2.5 * mag
                                         - math.log(skynoise / zeropoints))
    phot_err = torch.sqrt(((2.0 * skynoise) ** 2 + phot * phot)
                          * err * err) / (2.5 * math.log10(math.e))
    return phot, phot_err


def add_mag(mag1, mag2, f1=1.0, f2=1.0):
    """Combined magnitude of two weighted components (mirrors
    `utils.add_mag`; reference `brutus/utils.py:1061-1086`)."""
    flux1 = torch.pow(10.0, -0.4 * _tensor(mag1))
    flux2 = torch.pow(10.0, -0.4 * _tensor(mag2))
    return -2.5 * torch.log10(f1 * flux1 + f2 * flux2)


# ---------------------------------------------------------------------------
# Stacked 3x3 linear algebra (brutus_tpu/utils.py:111-238; reference
# brutus/utils.py:71-127)
# ---------------------------------------------------------------------------

def adjoint3(A):
    """Adjugate of stacked 3x3 matrices: row i is the cross product of
    rows i-2 and i-1 (reference `brutus/utils.py:71-83`)."""
    rows = [torch.linalg.cross(A[..., i - 2, :], A[..., i - 1, :])
            for i in range(3)]
    return torch.stack(rows, dim=-2)


def inverse_transpose3(A):
    """Inverse-transpose of stacked 3x3 matrices through their adjugates
    (reference `brutus/utils.py:96-105`)."""
    Id = adjoint3(A)
    det = (Id * A).sum((-2, -1)) / 3.0
    return Id / det[..., None, None]


def inverse3(A):
    """Inverse of stacked 3x3 matrices (reference
    `brutus/utils.py:108-114`)."""
    return inverse_transpose3(A).transpose(-1, -2)


def equilibrate3(A):
    """`(B, dinv)`: `B = D^-1 A D^-1` with `D = diag(sqrt(|diag A|))`, a
    unit-diagonal matrix whose minors keep the signs of `A`'s (mirrors
    `utils.equilibrate3`)."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(
        A, dim1=-2, dim2=-1)), min=1e-30))
    dinv = 1.0 / d
    return A * dinv[..., :, None] * dinv[..., None, :], dinv


def inverse3_stable(A):
    """Inverse of stacked symmetric 3x3 matrices through equilibration,
    `inv(A) = D^-1 inv(B) D^-1` (mirrors `utils.inverse3_stable`)."""
    B, dinv = equilibrate3(A)
    return inverse3(B) * dinv[..., :, None] * dinv[..., None, :]


def cholesky3(A):
    """Closed-form lower Cholesky factor of stacked 3x3 matrices, NaN
    where `A` is not positive definite (mirrors `utils.cholesky3`)."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(a33 - l31 * l31 - l32 * l32)
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], dim=-1),
                        torch.stack([l21, l22, z], dim=-1),
                        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def cholesky3_stable(A):
    """Cholesky of stacked SPD 3x3 matrices on the equilibrated matrix,
    `chol(D B D) = D chol(B)` (mirrors `utils.cholesky3_stable`)."""
    B, dinv = equilibrate3(A)
    return cholesky3(B) / dinv[..., :, None]


def is_psd3(A, eps=0.0):
    """Which stacked symmetric 3x3 matrices are positive definite, by
    the leading principal minors of the equilibrated matrix (mirrors
    `utils.is_psd3`; reference `brutus/utils.py:117-127`)."""
    A, _ = equilibrate3(A)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    m1 = a
    m2 = a * e - b * d
    m3 = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return (m1 > eps) & (m2 > eps) & (m3 > eps)


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


def truncnorm_pdf(x, a, b, loc=0.0, scale=1.0):
    """Truncated-normal pdf with standardized cutoffs `a`, `b` (mirrors
    `utils.truncnorm_pdf`; reference `brutus/utils.py:179-229`); `a, b,
    loc, scale` are Python floats."""
    x = _tensor(x)
    lo = scale * a + loc
    hi = scale * b + loc
    xi = (x - loc) / scale
    phix = torch.exp(-0.5 * xi * xi) / math.sqrt(2.0 * math.pi)
    Phia = 0.5 * (1 + math.erf(a / math.sqrt(2.0)))
    Phib = 0.5 * (1 + math.erf(b / math.sqrt(2.0)))
    ans = phix / (scale * (Phib - Phia))
    return torch.where((x < lo) | (x > hi), torch.zeros_like(ans), ans)


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


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of 1-D `xp -> fp` at `x`, clamped to
    the end values (the semantics of `jnp.interp`)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (x - xp[i - 1])
                    / torch.where(dx0, torch.ones_like(dx), dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def quantile(x, q, weights=None):
    """(Weighted) sample quantiles (mirrors `utils.quantile`; reference
    `brutus/utils.py:718-762`): linear percentiles without weights, the
    interpolated weighted CDF with them."""
    x = torch.atleast_1d(_tensor(x))
    q = torch.atleast_1d(torch.as_tensor(q, dtype=x.dtype))
    if weights is None:
        return torch.quantile(x, q)
    weights = torch.atleast_1d(torch.as_tensor(weights, dtype=x.dtype))
    idx = torch.argsort(x)
    cdf = torch.cumsum(weights[idx], 0)[:-1]
    cdf = torch.cat([torch.zeros(1, dtype=cdf.dtype), cdf / cdf[-1]])
    return _interp(q, cdf, x[idx])


def sample_multivariate_normal(generator, mean, cov, size=1, eps=1e-30):
    """`size` draws from each of `N` d-dimensional Gaussians (mirrors
    `utils.sample_multivariate_normal`; reference `brutus/utils.py:
    845-905`), the normals from `generator` (a `torch.Generator` on
    `mean`'s device, or None for the global one).

    mean : (N, d); cov : (N, d, d).  Returns `(d, size, N)`, the
    reference's layout.
    """
    N, d = mean.shape
    K = cov + eps * torch.eye(d, dtype=cov.dtype, device=cov.device)
    z = torch.randn((N, d, size), generator=generator, dtype=mean.dtype,
                    device=mean.device)
    if d == 3:
        ans = mvn3_transform(mean, cholesky3(K), z)
    else:
        ans = mean[:, :, None] + torch.linalg.cholesky(K) @ z
    return torch.movedim(ans, 0, -1)


def draw_sar(generator, scales, avs, rvs, covs_sar, ndraws=500,
             avlim=(0.0, 6.0), rvlim=(1.0, 8.0)):
    """Truncated-MVN draws of `(s, Av, Rv)` per model (mirrors
    `utils.draw_sar`; reference `brutus/utils.py:765-842`): a fixed
    batch of draws whose out-of-bounds members are replaced by
    in-bounds ones drawn with replacement, the clipped means where no
    draw is in bounds.  Returns `sdraws, adraws, rdraws` (N, ndraws)."""
    mean = torch.stack([scales, avs, rvs], dim=-1)
    samps = sample_multivariate_normal(generator, mean, covs_sar,
                                       size=ndraws)
    s_mc, a_mc, r_mc = samps[0].T, samps[1].T, samps[2].T
    inb = ((s_mc >= 0.0) & (a_mc >= avlim[0]) & (a_mc <= avlim[1])
           & (r_mc >= rvlim[0]) & (r_mc <= rvlim[1]))
    any_in = inb.any(-1, keepdim=True)
    probs = torch.where(any_in, inb.to(mean.dtype),
                        torch.ones_like(s_mc))
    idx = torch.multinomial(probs, ndraws, replacement=True,
                            generator=generator)
    take = lambda x: torch.gather(x, -1, idx)
    s_out = torch.where(inb, s_mc, take(s_mc))
    a_out = torch.where(inb, a_mc, take(a_mc))
    r_out = torch.where(inb, r_mc, take(r_mc))
    s_out = torch.where(any_in, s_out, torch.clamp(mean[:, :1], min=0.0))
    a_out = torch.where(any_in, a_out, torch.clamp(mean[:, 1:2], *avlim))
    r_out = torch.where(any_in, r_out, torch.clamp(mean[:, 2:3], *rvlim))
    return s_out, a_out, r_out


def phot_loglike(data, data_err, data_mask, models, dim_prior=True):
    """Masked chi-square log-likelihood of fluxes against model fluxes
    (mirrors `utils.phot_loglike`; reference `brutus/utils.py:
    1162-1215`).  data, data_err, data_mask : (F,); models : (M, F)."""
    mask = torch.as_tensor(data_mask).to(models.dtype)
    ndim = mask.sum()
    tot_var = data_err * data_err
    safe_var = torch.where(mask > 0, tot_var, torch.ones_like(tot_var))
    resid = torch.where(mask > 0, data - models, torch.zeros_like(models))
    chi2 = (resid * resid / safe_var * mask).sum(-1)
    lnl = -0.5 * chi2
    lnl = lnl - 0.5 * (ndim * math.log(2.0 * math.pi)
                       + (torch.log(safe_var) * mask).sum(-1))
    if dim_prior:
        a = 0.5 * (ndim - 3)
        pos = chi2 > 0
        lnl = ((a - 1.0) * torch.where(
            pos, torch.log(torch.where(pos, chi2, torch.ones_like(chi2))),
            torch.zeros_like(chi2))
            - chi2 / 2.0 - torch.lgamma(a) - math.log(2.0) * a)
    return lnl


__all__ = [
    "resolve_device", "function_wrapper", "magnitude", "inv_magnitude",
    "luptitude", "inv_luptitude", "add_mag", "adjoint3",
    "inverse_transpose3", "inverse3", "equilibrate3", "inverse3_stable",
    "cholesky3", "cholesky3_stable", "is_psd3", "truncnorm_pdf",
    "quantile", "sample_multivariate_normal", "draw_sar", "phot_loglike",
    "equilibrate3_parts", "inverse3_sym_parts", "is_psd3_parts",
    "cholesky3_parts", "psd_repair_parts", "sym3_from_parts",
    "mvn3_transform", "chi2_logpdf", "truncnorm_logpdf",
]
