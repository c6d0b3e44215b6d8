"""
Typed configuration objects of the PyTorch port.

The port's own copy of `brutus_tpu.config`, cut to the fields the
port reads: each keeps the name and default it has there, so a
value means the same thing in both packages.  Each default keeps the
reference value it cites (`brutus/fitting.py`, `brutus/pdf.py`).
"""

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Per-star likelihood optimization (reference `brutus/fitting.py:
    579-585`, `34-40`, `274-278`, `430-433`)."""

    avlim: tuple = (0.0, 20.0)
    av_gauss: tuple = (0.0, 1e6)       # essentially flat over avlim
    rvlim: tuple = (1.0, 8.0)
    rv_gauss: tuple = (3.32, 0.18)     # Schlafly et al. (2016)
    av_reg: float = 0.05               # MLE re-expansion (fitting.py:433)
    rv_reg: float = 0.1
    # Convergence of the reference-semantics engine (fitting.py:583):
    # flux-phase log-likelihood tolerance, the subset it is judged on.
    ltol: float = 3e-2
    ltol_subthresh: float = 1e-2
    init_thresh: float = 5e-3          # post-mag-fit freeze threshold
    apply_init_cull: bool = True       # the reference's init cull on/off
    dim_prior: bool = True             # chi2 logpdf with Ndim-3 dof
    scale_min: float = 1e-20           # flux-scale clamp (fitting.py:517)
    # Caps on the reference-semantics engine's convergence loops (the
    # reference iterates without bound).
    max_iter_mag: int = 100
    max_iter_flux: int = 100
    stepsize_rescale: float = 1.2      # fitting.py:779
    # Magnitude-phase seeds of that engine (fitting.py:700-703); None
    # means the prior means.
    av_init: float = None
    rv_init: float = None
    # Flux-space polish of only the best `polish_k` models by their
    # magnitude-phase likelihood (0: every model).
    polish_k: int = 0
    # Seed that engine's magnitude phase with one direct 3x3 weighted
    # least-squares solve; the fit kernel always does.  `fit` turns it
    # on; the bare default keeps the reference trajectory.
    mag_direct_init: bool = False
    big_var: float = 1e30              # unusable-magnitude variance flag
    # Fixed, unrolled iteration budgets of the fit kernel (K1).
    kernel_mag_iters: int = 6
    kernel_flux_iters: int = 6
    # Funnel: screen every model, fully fit the best `screen_k` per star
    # as `screen_k // screen_block` contiguous blocks.  0 = no funnel.
    screen_k: int = 12288
    screen_block: int = 256

    @property
    def mtol(self):
        """Magnitude-phase tolerance, `2.5 * ltol` (fitting.py:732)."""
        return 2.5 * self.ltol

    @property
    def av0(self):
        return self.av_gauss[0] if self.av_init is None else self.av_init

    @property
    def rv0(self):
        return self.rv_gauss[0] if self.rv_init is None else self.rv_init


@dataclasses.dataclass(frozen=True)
class PosteriorConfig:
    """Monte-Carlo posterior integration and resampling (reference
    `brutus/fitting.py:823-827`, `1426-1437`)."""

    n_mc_prior: int = 50
    wt_thresh: float = 1e-3
    cdf_thresh: float = 2e-3
    n_draws: int = 250
    avlim: tuple = (0.0, 20.0)
    rvlim: tuple = (1.0, 8.0)
    # Fixed-size top-k replacing the reference's dynamic memory cap
    # (fitting.py:968-970).
    n_sel_max: int = 2048
    # Likelihood-rank prefilter ahead of the Galactic and dust priors.
    prefilter_k: int = 2048
    # Rank the prefilter on the max-shifted key rounded to bf16, as the
    # JAX package does; candidates that close are interchangeable.
    prefilter_bf16: bool = True
    psd_width: float = 0.02            # PSD repair (fitting.py:1042-1065)
    psd_max_passes: int = 8
    mvn_eps: float = 1e-30             # Cholesky jitter (utils.py:845)
    # Make the MC normals inside K4 (Philox from per-star seeds) instead
    # of feeding a (B, 3, nmc_pad, K) tensor of them in; draws then agree
    # with the fed mode in distribution only.
    kernel_rng: bool = True


@dataclasses.dataclass(frozen=True)
class GalPriorConfig:
    """Galactic 3-D prior (reference `brutus/pdf.py:476-486`)."""

    R_solar: float = 8.2
    Z_solar: float = 0.025
    R_thin: float = 2.6
    Z_thin: float = 0.3
    Rs_thin: float = 2.0
    R_thick: float = 2.0
    Z_thick: float = 0.9
    f_thick: float = 0.04
    Rs_thick: float = 2.0
    Rs_halo: float = 2.0
    q_halo_ctr: float = 0.2
    q_halo_inf: float = 0.8
    r_q_halo: float = 6.0
    eta_halo: float = 4.2
    f_halo: float = 0.005
    feh_thin: float = -0.2
    feh_thin_sigma: float = 0.3
    feh_thick: float = -0.7
    feh_thick_sigma: float = 0.4
    feh_halo: float = -1.6
    feh_halo_sigma: float = 0.5
    max_age: float = 13.8
    min_age: float = 0.0
    feh_age_ctr: float = -0.5
    feh_age_scale: float = 0.5
    nsigma_from_max_age: float = 2.0
    max_sigma: float = 4.0
    min_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class DustPriorConfig:
    """3-D dust prior knobs (reference `brutus/pdf.py:752-754`)."""

    offset: float = 0.0
    scale: float = 1.0
    smooth: float = 1.0
    scatter: float = 0.2


LN2PI = math.log(2.0 * math.pi)

__all__ = ["FitConfig", "PosteriorConfig", "GalPriorConfig",
           "DustPriorConfig", "LN2PI"]
