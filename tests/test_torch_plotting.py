"""The port's plots (`brutus_tpu_torch.plotting`) and instrumentation
(`brutus_tpu_torch.profiling`) against `brutus_tpu`, on the set-ups of
`tests/test_plotting.py`.

The device helpers of the plots are held against JAX's in float64; each
drawing function is run once under the Agg backend; the trace is read
back for its annotation; `Throughput` prints what JAX's prints on the
same clock.  Every entry point of this slice raises without a card
unless it is given `device="cpu"`.
"""

import matplotlib
matplotlib.use("Agg")

import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import matplotlib.pyplot as plt

from brutus_tpu import plotting as JPL
from brutus_tpu import profiling as JPR
from brutus_tpu_torch import los, offsets, pdf
from brutus_tpu_torch import plotting as TPL
from brutus_tpu_torch import profiling as TPR

CPU = "cpu"


def _catalogue(seed=31):
    """`test_photometric_offsets_plots`' inputs: 30 stars x 16 draws of
    a 50-model, 6-band grid, the data at the first draw's model (one
    band missing on one star)."""
    rng = np.random.default_rng(seed)
    n_model, n_filt = 50, 6
    models = np.stack([rng.uniform(8, 14, (n_model, n_filt)),
                       rng.uniform(0.4, 1.1, (n_model, n_filt)),
                       rng.uniform(0.05, 0.2, (n_model, n_filt))], axis=-1)
    n_obj, n_samp = 30, 16
    idxs = rng.integers(0, n_model, (n_obj, n_samp))
    reds = rng.uniform(0.1, 1.0, (n_obj, n_samp))
    dreds = rng.uniform(2.8, 3.8, (n_obj, n_samp))
    dists = rng.uniform(0.8, 1.4, (n_obj, n_samp))
    phot = 10 ** (-0.4 * models[idxs[:, 0], :, 0]) / dists[:, :1] ** 2
    err = phot * 0.05
    mask = np.ones_like(phot, bool)
    mask[2, 3] = False
    return dict(models=models, idxs=idxs, reds=reds, dreds=dreds,
                dists=dists, phot=phot, err=err, mask=mask, rng=rng)


def test_posterior_predictive_mags_and_leave_band_weights_match_jax():
    """`_posterior_predictive_mags` within relative 1e-10 of JAX's, and
    `_leave_band_weights` (every band, with and without the
    dimensionless prior) with the same selection and weights within
    relative 1e-10 (within 1e-12 where they are below 1e-12)."""
    c = _catalogue()
    args = (c["models"], c["idxs"], c["reds"], c["dreds"], c["dists"])
    got = TPL._posterior_predictive_mags(*args, device=CPU)
    want = JPL._posterior_predictive_mags(*args)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    magobs, mageobs = TPL.magnitude(c["phot"], c["err"])
    magobs[5, 1] = np.nan          # a NaN residual on a masked-in band
    for band in range(got.shape[2]):
        for dim_prior in (True, False):
            s, w = TPL._leave_band_weights(magobs, mageobs, c["mask"],
                                           want, band, dim_prior, CPU)
            js, jw = JPL._leave_band_weights(magobs, mageobs, c["mask"],
                                             want, band, dim_prior)
            np.testing.assert_array_equal(s, js)
            np.testing.assert_allclose(w, jw, rtol=1e-10, atol=1e-12)


def test_drawing_functions_run_on_agg():
    """Each drawing function, once: `cornerplot`, `_hist2d`,
    `dist_vs_red`, `posterior_predictive`, `photometric_offsets`,
    `photometric_offsets_2d`, and `cornerplot_fit` from saved draws and
    from regenerated ones."""
    c = _catalogue()
    rng = c["rng"]
    args = (c["phot"], c["err"], c["mask"], c["models"], c["idxs"],
            c["reds"], c["dreds"], c["dists"])
    fig, axes = TPL.cornerplot(np.stack([rng.normal(0, 1, 2000),
                                         rng.normal(5, 2, 2000)]),
                               labels=["a", "b"], truths=[0.0, None],
                               span=[0.95, (0.0, 12.0)])
    assert axes.shape == (2, 2) and axes[1, 1].get_xlim() == (0.0, 12.0)
    plt.close(fig)
    fig, ax = plt.subplots()
    TPL._hist2d(rng.normal(size=3000), rng.normal(size=3000), ax=ax)
    plt.close(fig)
    fig, ax = plt.subplots()
    ax, (p, xe, ye) = TPL.dist_vs_red(
        (c["dists"][:1], c["reds"][:1], c["dreds"][:1]), ax=ax,
        bins=(100, 60), parallax=1.0, parallax_err=0.1, device=CPU)
    assert p.shape == (100, 60)
    plt.close(fig)
    fig, ax = plt.subplots()
    TPL.posterior_predictive(c["models"], c["idxs"][0], c["reds"][0],
                             c["dreds"][0], c["dists"][0],
                             data=c["phot"][0], data_err=c["err"][0],
                             labels=[f"b{i}" for i in range(6)], ax=ax,
                             device=CPU)
    plt.close(fig)
    fig, axes = TPL.photometric_offsets(*args, bins=12, device=CPU)
    assert np.asarray(axes).size >= 6
    plt.close(fig)
    fig, axes = TPL.photometric_offsets_2d(
        *args, x=rng.uniform(10, 16, 30), y=rng.uniform(0, 1, 30), bins=5,
        plot_thresh=1, device=CPU)
    plt.close(fig)
    params = np.zeros(50, [("mini", float), ("feh", float),
                           ("agewt", float)])
    params["mini"] = rng.uniform(0.5, 2.0, 50)
    params["feh"] = rng.uniform(-1.0, 0.3, 50)
    i = c["idxs"][0]
    kw = dict(parallax=1.0, parallax_err=0.1, coord=(90.0, 20.0), bins=10,
              device=CPU)
    fig, axes = TPL.cornerplot_fit(
        i, (c["dists"][0], c["reds"][0], c["dreds"][0]), params, **kw)
    assert axes.shape == (6, 6)
    plt.close(fig)
    covs = np.tile(np.diag([1e-3, 0.01, 0.04]), (len(i), 1, 1))
    fig, axes = TPL.cornerplot_fit(
        i, (1.0 / c["dists"][0] ** 2, c["reds"][0], c["dreds"][0], covs),
        params, Nr=32, **kw)
    assert axes.shape == (6, 6)
    plt.close(fig)


def test_regenerated_draws_follow_the_priors():
    """`cornerplot_fit`'s regeneration keeps one draw per model from
    `draw_sar`'s: finite, within the Av / Rv limits, distances of
    positive scale; from scales that put every model at 2 kpc, the
    parallax (1 mas, 10%) pulls the kept parallaxes up."""
    n = 64
    data = (np.full(n, 0.25), np.full(n, 0.5), np.full(n, 3.3),
            np.tile(np.diag([0.01, 0.01, 0.04]), (n, 1, 1)))
    kept = {plx: TPL._regenerate_draws(data, None, (90.0, 20.0),
                                       (0.0, 6.0), (1.0, 8.0), plx, 200, 0,
                                       torch.device(CPU))
            for plx in (None, (1.0, 0.1))}
    for p, d, a, r in kept.values():
        assert all(np.isfinite(v).all() and v.shape == (n,)
                   for v in (p, d, a, r))
        assert (a >= 0).all() and (a <= 6).all()
        assert (r >= 1).all() and (r <= 8).all()
        np.testing.assert_allclose(d, 1.0 / p)
    assert (np.median(kept[(1.0, 0.1)][0])
            > np.median(kept[None][0]) + 0.05)


def test_trace_names_the_annotation(tmp_path):
    """`profiling.trace` writes one Chrome trace into `logdir` that holds
    the `annotate` region and the work inside it."""
    with TPR.trace(str(tmp_path)):
        with TPR.annotate("brutus_region"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "brutus_region" in names
    assert any("mm" in str(n) for n in names)


def test_throughput_prints_what_jax_prints(monkeypatch):
    """`Throughput` on the host clock: with the clock fixed (started at
    10 s, then 14 s), the same lines, rate, ETA and closing newline as
    JAX's meter."""
    outs = []
    for mod in (TPR, JPR):
        clock = iter([10.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock, 14.0))
        buf = io.StringIO()
        m = mod.Throughput(total=8, unit="stars", stream=buf,
                           report_every=0.0)
        m.update(3, extra="batch 1")
        m.update(3)
        assert m.rate == 6 / 4.0 and m.eta == 2 / 1.5
        m.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0] == ("\r3/8 stars  (0.75/s, eta 6.7 s) batch 1   "
                       "\r6/8 stars  (1.50/s, eta 1.3 s)    \n")


def test_modules_import_without_jax_or_matplotlib():
    """The five modules of this slice import with `jax`, `brutus_tpu` and
    `matplotlib` unimportable (the card machine has no jax, and may lack
    matplotlib)."""
    code = ("import sys\n"
            "for m in ('jax', 'brutus_tpu', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "from brutus_tpu_torch import los, offsets, pdf, plotting, "
            "profiling\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=300)


def _entry_points():
    """Every entry point of this slice that runs on a device, with small
    valid inputs."""
    c = _catalogue()
    ds = np.random.default_rng(0).uniform(4, 19, (10, 25))
    rs = 0.2 + (ds > 9.0) * 1.0
    th = np.array([0.02, 0.03, 0.05, 0.2, 9.0, 1.2])
    off = (c["phot"], c["err"], c["mask"], c["models"], c["idxs"],
           c["reds"], c["dreds"], c["dists"])
    draws = (c["dists"][:2], c["reds"][:2], c["dreds"][:2])
    params = np.zeros(50, [("mini", float)])
    return {
        "los.LOS_clouds_loglike_samples":
            lambda **kw: los.LOS_clouds_loglike_samples(th, ds, rs, **kw),
        "los.fit_clouds": lambda **kw: los.fit_clouds(
            ds, rs, 1, n_walkers=8, n_steps=10, n_burn=5, **kw),
        "offsets.photometric_offsets": lambda **kw: (
            offsets.photometric_offsets(*off, Nmc=4, verbose=False, **kw)),
        "pdf.bin_pdfs_distred": lambda **kw: pdf.bin_pdfs_distred(
            draws, bins=(20, 10), **kw),
        "plotting._posterior_predictive_mags": lambda **kw: (
            TPL._posterior_predictive_mags(*off[3:], **kw)),
        "plotting._leave_band_weights": lambda **kw: (
            TPL._leave_band_weights(c["phot"], c["err"], c["mask"],
                                    np.zeros((30, 16, 6)), 0, **kw)),
        "plotting.posterior_predictive": lambda **kw: (
            TPL.posterior_predictive(*(v[0] if i else v for i, v in
                                       enumerate(off[3:])), **kw)),
        "plotting.photometric_offsets": lambda **kw: (
            TPL.photometric_offsets(*off, bins=4, **kw)),
        "plotting.photometric_offsets_2d": lambda **kw: (
            TPL.photometric_offsets_2d(*off, x=np.arange(30.0),
                                       y=np.arange(30.0), bins=2, **kw)),
        "plotting.dist_vs_red": lambda **kw: TPL.dist_vs_red(
            tuple(v[:1] for v in draws), bins=(20, 10), **kw),
        "plotting.cornerplot_fit": lambda **kw: TPL.cornerplot_fit(
            c["idxs"][0], tuple(v[0] for v in draws), params, bins=5,
            **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_a_card_unless_told_cpu(name, monkeypatch):
    """With no card visible, each entry point raises unless given
    `device="cpu"`, and runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    call(device=CPU)
    plt.close("all")
