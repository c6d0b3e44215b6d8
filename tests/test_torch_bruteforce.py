"""The rest of `brutus_tpu_torch.BruteForce` on the CPU (the kernels'
plain versions): `scan_batches`, `resume`, `lnprior_ext`, the per-star
generator `_fit`, `return_sel`, the integer grid-index path (exact on
grids of 2**24 models or more), and `dtype`; against the port's own
per-batch path and against `brutus_tpu`.

A row's draws depend on `(seed, row)` alone, so two runs that fit the
same rows in other groupings must write the same rows: model indices
equal, floats within rtol 1e-5 (`test_fitting.py`'s
`test_fit_scan_batches_identical_rows` limit; equal in practice).
"""

import numpy as np
import pytest
import torch

from brutus_tpu.fitting import BruteForce as JBruteForce
from brutus_tpu_torch import BruteForce, fitting
from brutus_tpu_torch.config import FitConfig, PosteriorConfig
from brutus_tpu_torch.convert import from_numpy_grid
from brutus_tpu_torch.io import ResultsWriter, load_results
from brutus_tpu_torch.ops import posterior as TP
from brutus_tpu_torch.ops.funnel import loglike_grid_screened

from test_pallas import _problem

T = torch.as_tensor
COORD = np.array([204.7, -19.2])


@pytest.fixture(scope="module")
def setup():
    """1024 models x 8 bands, 7 stars with parallaxes, one band masked
    on the second star."""
    rng = np.random.default_rng(401)
    mc, flux, err, idx, dist = _problem(n_model=1024, n_star=7, rng=rng)
    lab = np.zeros(1024, [("mini", float), ("feh", float),
                          ("loga", float)])
    lab["mini"] = rng.uniform(0.5, 2.0, 1024)
    lab["feh"] = rng.uniform(-2.0, 0.3, 1024)
    lab["loga"] = rng.uniform(8.0, 10.1, 1024)
    mask = np.ones(flux.shape, bool)
    mask[1, 3] = False
    kw = dict(data_coords=np.tile(COORD, (7, 1)), parallax=1.0 / dist,
              parallax_err=0.1 / dist, Nmc_prior=16, Ndraws=32,
              n_sel_max=64, screen_k=256, screen_block=64, tile=64,
              batch_size=2, verbose=False, seed=11)
    return dict(mc=mc, lab=lab, flux=flux, err=err, mask=mask, idx=idx,
                kw=kw)


def _fit(p, **kw):
    bf = BruteForce(p["mc"], p["lab"], device="cpu")
    return bf.fit(p["flux"], p["err"], p["mask"],
                  **dict(p["kw"], return_results=True, **kw))


def _same_rows(a, b):
    np.testing.assert_array_equal(a["model_idx"], b["model_idx"])
    for k in ("log_evidence", "dist", "red", "dred", "chi2min", "scale"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_scan_batches_identical_rows(setup, engine):
    """`scan_batches=2` groups two batches of 2 per launch sequence and
    copy back; with 7 stars the last group is ragged (one batch of 1).
    Rows equal those of `scan_batches=1`, on both funnels."""
    outs = [_fit(setup, engine=engine, scan_batches=n) for n in (1, 2)]
    _same_rows(*outs)
    assert outs[0]["model_idx"].shape == (7, 32)


def test_resume_writes_the_rows_of_an_uninterrupted_run(setup, tmp_path):
    """A file whose first 4 rows were written (by a fit of those 4 stars)
    is resumed by `resume=True` from its cursor: only rows 4..6 are
    fitted (2 batches), and the file equals an uninterrupted run's."""
    p = setup
    full = str(tmp_path / "full")
    part = str(tmp_path / "part")
    bf = BruteForce(p["mc"], p["lab"], device="cpu")
    bf.fit(p["flux"], p["err"], p["mask"], save_file=full, **p["kw"])
    first = bf.fit(p["flux"][:4], p["err"][:4], p["mask"][:4],
                   return_results=True,
                   **dict(p["kw"], data_coords=p["kw"]["data_coords"][:4],
                          parallax=p["kw"]["parallax"][:4],
                          parallax_err=p["kw"]["parallax_err"][:4]))
    with ResultsWriter(part, 7, 32) as w:
        w.write_batch(0, first, n_valid=4)
        assert w.cursor == 4
    calls = []
    orig = fitting._funnel_step

    def counting(*a, **k):
        calls.append(len(a[2]))
        return orig(*a, **k)

    fitting._funnel_step = counting
    try:
        bf.fit(p["flux"], p["err"], p["mask"], save_file=part, resume=True,
               **p["kw"])
    finally:
        fitting._funnel_step = orig
    assert calls == [2, 1]
    a, b = load_results(full), load_results(part)
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(a["model_idx"], b["model_idx"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    with ResultsWriter(part, 7, 32, resume=True) as w:
        assert w.cursor == 7


ENGINES = {"funnel": dict(engine="fused"),
           "dense": dict(engine="fused", screen_k=0),
           "xla_funnel": dict(engine="xla"),
           "xla_dense": dict(engine="xla", screen_k=0)}


def test_lnprior_ext_values_match_the_jax_formula(setup):
    """The per-batch device form of the label prior equals the JAX
    package's host `(n_data, NMODEL)` table (`fitting.py:720-740`) at
    the asked columns (those past the grid clamped to its last model),
    float32 rounding (rtol 1e-6), zero for stars without a usable
    `(mean, std)` and on the dense grid's padding."""
    p = setup
    rng = np.random.default_rng(3)
    M = len(p["lab"])
    pars = {"feh": np.stack([rng.uniform(-1, 0, 7), np.full(7, 0.2)], 1),
            "loga": np.stack([rng.uniform(8, 10, 7), np.full(7, 0.5)], 1)}
    pars["feh"][2] = [np.nan, 0.2]
    pars["loga"][4, 1] = 0.0
    want = np.zeros((7, M), np.float32)
    for k, pr in pars.items():
        mean, std = pr[:, 0], pr[:, 1]
        ok = np.isfinite(mean) & (std > 0)
        lab = np.asarray(p["lab"][k], float)
        chi2 = (lab[None, :] - np.where(ok, mean, 0.0)[:, None]) ** 2
        ivar = np.where(ok, 1.0 / np.where(ok, std, 1.0) ** 2, 0.0)[:, None]
        const = np.where(ok, np.log(2 * np.pi * np.where(ok, std, 1.0)
                                    ** 2), 0.0)[:, None]
        want += np.where(ok[:, None], -0.5 * (chi2 * ivar + const), 0.0)
    ext = fitting._ExternalPrior(pars, p["lab"], M + 64,
                                 torch.device("cpu"))
    cols = torch.as_tensor(rng.integers(0, M + 64, (3, 50)))
    # a funnel's padding models lie past the grid: clamped, as JAX's
    # `take_along_axis` clamps
    np.testing.assert_allclose(ext.at(2, 5, cols).numpy(),
                               np.take_along_axis(want[2:5], np.minimum(
                                   cols.numpy(), M - 1), 1), rtol=1e-6)
    dense = ext.at(0, 7, None).numpy()
    np.testing.assert_allclose(dense[:, :M], want, rtol=1e-6)
    assert (dense[:, M:] == 0).all() and (dense[2] != 0).any()
    with pytest.raises(ValueError, match="label"):
        fitting._ExternalPrior({"logt": pars["feh"]}, p["lab"], M,
                               torch.device("cpu"))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_lnprior_ext_pulls_the_draws(setup, engine):
    """At SNR 10 (the photometric errors x6), a tight Gaussian prior on
    `feh` (std 0.05) around a target far from the best fit pulls the
    drawn models' median `feh` toward it, on every engine, as it does
    in the JAX package (`test_bruteforce_lnprior_ext`: within 0.4 of
    the target and no farther than the unpinned fit + 0.2); the JAX
    package's own fit with the same prior lands within 0.4 of the
    target too."""
    p = dict(setup, err=setup["err"] * 6.0)
    target = -1.5
    ext = {"feh": np.tile([target, 0.05], (7, 1))}
    kw = dict(ENGINES[engine], Ndraws=64)
    base = _fit(p, **kw)
    pinned = _fit(p, lnprior_ext=ext, **kw)
    feh = p["lab"]["feh"]
    med_b = np.median(feh[base["model_idx"]], axis=1)
    med_p = np.median(feh[pinned["model_idx"]], axis=1)
    assert (np.abs(med_p - target) < np.abs(med_b - target) + 0.2).all()
    assert np.median(np.abs(med_p - target)) < 0.4
    if engine == "funnel":
        j = JBruteForce(p["mc"], p["lab"]).fit(
            p["flux"], p["err"], p["mask"], lnprior_ext=ext,
            return_results=True, **dict(p["kw"], engine="fused", Ndraws=64))
        med_j = np.median(feh[j["model_idx"]], axis=1)
        assert np.median(np.abs(med_j - target)) < 0.4


def test_fit_generator_streams_lazily(setup, monkeypatch):
    """`_fit` yields the reference's 13-tuple per star; taking the first
    star launches at most two batches (one in flight), the whole run
    four (7 stars in batches of 2), and the tuples equal `fit`'s rows."""
    p = setup
    calls = []
    orig = fitting._funnel_step

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(fitting, "_funnel_step", counting)
    bf = BruteForce(p["mc"], p["lab"], device="cpu")
    gen = bf._fit(p["flux"], p["err"], p["mask"], **p["kw"])
    first = next(gen)
    assert len(calls) <= 2
    assert len(first) == 13
    rest = list(gen)
    assert len(calls) == 4 and len(rest) == 6
    monkeypatch.setattr(fitting, "_funnel_step", orig)
    out = _fit(p)
    for i, t in enumerate([first] + rest):
        np.testing.assert_array_equal(t[0], out["model_idx"][i])
        np.testing.assert_allclose(t[9], out["dist"][i], rtol=1e-5)
        assert float(t[7]) == pytest.approx(float(out["log_evidence"][i]),
                                            rel=1e-6)


@pytest.mark.parametrize("engine", ["funnel", "xla_dense"])
def test_return_sel(setup, engine):
    """`return_sel=True` adds the selection's diagnostics: `sel_idx`
    (grid indices, every drawn model among them), `lnp_sel` (finite at
    the valid models) and `valid_sel`; without it they are not
    fetched, and the other rows are the same."""
    p = setup
    a = _fit(p, return_sel=True, **ENGINES[engine])
    b = _fit(p, **ENGINES[engine])
    assert not set(fitting.SEL_KEYS) & set(b)
    _same_rows(a, b)
    K = a["sel_idx"].shape[1]
    assert a["lnp_sel"].shape == (7, K) and a["valid_sel"].dtype == bool
    assert a["valid_sel"].any(1).all()
    for i in range(7):
        assert np.isin(a["model_idx"][i], a["sel_idx"][i]).all()
        assert np.isfinite(a["lnp_sel"][i][a["valid_sel"][i]]).all()
        assert (a["sel_idx"][i] < 1024).all()


def test_pack_gidx_f32_fallback_matches(setup):
    """The selected models' grid indices read from the funnel's integer
    map `global_idx` (exact at any grid size, the path of every fit)
    equal those carried through the pack's float32 `gidx` row (read
    when no map is given; exact below 2**24 models): on a funnel pack
    whose grid indices were permuted, `lnpost_batch` gives the same
    draws either way, and `lnpost_grid` the permuted indices of the same
    draws (`test_fitting.py::test_pack_gidx_f32_fallback_matches` holds
    the JAX package's two paths alike)."""
    p = setup
    tabs = from_numpy_grid(p["mc"], p["lab"], device="cpu", tile=64)
    res = loglike_grid_screened(T(p["flux"]), T(p["err"]), T(p["mask"]),
                                tabs.table, tabs.maskrow, tabs.n_real,
                                tabs.aux_names, cfg=FitConfig(), tile=64,
                                screen_k=256, screen_block=64)
    perm = torch.as_tensor(np.random.default_rng(9).permutation(1024),
                           dtype=torch.int32)
    gidx = perm[res["global_idx"].long()]
    pack = res["pack"].clone()
    pack[:, res["names"].index("gidx")] = gidx.float()
    coord = T(np.tile(COORD, (7, 1)))
    cfg = PosteriorConfig(n_sel_max=64, prefilter_k=64, n_mc_prior=16,
                          n_draws=32)
    noise = TP.draw_noise(2, torch.arange(7), 64, cfg, "cpu")
    a = TP.lnpost_batch(pack, res["names"], res["ndim"], coord, noise,
                        cfg=cfg)
    # given the map, the float row is not read: zeroed, it changes nothing
    no_row = pack.clone()
    no_row[:, res["names"].index("gidx")] = 0.0
    b = TP.lnpost_batch(no_row, res["names"], res["ndim"], coord, noise,
                        global_idx=gidx, cfg=cfg)
    for k in ("model_idx", "sel_idx", "log_evidence"):
        assert torch.equal(a[k], b[k]), k
    # `lnpost_grid` reads the map alone: the permuted map gives the
    # permuted indices of the same fit
    row = {n: pack[:, i] for i, n in enumerate(res["names"])}
    results = dict(lnlike=row["lnlike"], chi2=row["chi2"],
                   scale=row["scale"], av=row["av"], rv=row["rv"],
                   ndim=res["ndim"], icov_parts=tuple(row[n] for n in (
                       "i00", "i11", "i22", "i01", "i02", "i12")))
    noise = TP.draw_noise(2, torch.arange(7), 64, cfg, "cpu", grid=True)
    grid = {name: TP.lnpost_grid(results, row["lnprior"], coord, noise,
                                 global_idx=gi, cfg=cfg)
            for name, gi in (("plain", res["global_idx"]), ("perm", gidx))}
    assert torch.equal(perm[grid["plain"]["model_idx"].long()],
                       grid["perm"]["model_idx"])
    assert torch.equal(grid["plain"]["log_evidence"],
                       grid["perm"]["log_evidence"])


def test_dtype(setup):
    """`BruteForce(dtype=...)` casts the grid as the JAX package does:
    the kernels' engines read float32 tables either way (identical
    rows), and the dense reference engine runs in the grid's dtype,
    float32 close to float64 (log-evidence within 0.05 nats, median
    distances within 1%; the draws follow the same streams)."""
    p = setup
    bf32 = BruteForce(p["mc"].astype(np.float64), p["lab"],
                      dtype=np.float32, device="cpu")
    assert bf32.models.dtype == np.float32
    bf64 = BruteForce(p["mc"], p["lab"], dtype=np.float64, device="cpu")
    assert bf64.models.dtype == np.float64
    run = lambda bf, **kw: bf.fit(p["flux"], p["err"], p["mask"],
                                  return_results=True, **dict(p["kw"], **kw))
    _same_rows(run(bf32), run(bf64))
    a = run(bf32, engine="xla", screen_k=0)
    b = run(bf64, engine="xla", screen_k=0)
    np.testing.assert_allclose(a["log_evidence"], b["log_evidence"],
                               atol=0.05)
    np.testing.assert_allclose(np.median(a["dist"], 1),
                               np.median(b["dist"], 1), rtol=0.01)


REF_OPTIONS = {"ltol": dict(ltol=1e-3),
               "ltol_subthresh": dict(ltol_subthresh=1e-3),
               "mag_space_init": dict(mag_direct_init=False)}


@pytest.mark.parametrize("case", sorted(REF_OPTIONS))
def test_reference_options_steer_only_the_xla_engines(setup, case,
                                                      monkeypatch):
    """`ltol`, `ltol_subthresh` and `mag_direct_init=False` reach only the
    reference-semantics engines, as in the JAX package: the funnel's
    rows do not move (its fit kernel runs fixed budgets from a direct
    seed), while the reference-semantics funnel's likelihood is called
    with them in its `FitConfig` and its rows stay defined, its draws
    on the grid."""
    p = setup
    opt = REF_OPTIONS[case]
    _same_rows(_fit(p), _fit(p, **opt))
    cfgs = []
    orig = fitting.loglike_grid_screened_xla

    def capture(*a, **k):
        cfgs.append(k["cfg"])
        return orig(*a, **k)

    monkeypatch.setattr(fitting, "loglike_grid_screened_xla", capture)
    out = _fit(p, engine="xla", **opt)
    (name, value), = opt.items()
    assert cfgs and all(getattr(c, name) == value for c in cfgs)
    assert np.isfinite(out["log_evidence"]).all()
    assert ((out["model_idx"] >= 0) & (out["model_idx"] < 1024)).all()
