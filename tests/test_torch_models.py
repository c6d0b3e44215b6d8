"""The port's grid generation against `brutus_tpu.models`: interpolation
(`ops/interp.py`), the BC networks, the MIST tracks, the SED grid
generator and the isochrones, on the synthetic files of
`tests/test_models.py` written by the JAX package's writers, and the
carry-across constructors of `convert.py`.

Both packages read the same files (the port through its own readers)
and run in float64; each case states its tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from brutus_tpu.ops import interp as JI
from brutus_tpu.models.nn import (FastNN as JFastNN,
                                  FastNNPredictor as JFastNNPredictor,
                                  write_nn_file)
from brutus_tpu.models.tracks import MISTtracks as JMISTtracks
from brutus_tpu.models.tracks import write_tracks_file
from brutus_tpu.models.sedmaker import SEDmaker as JSEDmaker
from brutus_tpu.models.isochrone import (Isochrone as JIsochrone,
                                         population_seds_multi as j_psm,
                                         write_isochrone_file)
from brutus_tpu_torch import convert
from brutus_tpu_torch.ops import interp as TI
from brutus_tpu_torch.models import (FastNN, FastNNPredictor, MISTtracks,
                                     SEDmaker, Isochrone)
from brutus_tpu_torch.models.isochrone import population_seds_multi
from brutus_tpu_torch.models.tracks import tracks_library

FILTERS = ["PS_g", "PS_r", "PS_i", "PS_z", "PS_y", "2MASS_J"]
NF = len(FILTERS)
XMIN = np.array([2000.0, 0.0, -3.0, -0.3, 0.0, 1.0])
XMAX = np.array([20000.0, 6.0, 1.0, 0.7, 2.5, 6.0])
CPU = "cpu"
T = torch.as_tensor


def analytic_preds(mini, eep, feh, afe):
    """Smooth synthetic stellar physics, monotone in EEP (the generator
    of `tests/test_models.py`)."""
    eep = np.asarray(eep, dtype=float)
    loga = 9.0 + 0.004 * (eep - 350.0) - 1.2 * np.log10(mini)
    logt = 3.75 - 0.2 * (eep - 350.0) / 600.0 + 0.03 * feh \
        + 0.1 * np.log10(mini)
    logl = 3.5 * np.log10(mini) + 0.0015 * (eep - 202.0)
    logg = 4.4 - 0.0012 * (eep - 202.0) - 0.05 * np.log10(mini)
    return {"log_age": loga, "log_Teff": logt, "log_L": logl,
            "log_g": logg, "[Fe/H]": feh - 0.05 + 0 * eep,
            "[a/Fe]": afe + 0 * eep, "star_mass": mini + 0 * eep,
            "log_R": 0.5 * logl - 2 * (logt - 3.76)}


TRACK_GRIDS = (np.arange(0.5, 2.01, 0.25), np.arange(202.0, 606.0, 16.0),
               np.array([-1.0, -0.5, 0.0, 0.5]), np.array([0.0]))


@pytest.fixture(scope="module")
def trackfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mist") / "tracks.h5")
    write_tracks_file(path, *TRACK_GRIDS, analytic_preds)
    return path


@pytest.fixture(scope="module")
def nnfile(tmp_path_factory):
    """An 8-wide network whose corrections vary by magnitudes over the
    label grid (the scales of `examples/_synth.py`), so NaN guards and
    reddening fits see realistic values."""
    path = str(tmp_path_factory.mktemp("nn") / "nn.h5")
    rng = np.random.default_rng(21)
    h = 8
    write_nn_file(path, FILTERS, rng.normal(size=(NF, h, 6)) * 5.0,
                  rng.normal(size=(NF, h, 1)) * 1.0,
                  rng.normal(size=(NF, h, h)) * 1.5,
                  rng.normal(size=(NF, h, 1)) * 0.5,
                  rng.normal(size=(NF, 1, h)) * 6.0,
                  rng.normal(size=(NF, 1, 1)) * 0.3, XMIN, XMAX)
    return path


def _iso_arrays(feh_u, loga_u, eep_u):
    """Isochrone tables in the layout of `tests/test_models.py`, with
    holes: mini from inverting the analytic loga(mini, eep), NaN outside
    0.3-2.5 Msun, and a few interior NaN EEPs that the reader fills."""
    labels = ["mini", "mass", "logl", "logt", "logr", "logg",
              "feh_surf", "afe_surf"]
    grid = np.full((len(feh_u), 1, len(loga_u), len(eep_u), len(labels)),
                   np.nan)
    for i, z in enumerate(feh_u):
        for k, la in enumerate(loga_u):
            mini = 10 ** ((9.0 + 0.004 * (eep_u - 350.0) - la) / 1.2)
            ok = (mini > 0.3) & (mini < 2.5)
            p = analytic_preds(mini, eep_u, z, 0.0)
            cols = [mini, mini, p["log_L"], p["log_Teff"], p["log_R"],
                    p["log_g"], z - 0.05 + 0 * mini, 0 * mini]
            for j, v in enumerate(cols):
                grid[i, 0, k, :, j] = np.where(ok, v, np.nan)
            fin = np.flatnonzero(ok)
            if len(fin) > 6:
                grid[i, 0, k, fin[len(fin) // 2], 2] = np.nan
    return feh_u, np.array([0.0]), loga_u, eep_u, grid, labels


@pytest.fixture(scope="module")
def isofile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iso") / "iso.h5")
    write_isochrone_file(path, *_iso_arrays(
        np.array([-1.0, -0.5, 0.0, 0.5]), np.arange(8.5, 10.01, 0.25),
        np.arange(202.0, 606.0, 8.0)))
    return path


def _eq_nan(a, b, rtol, atol=0.0):
    """Same NaN pattern, finite values within `rtol`, `atol`."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


# --- ops/interp.py ----------------------------------------------------------

def test_interpn_matches_jax_with_holes_and_bad_queries():
    """A 4-D grid with NaN holes and two value axes; queries inside, out
    of range, on the grid's edges and non-finite: NaN pattern equal,
    finite values within 1e-12."""
    rng = np.random.default_rng(3)
    pts = (np.linspace(0, 1, 5), np.linspace(-2, 2, 7),
           np.array([3.0, 3.5, 5.0, 9.0]), np.array([-1e-5, 1e-5]))
    vals = rng.normal(size=(5, 7, 4, 2, 3))
    vals[1, 2, :, :, 0] = np.nan
    vals[3, 5, 2, 1, :] = np.nan
    n = 400
    xi = np.stack([rng.uniform(-0.2, 1.2, n), rng.uniform(-2.5, 2.5, n),
                   rng.uniform(2.5, 9.5, n),
                   rng.uniform(-1.5e-5, 1.5e-5, n)], -1)
    xi[:8] = [[0, -2, 3, -1e-5], [1, 2, 9, 1e-5], [np.nan, 0, 4, 0],
              [0.5, np.inf, 4, 0], [0.5, 0, -np.inf, 0],
              [0.25, 0, 3.5, 0], [1.0, 0.0, 5.0, 1e-5],
              [0.2, -4 / 3, 3.0, 0]]
    got = TI.interpn(tuple(map(T, pts)), T(vals), T(xi)).numpy()
    ref = np.asarray(JI.interpn(tuple(map(jnp.asarray, pts)),
                                jnp.asarray(vals), jnp.asarray(xi)))
    assert np.isnan(got).any() and np.isfinite(got).any()
    _eq_nan(got, ref, rtol=1e-12, atol=1e-12)


def test_monotone_bisect_matches_jax():
    """50 bisection steps of a monotone function that is NaN past a
    point (taken as too high): within 1e-12 of JAX."""
    rng = np.random.default_rng(4)
    lo = np.full(64, 202.0)
    hi = np.full(64, 808.0)
    target = rng.uniform(250.0, 700.0, 64)
    stop = rng.uniform(600.0, 800.0, 64)

    def f(x, xp, asarray):
        tg, st = asarray(target), asarray(stop)
        return xp.where(x > st, np.nan, 1e-3 * (x - tg) ** 3
                        + 0.1 * (x - tg))

    got = TI.interp1d_monotone_bisect(lambda x: f(x, torch, T), T(lo),
                                      T(hi)).numpy()
    ref = np.asarray(JI.interp1d_monotone_bisect(
        lambda x: f(x, jnp, jnp.asarray), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_interp_matches_jnp_interp_on_inf_padded_axis(batched):
    """`ops.interp.interp` against `jnp.interp(..., left=nan, right=nan)`
    over an ascending axis whose tail is +inf (the isochrones' sorted
    masses with invalid entries set to +inf), duplicates included;
    queries below, inside, on the nodes, past the last finite node,
    +-inf and NaN: NaN pattern equal, values within 1e-12."""
    rng = np.random.default_rng(5)
    xps, fps, xs = [], [], []
    for b in range(3):
        xp = np.sort(rng.uniform(0.3, 2.0, 40))
        xp[10] = xp[11]
        xp[-6 - b:] = np.inf
        fp = np.sort(rng.uniform(202.0, 808.0, 40))
        x = np.concatenate([rng.uniform(0.1, 2.5, 50), xp[:5],
                            [np.nan, np.inf, -np.inf, xp[33 - b], 1e300]])
        xps.append(xp)
        fps.append(fp)
        xs.append(x)
    for b in range(3 if batched else 1):
        ref = np.asarray(jnp.interp(xs[b], xps[b], fps[b], left=jnp.nan,
                                    right=jnp.nan))
        if batched:
            got = TI.interp(T(np.stack(xs)), T(np.stack(xps)),
                            T(np.stack(fps)), left=torch.nan,
                            right=torch.nan).numpy()[b]
        else:
            got = TI.interp(T(xs[b]), T(xps[b]), T(fps[b]), left=torch.nan,
                            right=torch.nan).numpy()
        assert np.isnan(ref).any() and np.isfinite(ref).any()
        _eq_nan(got, ref, rtol=1e-12, atol=1e-12)
    # Without fill values, the end values, as jnp.interp.
    got = TI.interp(T(xs[0]), T(xps[0]), T(fps[0])).numpy()
    _eq_nan(got, np.asarray(jnp.interp(xs[0], xps[0], fps[0])), 1e-12)


# --- models/nn.py -----------------------------------------------------------

def test_fastnn_matches_jax(nnfile):
    """`FastNN.nneval` and `FastNNPredictor.sed` from the same file, at
    inputs inside, outside and on the edge of the trained box: NaN
    pattern equal, values within 1e-12."""
    rng = np.random.default_rng(6)
    x = np.stack([rng.uniform(1500, 21000, 200), rng.uniform(-0.5, 6.5, 200),
                  rng.uniform(-3.2, 1.1, 200), rng.uniform(-0.3, 0.7, 200),
                  rng.uniform(0.0, 2.6, 200), rng.uniform(1.0, 6.0, 200)],
                 -1)
    x[0] = XMIN
    x[1] = XMAX
    x[2, 3] = np.nan
    nn = FastNN(filters=FILTERS, nnfile=nnfile, device=CPU)
    jnn = JFastNN(filters=FILTERS, nnfile=nnfile)
    got = nn.nneval(x).numpy()
    assert np.isnan(got).any() and np.isfinite(got).any()
    _eq_nan(got, np.asarray(jnn.nneval(x)), rtol=1e-12, atol=1e-12)

    nnp = FastNNPredictor(filters=FILTERS, nnfile=nnfile, device=CPU)
    jnnp = JFastNNPredictor(filters=FILTERS, nnfile=nnfile)
    kw = dict(logt=rng.uniform(3.5, 4.0, (7, 1)),
              logg=rng.uniform(3.0, 5.0, (7, 1)), feh_surf=-0.2, afe=0.1,
              logl=rng.uniform(-1, 2, (7, 1)), av=np.linspace(0, 3, 5),
              rv=3.1, dist=1500.0)
    got = nnp.sed(**kw).numpy()
    assert got.shape == (7, 5, NF) and np.isnan(got).any()
    _eq_nan(got, np.asarray(jnnp.sed(**kw)), rtol=1e-12, atol=1e-12)


def test_nn_from_numpy_carries_the_jax_weights(nnfile):
    """`convert.nn_from_numpy` on `FastNN.params`: the same corrections
    within 1e-12."""
    jnn = JFastNNPredictor(filters=FILTERS, nnfile=nnfile)
    nn = convert.nn_from_numpy(FILTERS, [np.asarray(p) for p in jnn.params],
                               device=CPU)
    kw = dict(logt=np.linspace(3.6, 3.9, 11), logg=4.2, feh_surf=0.0,
              logl=0.5, av=0.4, rv=3.3, dist=800.0)
    _eq_nan(nn.sed(**kw).numpy(), np.asarray(jnn.sed(**kw)), 1e-12)


# --- models/tracks.py -------------------------------------------------------

def _labels(rng, n):
    return np.stack([rng.uniform(0.4, 2.1, n), rng.uniform(190, 620, n),
                     rng.uniform(-1.1, 0.6, n), np.zeros(n)], axis=-1)


def test_tracks_match_jax(trackfile):
    """`MISTtracks` read by the port from the same file: the tables
    (grid points, padded afe axis, age weights) equal, and
    `get_predictions` with and without corrections, in and out of the
    grid, NaN pattern equal and within 1e-12."""
    tr = MISTtracks(mistfile=trackfile, verbose=False, device=CPU)
    jtr = JMISTtracks(mistfile=trackfile, verbose=False)
    assert tr.predictions == jtr.predictions
    for a, b in zip(tr.xgrid, jtr.xgrid):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _eq_nan(tr.ygrid.numpy(), np.asarray(jtr.ygrid), 0.0)
    labels = _labels(np.random.default_rng(8), 300)
    for corr in (True, False):
        got = tr.get_predictions(labels, apply_corr=corr).numpy()
        ref = np.asarray(jtr.get_predictions(labels, apply_corr=corr))
        assert np.isnan(got).any() and np.isfinite(got).any()
        _eq_nan(got, ref, rtol=1e-12, atol=1e-12)
    one = tr.get_predictions(np.array([1.1, 400.0, 0.1, 0.0]),
                             corr_params=(0.05, -0.1, 20.0, 0.3)).numpy()
    _eq_nan(one, np.asarray(jtr.get_predictions(
        np.array([1.1, 400.0, 0.1, 0.0]),
        corr_params=(0.05, -0.1, 20.0, 0.3))), 1e-12, 1e-12)


def test_tracks_from_numpy_and_from_rows(trackfile):
    """`convert.tracks_from_numpy` on the JAX object's tables, and
    `MISTtracks(library=...)` on the rows `tracks_library` builds in
    memory from the file's generator: the same predictions as JAX,
    within 1e-12."""
    jtr = JMISTtracks(mistfile=trackfile, verbose=False)
    labels = _labels(np.random.default_rng(9), 200)
    ref = np.asarray(jtr.get_predictions(labels))
    carried = convert.tracks_from_numpy(
        [np.asarray(g) for g in jtr.xgrid], np.asarray(jtr.ygrid),
        jtr.predictions, jtr.gridpoints, device=CPU)
    _eq_nan(carried.get_predictions(labels).numpy(), ref, 1e-12, 1e-12)
    rows = MISTtracks(library=tracks_library(*TRACK_GRIDS, analytic_preds),
                      verbose=False, device=CPU)
    _eq_nan(rows.get_predictions(labels).numpy(), ref, 1e-12, 1e-12)


# --- models/sedmaker.py -----------------------------------------------------

@pytest.fixture(scope="module")
def makers(trackfile, nnfile):
    return (SEDmaker(filters=FILTERS, nnfile=nnfile, mistfile=trackfile,
                     verbose=False, device=CPU),
            JSEDmaker(filters=FILTERS, nnfile=nnfile, mistfile=trackfile,
                      verbose=False))


def test_get_eep_and_get_sed_match_jax(makers):
    """`get_eep` on a batch (some secondaries off the tracks) and
    `get_sed` of a single star, a binary of smf 0.5, one past the
    binary EEP cut and one too old: NaN pattern equal, within 1e-9."""
    mk, jmk = makers
    rng = np.random.default_rng(10)
    n = 64
    mini = rng.uniform(0.6, 1.9, n)
    eep = rng.uniform(220.0, 560.0, n)
    feh = rng.uniform(-0.9, 0.4, n)
    smf = rng.uniform(0.2, 1.0, n)
    loga = 9.0 + 0.004 * (eep - 350.0) - 1.2 * np.log10(mini)
    got = mk.get_eep(loga, mini=mini, eep=eep, feh=feh, smf=smf).numpy()
    ref = np.asarray(jmk.get_eep(loga, mini=mini, eep=eep, feh=feh,
                                 smf=smf))
    assert np.isnan(got).any() and np.isfinite(got).any()
    _eq_nan(got, ref, rtol=1e-9, atol=1e-9)
    for kw in (dict(mini=1.1, eep=400.0, feh=-0.2, av=0.3, rv=3.2),
               dict(mini=1.1, eep=400.0, feh=-0.2, av=0.3, rv=3.2, smf=0.5),
               dict(mini=1.1, eep=520.0, feh=-0.2, smf=0.9),
               dict(mini=0.6, eep=590.0, feh=0.3)):
        sed, p1, p2, e2 = mk.get_sed(return_eep2=True, **kw)
        jsed, jp1, jp2, je2 = jmk.get_sed(return_eep2=True, **kw)
        _eq_nan(sed, np.asarray(jsed), 1e-9, 1e-9)
        _eq_nan([p1[k] for k in mk.predictions],
                [jp1[k] for k in jmk.predictions], 1e-9, 1e-9)
        _eq_nan([p2[k] for k in mk.predictions],
                [jp2[k] for k in jmk.predictions], 1e-9, 1e-9)
        _eq_nan([e2], [je2], 1e-9, 1e-9)


GRID_KW = dict(mini_grid=np.arange(0.6, 1.9, 0.15),
               eep_grid=np.arange(220.0, 580.0, 20.0),
               feh_grid=np.array([-0.8, 0.0, 0.4]),
               afe_grid=np.array([0.0]), smf_grid=np.array([0.0, 0.5]),
               verbose=False)


@pytest.fixture(scope="module")
def grids(makers):
    mk, jmk = makers
    mk.make_grid(chunk=97, **GRID_KW)
    jmk.make_grid(chunk=512, **GRID_KW)
    return mk, jmk


def test_make_grid_matches_jax(grids):
    """`make_grid` with single stars and binaries of smf 0.5 (chunks of
    97 models against JAX's 512): the labels and `grid_sel` equal,
    `grid_sed` and `grid_param` with the same NaN pattern and within
    1e-9."""
    mk, jmk = grids
    assert mk.grid_label.dtype == jmk.grid_label.dtype
    np.testing.assert_array_equal(mk.grid_label, jmk.grid_label)
    np.testing.assert_array_equal(mk.grid_sel, jmk.grid_sel)
    assert 0.2 < mk.grid_sel.mean() < 0.95
    for name in FILTERS:
        _eq_nan(mk.grid_sed[name], jmk.grid_sed[name], 1e-9, 1e-9)
    for name in mk.predictions:
        _eq_nan(mk.grid_param[name], jmk.grid_param[name], 1e-9, 1e-9)
    # Binaries are generated too, not only masked.
    binary = mk.grid_sel & (mk.grid_label["smf"] == 0.5)
    assert binary.sum() > 10


def test_to_hdf5_round_trips_with_both_readers(grids, tmp_path):
    """The port's `to_hdf5` read by the port's `io.load_models` and by
    the JAX package's, and the JAX file read by the port's: equal."""
    from brutus_tpu.io import load_models as j_load
    from brutus_tpu_torch.io import load_models as t_load
    mk, jmk = grids
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    mk.to_hdf5(mine)
    jmk.to_hdf5(theirs)
    kw = dict(filters=FILTERS, include_binaries=True, verbose=False)
    a = t_load(mine, **kw)
    for b in (j_load(mine, **kw), t_load(theirs, **kw)):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6, equal_nan=True)
        np.testing.assert_array_equal(a[0], np.asarray(b[0]))
        for name in a[1].dtype.names:
            _eq_nan(a[1][name], b[1][name], 1e-9, 1e-9)
        assert a[2].dtype.names == b[2].dtype.names


# --- models/isochrone.py ----------------------------------------------------

@pytest.fixture(scope="module")
def isos(isofile, nnfile):
    return (Isochrone(filters=FILTERS, nnfile=nnfile, mistfile=isofile,
                      verbose=False, device=CPU),
            JIsochrone(filters=FILTERS, nnfile=nnfile, mistfile=isofile,
                       verbose=False))


@pytest.mark.parametrize("smf", [0.0, 0.6, 1.0])
def test_isochrone_get_seds_matches_jax(isos, smf):
    """`Isochrone.get_seds` (hole-filled tables, single stars, binaries
    of smf 0.6 and equal-mass binaries): NaN pattern equal, within
    1e-10; the tables equal."""
    iso, jiso = isos
    _eq_nan(iso.ygrid.numpy(), np.asarray(jiso.ygrid), 0.0)
    kw = dict(feh=-0.3, loga=9.2, av=0.2, rv=3.1, dist=1200.0,
              mini_bound=0.4, smf=smf,
              eep=np.linspace(202.0, 600.0, 150))
    seds, p1, p2 = iso.get_seds(**kw)
    jseds, jp1, jp2 = jiso.get_seds(**kw)
    assert np.isfinite(seds.numpy()).any()
    _eq_nan(seds.numpy(), np.asarray(jseds), 1e-10, 1e-10)
    for k in iso.predictions:
        _eq_nan(p1[k], jp1[k], 1e-10, 1e-10)
        _eq_nan(p2[k], jp2[k], 1e-10, 1e-10)


def test_population_seds_multi_matches_jax(isos):
    """`population_seds_multi` over three parameter sets (one batch)
    against JAX's function at each, with corrections given: SEDs and
    masses with the same NaN pattern, within 1e-10."""
    iso, jiso = isos
    smf = (0.0, 0.35, 0.6, 0.9, 1.0)
    eep = np.linspace(202.0, 600.0, 180)
    sets = [(-0.3, 9.2, 0.2, 3.1, 900.0, (0.09, -0.09, 30.0, 0.5)),
            (0.2, 9.6, 1.0, 2.8, 2400.0, (0.02, -0.2, 60.0, 1.0)),
            (-0.9, 8.8, 0.0, 3.6, 400.0, (0.2, 0.05, 10.0, -0.5))]
    cols = list(zip(*sets))
    corr = tuple(np.array(c) for c in zip(*cols[5]))
    xgrid, ygrid, nnp = iso.tables
    seds, mini = population_seds_multi(
        xgrid, ygrid, nnp, iso.iso_idx, eep, np.array(cols[0]), 0.0,
        np.array(cols[1]), np.array(cols[2]), np.array(cols[3]),
        np.array(cols[4]), smf, 0.1, 480.0, corr_params=corr)
    jx, jy, jn = jiso.tables
    jfun = jax.jit(lambda *a: j_psm(jx, jy, jn, jiso.iso_idx,
                                    jnp.asarray(eep), a[0], 0.0, *a[1:5],
                                    smf, 0.1, 480.0, corr_params=a[5]))
    for w, (feh, loga, av, rv, dist, cp) in enumerate(sets):
        js, jm = jfun(feh, loga, av, rv, dist, cp)
        assert np.isfinite(seds[w].numpy()).any()
        _eq_nan(seds[w].numpy(), np.asarray(js), 1e-10, 1e-10)
        _eq_nan(mini[w].numpy(), np.asarray(jm), 1e-10, 1e-10)


def test_isochrone_from_numpy_and_from_arrays(isos, nnfile):
    """`convert.isochrone_from_numpy` on the JAX object's tables, and
    `Isochrone(arrays=...)` on arrays built in memory: the same SEDs as
    JAX within 1e-12."""
    _, jiso = isos
    jx, jy, jn = jiso.tables
    carried = convert.isochrone_from_numpy(
        FILTERS, [np.asarray(g) for g in jx], np.asarray(jy),
        jiso.predictions, [np.asarray(p) for p in jn], device=CPU)
    kw = dict(feh=0.1, loga=9.4, av=0.5, rv=3.4, smf=0.7, mini_bound=0.3,
              eep=np.linspace(250.0, 560.0, 90))
    ref = np.asarray(jiso.get_seds(**kw)[0])
    _eq_nan(carried.get_seds(**kw)[0].numpy(), ref, 1e-12, 1e-12)
    mem = Isochrone(filters=FILTERS, verbose=False, device=CPU,
                    arrays=_iso_arrays(np.array([-1.0, -0.5, 0.0, 0.5]),
                                       np.arange(8.5, 10.01, 0.25),
                                       np.arange(202.0, 606.0, 8.0)),
                    nn=carried.FNNP)
    _eq_nan(mem.get_seds(**kw)[0].numpy(), ref, 1e-12, 1e-12)


def test_entry_points_need_a_card_unless_told_cpu(trackfile, nnfile,
                                                  isofile):
    """`SEDmaker` and `Isochrone` run on CUDA by default: without a card
    they raise rather than fall back to the CPU; grids default to
    float64."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SEDmaker(filters=FILTERS, nnfile=nnfile, mistfile=trackfile,
                 verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Isochrone(filters=FILTERS, nnfile=nnfile, mistfile=isofile,
                  verbose=False)
    mk = SEDmaker(filters=FILTERS, nnfile=nnfile, mistfile=trackfile,
                  verbose=False, device=CPU)
    assert mk.ygrid.dtype == torch.float64
    assert mk.FNNP.w1.dtype == torch.float64


def test_models_and_cluster_import_without_h5py_or_jax():
    """`brutus_tpu_torch.models` and `brutus_tpu_torch.cluster` import
    with jax, h5py and `brutus_tpu` made unimportable (the card machine
    has none of them)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "for m in ('jax', 'h5py', 'brutus_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import brutus_tpu_torch.models, brutus_tpu_torch.cluster\n"
            "import brutus_tpu_torch.sampling, brutus_tpu_torch.ops.interp\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
