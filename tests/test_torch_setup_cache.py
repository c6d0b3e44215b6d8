"""The set-up `brutus_tpu_torch.BruteForce` keeps between `fit` calls
(the default grid prior and the device tables), on the CPU: a call that
reuses them returns what a fresh `BruteForce` returns, bit for bit, on
every engine; a change to any input of the tables' build rebuilds them;
and the per-call `lnprior_ext` leaves the kept tables as they were.
Each call's record (under a profiler) says whether it reused them
(`setup_reused`)."""

import numpy as np
import pytest
import torch

from brutus_tpu_torch import BruteForce, profiling

N_MODEL, N_STAR, F = 1024, 6, 8
KW = dict(screen_k=256, screen_block=64, tile=64, n_sel_max=64,
          Nmc_prior=16, Ndraws=32, batch_size=4, verbose=False,
          return_results=True)
ENGINES = {"funnel": dict(), "dense": dict(screen_k=0),
           "xla_funnel": dict(engine="xla"),
           "xla_dense": dict(engine="xla", screen_k=0)}


@pytest.fixture(scope="module")
def problem():
    """A smooth 1024-model grid x 8 bands with `mini`, `feh`, `loga` and
    `agewt` labels, and 6 stars made from its models, with parallaxes."""
    rng = np.random.default_rng(61)
    u = np.linspace(0, 1, N_MODEL)[:, None]
    waves = lambda lo, hi: lo + (hi - lo) * 0.5 * (1 + np.sin(
        2 * np.pi * (u * rng.uniform(1, 4, F) + rng.uniform(0, 1, F))))
    mc = np.stack([waves(8.0, 15.0), waves(0.4, 1.1), waves(0.05, 0.2)], -1)
    lab = np.zeros(N_MODEL, [("mini", float), ("feh", float),
                             ("loga", float), ("agewt", float)])
    lab["mini"] = np.round(rng.uniform(0.5, 2.0, N_MODEL), 2)
    lab["feh"] = rng.uniform(-2.0, 0.3, N_MODEL)
    lab["loga"] = rng.uniform(8.0, 10.1, N_MODEL)
    lab["agewt"] = rng.uniform(0.2, 2.0, N_MODEL)
    idx = rng.integers(0, N_MODEL, N_STAR)
    av, rv = rng.uniform(0.1, 1.0, N_STAR), rng.uniform(2.9, 3.7, N_STAR)
    dist = rng.uniform(0.7, 1.5, N_STAR)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 20.0
    flux = flux + rng.normal(size=flux.shape) * err
    kw = dict(KW, parallax=1.0 / dist, parallax_err=0.1 / dist,
              data_coords=np.tile([204.7, -19.2], (N_STAR, 1)))
    return dict(mc=mc, lab=lab, flux=flux, err=err,
                mask=np.ones(flux.shape, bool), kw=kw)


def _new(p):
    return BruteForce(p["mc"], p["lab"], device="cpu")


def _fit(p, bf, **kw):
    """`bf.fit` under a CPU profiler: its results and its counters."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = bf.fit(p["flux"], p["err"], p["mask"], **dict(p["kw"], **kw))
    return out, profiling.calls()[-1]["counters"]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _table_bytes(bf):
    """Copies of the kept tables' tensors."""
    return {k: v.clone() for k, v in vars(bf._tables[2]).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_second_call_reuses_and_matches_a_fresh_object(problem, engine):
    """The second call on one `BruteForce` reuses its set-up and returns
    every field bit-identical to a fresh `BruteForce`'s call with the
    same seed; the first call built it and uploaded it."""
    bf = _new(problem)
    _, c1 = _fit(problem, bf, seed=3, **ENGINES[engine])
    out, c2 = _fit(problem, bf, seed=4, **ENGINES[engine])
    fresh, c3 = _fit(problem, _new(problem), seed=4, **ENGINES[engine])
    assert (c1["setup_reused"], c2["setup_reused"],
            c3["setup_reused"]) == (0, 1, 0)
    assert c2["h2d_bytes"] < c1["h2d_bytes"] == c3["h2d_bytes"]
    _equal(out, fresh)


def _other_prior(p):
    return np.random.default_rng(5).normal(0.0, 1.0, N_MODEL)


# Each changes one input of the tables' build from the first call's.
CHANGES = {"lnprior": dict(lnprior=_other_prior),
           "apply_agewt": dict(apply_agewt=False),
           "apply_grad": dict(apply_grad=False),
           "apply_dlabels": dict(apply_dlabels=False),
           "tile": dict(tile=128),
           "dense_after_funnel": dict(screen_k=0)}


@pytest.mark.parametrize("case", sorted(CHANGES))
def test_a_changed_input_rebuilds(problem, case):
    """A call that changes an input of the build (the grid prior, its
    flags, `apply_dlabels`, `tile`, the engine) rebuilds the tables and
    returns what a fresh `BruteForce` returns; only the newest build is
    kept, so going back rebuilds too."""
    kw = {k: v(problem) if callable(v) else v
          for k, v in CHANGES[case].items()}
    bf = _new(problem)
    first, _ = _fit(problem, bf, seed=7)
    out, c = _fit(problem, bf, seed=7, **kw)
    fresh, _ = _fit(problem, _new(problem), seed=7, **kw)
    assert c["setup_reused"] == 0
    _equal(out, fresh)
    back, c = _fit(problem, bf, seed=7)
    assert c["setup_reused"] == 0
    _equal(back, first)


def test_a_prior_changed_in_place_rebuilds(problem):
    """The caller's own `lnprior` is compared by content: the same array
    changed in place between calls rebuilds; unchanged, it is reused."""
    bf = _new(problem)
    prior = _other_prior(problem)
    _fit(problem, bf, seed=2, lnprior=prior)
    _, c = _fit(problem, bf, seed=2, lnprior=prior)
    assert c["setup_reused"] == 1
    prior[::3] += 1.0
    out, c = _fit(problem, bf, seed=2, lnprior=prior)
    fresh, _ = _fit(problem, _new(problem), seed=2, lnprior=prior.copy())
    assert c["setup_reused"] == 0
    _equal(out, fresh)


def test_the_kept_grid_prior_is_read_only(problem):
    """The default grid prior kept for later calls cannot be written."""
    bf = _new(problem)
    _fit(problem, bf, seed=1)
    (prior,) = bf._priors.values()
    with pytest.raises(ValueError):
        prior[0] = 0.0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_lnprior_ext_leaves_the_kept_tables(problem, engine):
    """A call with `lnprior_ext` between two plain calls reuses the
    tables and leaves their bytes as they were; the third call returns
    what the first returned."""
    bf = _new(problem)
    first, _ = _fit(problem, bf, seed=9, **ENGINES[engine])
    before = _table_bytes(bf)
    feh = np.column_stack([np.full(N_STAR, -0.5), np.full(N_STAR, 0.3)])
    _, c = _fit(problem, bf, seed=9, lnprior_ext={"feh": feh},
                **ENGINES[engine])
    assert c["setup_reused"] == 1
    after = _table_bytes(bf)
    assert sorted(before) == sorted(after)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    third, c = _fit(problem, bf, seed=9, **ENGINES[engine])
    assert c["setup_reused"] == 1
    _equal(third, first)
