"""The spans and counters inside `brutus_tpu_torch.BruteForce.fit`
(`profiling.span`, `call`, `count`, `calls`) on the CPU: nothing is
recorded without a profiler; under `torch.profiler` the exported Chrome
trace holds the `bf.*` spans of every stage, strictly nested on one
thread, and each call's record holds its counters; the fit's results
do not depend on whether a profiler records."""

import json

import numpy as np
import pytest
import torch

from brutus_tpu_torch import BruteForce, profiling
from brutus_tpu_torch.config import PosteriorConfig
from brutus_tpu_torch.ops.funnel import _slab_block
from brutus_tpu_torch.ops.posterior import selection_size

N_MODEL, N_STAR, F = 2048, 40, 8
KW = dict(screen_k=512, screen_block=64, tile=64, n_sel_max=256,
          Nmc_prior=16, Ndraws=32, batch_size=8, verbose=False, seed=5,
          return_results=True)
FUNNEL = ("bf.fit", "bf.setup", "bf.grid_prior", "bf.dust", "bf.tables",
          "bf.launch", "bf.upload", "bf.screen", "bf.gather",
          "bf.fit_models", "bf.noise", "bf.select", "bf.mc", "bf.draws",
          "bf.pack", "bf.copy", "bf.wait", "bf.unpack", "bf.write")
STAGES = ("bf.upload", "bf.screen", "bf.gather", "bf.fit_models",
          "bf.noise", "bf.select", "bf.mc", "bf.draws", "bf.pack",
          "bf.copy", "bf.likelihood", "bf.posterior")


class _LadderMap:
    """A dust map with one 16-rung profile per star."""

    def query(self, coords):
        n = np.size(coords[0])
        return (np.linspace(0.05, 5.0, 16),
                np.tile(np.linspace(0.0, 1.0, 16), (n, 1)),
                np.full((n, 16), 0.2))


@pytest.fixture(scope="module")
def problem():
    """A smooth 2048-model grid x 8 bands with `mini`, `feh` and `loga`
    labels, and 40 stars made from its models (every band, parallaxes,
    one sightline)."""
    rng = np.random.default_rng(23)
    u = np.linspace(0, 1, N_MODEL)[:, None]
    waves = lambda lo, hi: lo + (hi - lo) * 0.5 * (1 + np.sin(
        2 * np.pi * (u * rng.uniform(1, 4, F) + rng.uniform(0, 1, F))))
    mc = np.stack([waves(8.0, 15.0), waves(0.4, 1.1), waves(0.05, 0.2)], -1)
    lab = np.zeros(N_MODEL, [("mini", float), ("feh", float),
                             ("loga", float)])
    lab["mini"] = np.round(rng.uniform(0.5, 2.0, N_MODEL), 2)
    lab["feh"] = rng.uniform(-2.0, 0.3, N_MODEL)
    lab["loga"] = rng.uniform(8.0, 10.1, N_MODEL)
    idx = rng.integers(0, N_MODEL, N_STAR)
    av, rv = rng.uniform(0.1, 1.0, N_STAR), rng.uniform(2.9, 3.7, N_STAR)
    dist = rng.uniform(0.7, 1.5, N_STAR)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 20.0
    flux = flux + rng.normal(size=flux.shape) * err
    kw = dict(KW, parallax=1.0 / dist, parallax_err=0.1 / dist,
              data_coords=np.tile([204.7, -19.2], (N_STAR, 1)),
              dustmap=_LadderMap())
    return dict(bf=BruteForce(mc, lab, device="cpu"), flux=flux, err=err,
                mask=np.ones(flux.shape, bool), kw=kw)


def _fit(p, n=N_STAR, **kw):
    k = dict(p["kw"], **kw)
    for key in ("parallax", "parallax_err", "data_coords"):
        k[key] = k[key][:n]
    return p["bf"].fit(p["flux"][:n], p["err"][:n], p["mask"][:n], **k)


def _fresh(p):
    """The problem on a new `BruteForce`, which keeps no set-up yet."""
    bf = p["bf"]
    return dict(p, bf=BruteForce(bf.models, bf.models_labels,
                                 device="cpu"))


def _traced(p, tmp_path, n=N_STAR, **kw):
    """A fit under a CPU profiler: its results, its `bf.*` spans
    `(name, t0, t1, tid)` from the exported trace, and its record."""
    before = len(profiling.calls())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _fit(p, n, **kw)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"],
                     e["tid"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") ==
                    "user_annotation" and e["name"].startswith("bf.")),
                   key=lambda s: (s[1], -s[2]))
    records = profiling.calls()
    assert len(records) == before + 1
    return out, spans, records[-1]


def _parents(spans):
    """Each span's parent (innermost enclosing span), checking that the
    spans nest strictly on one thread."""
    assert len({s[3] for s in spans}) == 1
    stack, parent = [], []
    for s in spans:
        while stack and stack[-1][2] <= s[1]:
            stack.pop()
        if stack:
            assert s[2] <= stack[-1][2], ("overlap", stack[-1], s)
        parent.append(stack[-1][0] if stack else None)
        stack.append(s)
    return parent


def test_off_records_nothing(problem):
    """Without a profiler a span and a call are one shared null object,
    and a fit keeps no record."""
    assert not profiling.recording()
    assert profiling.span("bf.screen") is profiling.span("bf.mc")
    assert profiling.call("bf.fit") is profiling.span("bf.fit")
    assert isinstance(profiling.span("bf.fit"),
                      type(profiling.contextlib.nullcontext()))
    profiling._CALLS.clear()
    _fit(problem, 16)
    profiling.count("h2d_bytes", 1)
    assert profiling.calls() == []


@pytest.mark.parametrize("scan", [1, 2])
def test_funnel_spans_nest_inside_their_group(problem, tmp_path, scan):
    """Every funnel span, one `bf.fit` per call at the root; the spans
    nest strictly on one thread; each batch's stage spans lie inside
    their group's `bf.launch` (5 batches of 8, in groups of `scan`)."""
    _, spans, _ = _traced(problem, tmp_path, scan_batches=scan,
                          save_file=str(tmp_path / "out"))
    names = [s[0] for s in spans]
    assert set(FUNNEL) <= set(names)
    assert names.count("bf.fit") == 1 and names[0] == "bf.fit"
    parent = _parents(spans)
    groups = -(-5 // scan)
    assert names.count("bf.launch") == groups
    for name in ("bf.screen", "bf.gather", "bf.fit_models", "bf.noise",
                 "bf.select", "bf.mc", "bf.draws", "bf.pack"):
        assert names.count(name) == 5, name
    for name in ("bf.upload", "bf.copy", "bf.wait", "bf.unpack",
                 "bf.write"):
        assert names.count(name) == groups, name
    fit = spans[0]
    for s, up in zip(spans, parent):
        if s[0] != "bf.fit":
            assert fit[1] <= s[1] and s[2] <= fit[2]
        if s[0] in STAGES:
            launch = [g for g in spans if g[0] == "bf.launch"
                      and g[1] <= s[1] and s[2] <= g[2]]
            assert len(launch) == 1, s
        if s[0] in ("bf.setup", "bf.dust", "bf.tables", "bf.launch",
                    "bf.wait", "bf.unpack", "bf.write"):
            assert up == "bf.fit", (s, up)
    assert dict(zip(names, parent))["bf.grid_prior"] == "bf.setup"


def test_counters_of_a_call(problem, tmp_path):
    """The first call's record on a new `BruteForce`: its four counters,
    K selected columns per star, a valid share in (0, 1], the tables
    built (not reused) and at least the table's bytes uploaded."""
    _, _, rec = _traced(_fresh(problem), tmp_path)
    c = rec["counters"]
    assert rec["t0"] < rec["t1"]
    block = _slab_block(KW["screen_block"], KW["tile"])
    P = KW["screen_k"] // block * block
    K = selection_size(PosteriorConfig(n_sel_max=KW["n_sel_max"]), P)
    assert sorted(c) == ["h2d_bytes", "k4_columns", "k4_valid",
                         "setup_reused"]
    assert c["k4_columns"] == K * N_STAR
    assert isinstance(c["k4_valid"], int)
    assert 0 < c["k4_valid"] <= c["k4_columns"]
    assert c["setup_reused"] == 0
    table_bytes = 4 * (3 * F + 3) * N_MODEL
    assert c["h2d_bytes"] >= table_bytes


def test_a_repeated_call_reuses_the_set_up(problem, tmp_path):
    """A second call with the same settings reuses the tables: it
    records `setup_reused` 1, uploads fewer bytes than the table, and
    still opens `bf.grid_prior` and `bf.tables`."""
    p = _fresh(problem)
    _fit(p, 8)
    _, spans, rec = _traced(p, tmp_path)
    c = rec["counters"]
    assert c["setup_reused"] == 1
    assert 0 < c["h2d_bytes"] < 4 * (3 * F + 3) * N_MODEL
    names = [s[0] for s in spans]
    assert names.count("bf.grid_prior") == names.count("bf.tables") == 1


def test_results_do_not_depend_on_the_profiler(problem, tmp_path):
    """The same seed gives bit-identical results with and without a
    profiler recording."""
    off = _fit(problem)
    on, _, _ = _traced(problem, tmp_path)
    assert sorted(off) == sorted(on)
    for k in off:
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)


@pytest.mark.parametrize("engine", ["dense", "xla_funnel", "xla_dense"])
def test_other_engines_spans(problem, tmp_path, engine):
    """The dense and reference-semantics engines: the entry and group
    spans, and one `bf.likelihood` and one `bf.posterior` per batch
    (8 stars in one batch) with `lnpost_grid`'s `bf.select`, `bf.mc`
    and `bf.draws` inside it; `bf.noise` in the dense engine alone;
    none of the funnel's likelihood stages; and, on the first call of a
    new `BruteForce`, at least the grid's coefficients counted as
    uploaded."""
    kw = dict(dense=dict(screen_k=0), xla_funnel=dict(engine="xla"),
              xla_dense=dict(engine="xla", screen_k=0))[engine]
    _, spans, rec = _traced(_fresh(problem), tmp_path, 8, **kw)
    names = [s[0] for s in spans]
    parent = dict(zip(names, _parents(spans)))
    assert names.count("bf.likelihood") == names.count("bf.posterior") == 1
    assert {"bf.fit", "bf.setup", "bf.tables", "bf.launch", "bf.upload",
            "bf.pack", "bf.copy", "bf.wait", "bf.unpack"} <= set(names)
    for name in ("bf.select", "bf.mc", "bf.draws"):
        assert names.count(name) == 1 and parent[name] == "bf.posterior"
    assert names.count("bf.noise") == (engine == "dense")
    assert not set(names) & {"bf.screen", "bf.gather", "bf.fit_models"}
    assert rec["counters"]["h2d_bytes"] >= 4 * 3 * F * N_MODEL


def test_dense_stage_spans_in_order(problem, tmp_path):
    """The dense engine, 5 batches of 8: each batch's `bf.launch` holds
    `bf.likelihood`, `bf.noise` and `bf.posterior` in that order, and
    `bf.posterior` holds `bf.select`, `bf.mc` and `bf.draws` in that
    order."""
    _, spans, _ = _traced(problem, tmp_path, screen_k=0)
    parent = _parents(spans)
    launches = [s for s in spans if s[0] == "bf.launch"]
    assert len(launches) == 5
    for g in launches:
        inside = [(s[0], up) for s, up in zip(spans, parent)
                  if g[1] <= s[1] and s[2] <= g[2] and s is not g]
        stages = [n for n, _ in inside if n in (
            "bf.likelihood", "bf.noise", "bf.select", "bf.mc", "bf.draws")]
        assert stages == ["bf.likelihood", "bf.noise", "bf.select",
                          "bf.mc", "bf.draws"]
        ups = dict(inside)
        assert ups["bf.likelihood"] == ups["bf.noise"] == "bf.launch"
        assert ups["bf.posterior"] == "bf.launch"
        assert ups["bf.select"] == ups["bf.mc"] == ups["bf.draws"] == \
            "bf.posterior"


def test_dense_results_do_not_depend_on_the_profiler(problem, tmp_path):
    """The dense engine's results, bit for bit, with and without a
    profiler recording (the same seed)."""
    off = _fit(problem, screen_k=0)
    on, _, _ = _traced(problem, tmp_path, screen_k=0)
    assert sorted(off) == sorted(on)
    for k in off:
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)
