"""The port's device mesh (`brutus_tpu_torch.parallel`) and
`BruteForce.fit(mesh=...)` on `torch.distributed`, on the CPU with gloo.

One world of four spawned CPU processes (one thread each, a file
rendezvous under a temporary directory, a 240 s timeout on the whole
world) runs every case of `CASES` once, in order, each rank on its own
mesh coordinates; each case then has its own test against a
single-process run of the port in this process.  The cases mirror
`tests/test_parallel.py` and `tests/test_screen_xla.py::
test_xla_funnel_model_mesh`, on copies of their problems (the workers
import no jax: the generators below are numpy copies of
`tests/test_fitting.py::make_grid`, `make_star` and
`tests/test_pallas.py::_problem`).

Tolerance: the mesh's results equal the single-process ones bit for bit
(each star's random stream is keyed by its global row, the shortlist
set and order are the same, the merges add only zeros and take
maxima) on meshes whose `data` axis is 1; with a `data` axis over 1
they are held to the JAX package's limits, for the reason
`_fit_equal` gives.  The JAX-parity tests run in this process
against the JAX package on conftest's virtual 8-device CPU mesh.
"""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch

from brutus_tpu_torch import BruteForce
from brutus_tpu_torch import parallel as TPAR
from brutus_tpu_torch.parallel.mesh import _mesh_shape

WORLD = 4
WORLD_TIMEOUT = 240.0
NFILT = 8
COORD = np.array([204.7, -19.2])


# ---------------------------------------------------------------------------
# Problems (numpy copies of the JAX tests' generators)
# ---------------------------------------------------------------------------

def jax_test_grid():
    """`tests/test_fitting.py::make_grid`: 256 models x 8 bands, float64,
    labels mini, feh, loga, agewt."""
    rng = np.random.default_rng(11)
    n = 256
    mags = rng.uniform(8.0, 16.0, size=(n, NFILT))
    r0 = rng.uniform(0.4, 1.1, size=(n, NFILT))
    dr = rng.uniform(0.05, 0.2, size=(n, NFILT))
    mc = np.stack([mags, r0, dr], axis=-1)
    names = ("mini", "feh", "loga", "agewt")
    labels = np.zeros(n, dtype=[(k, float) for k in names])
    labels["mini"] = rng.uniform(0.5, 2.0, n)
    labels["feh"] = rng.uniform(-2.0, 0.3, n)
    labels["loga"] = rng.uniform(8.0, 10.1, n)
    labels["agewt"] = rng.uniform(0.5, 2.0, n)
    mask = np.ones(1, dtype=[(k, bool) for k in names])
    return mc, labels, mask


def jax_test_stars(mc):
    """`tests/test_parallel.py::problem`: 4 stars of models 20, 27, 34,
    41 at Av 0.4, Rv 3.3, 1.1 kpc, SNR 80."""
    data, errs = np.zeros((4, NFILT)), np.zeros((4, NFILT))
    for i in range(4):
        idx = 20 + 7 * i
        rng = np.random.default_rng(1000 + idx)
        sed = mc[idx, :, 0] + 0.4 * (mc[idx, :, 1] + 3.3 * mc[idx, :, 2])
        flux = 10 ** (-0.4 * sed) / 1.1 ** 2
        errs[i] = flux / 80.0
        data[i] = flux + rng.normal(size=NFILT) * errs[i]
    return data, errs, np.ones((4, NFILT), bool), np.tile(COORD, (4, 1))


def pallas_problem(n_model, n_star, rng, n_filt=8):
    """`tests/test_pallas.py::_problem`."""
    mc = np.stack([rng.uniform(8.0, 16.0, (n_model, n_filt)),
                   rng.uniform(0.4, 1.1, (n_model, n_filt)),
                   rng.uniform(0.05, 0.2, (n_model, n_filt))],
                  axis=-1).astype(np.float32)
    idx = rng.integers(0, n_model, n_star)
    av = rng.uniform(0.1, 1.2, n_star)
    rv = rng.uniform(2.8, 3.8, n_star)
    dist = rng.uniform(0.5, 2.0, n_star)
    sed = (mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                          + rv[:, None] * mc[idx, :, 2]))
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * err
    return mc, flux.astype(np.float32), err.astype(np.float32), idx, dist


def _labels3(rng, M):
    lab = np.zeros(M, [("mini", float), ("feh", float), ("loga", float)])
    lab["mini"] = rng.uniform(0.5, 2.0, M)
    lab["feh"] = rng.uniform(-2.0, 0.3, M)
    lab["loga"] = rng.uniform(8.0, 10.1, M)
    return lab


def xla_funnel_problem():
    """`tests/test_screen_xla.py::test_xla_funnel_model_mesh`'s problem:
    1000 models (padded to 1024: shard 1 of 2 alone holds model 999,
    whose faint copy pads the shortlists), 4 stars.  A fifth star of
    model 995 puts that padding into a shortlist."""
    rng = np.random.default_rng(214)
    mc, flux, err, idx, dist = pallas_problem(1000, 4, rng)
    labels = _labels3(rng, len(mc))
    sed = mc[995, :, 0] + 0.5 * (mc[995, :, 1] + 3.1 * mc[995, :, 2])
    f5 = 10 ** (-0.4 * sed)
    e5 = f5 / 60.0
    f5 = f5 + rng.normal(size=f5.shape) * e5
    flux = np.vstack([flux, f5.astype(np.float32)])
    err = np.vstack([err, e5.astype(np.float32)])
    dist = np.append(dist, 1.0)
    return mc, labels, flux, err, dist


def wide_problem():
    """`tests/test_parallel.py::
    test_screened_engine_model_mesh_wide_filters`: 1024 models x 49
    bands, 4 stars."""
    rng = np.random.default_rng(31)
    M, F, n_star = 1024, 49, 4
    mc = np.stack([rng.uniform(8.0, 16.0, (M, F)),
                   rng.uniform(0.4, 1.1, (M, F)),
                   rng.uniform(0.05, 0.2, (M, F))],
                  axis=-1).astype(np.float32)
    idx = rng.integers(0, M, n_star)
    av = rng.uniform(0.2, 1.0, n_star)
    dist = rng.uniform(0.7, 1.5, n_star)
    sed = (mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                          + 3.3 * mc[idx, :, 2]))
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    errs = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * errs
    labels = _labels3(rng, M)
    return mc, labels, flux, errs, dist


def base_kw(n):
    return dict(data_coords=np.tile(COORD, (n, 1)),
                parallax=np.full(n, 1.0), parallax_err=np.full(n, 0.05),
                Nmc_prior=16, Ndraws=32, batch_size=4, n_sel_max=64,
                verbose=False, return_results=True)


FUNNEL_KW = dict(n_sel_max=32, engine="fused", tile=64, screen_k=128)


def fit_case(name):
    """`(BruteForce arguments, data arguments, fit keywords, mesh
    shape)` of the fit case `name`."""
    mc, labels, lmask = jax_test_grid()
    data, errs, mask, coords = jax_test_stars(mc)
    kw = base_kw(4)
    if name in ("funnel_model_mesh", "funnel_data_mesh", "save_file"):
        kw.update(FUNNEL_KW)
        shape = (4, 1) if name == "funnel_data_mesh" else (2, 2)
        return (mc, labels, lmask), (data, errs, mask), kw, shape
    if name == "dense_data_mesh":
        kw.update(engine="fused", tile=64)
        return (mc, labels, lmask), (data, errs, mask), kw, (4, 1)
    if name == "model_only_mesh":
        return (mc, labels, lmask), (data, errs, mask), kw, (1, 4)
    if name == "ext_prior_padding":
        kw.update(Nmc_prior=8, Ndraws=16, n_sel_max=32, lnprior_ext={
            "feh": np.tile([[-0.5, 0.3]], (4, 1))})
        kw.pop("parallax"), kw.pop("parallax_err")
        return (mc[:250], labels[:250], lmask), (data, errs, mask), kw, \
            (1, 4)
    if name == "xla_funnel_model_mesh":
        mc, labels, flux, err, dist = xla_funnel_problem()
        n = len(flux)
        kw = dict(data_coords=np.tile(COORD, (n, 1)), parallax=1.0 / dist,
                  parallax_err=0.05 / dist, Nmc_prior=16, Ndraws=32,
                  n_sel_max=32, batch_size=4, verbose=False,
                  return_results=True, engine="xla", screen_k=256,
                  screen_block=32)
        return (mc, labels, None), (flux, err, np.ones(flux.shape, bool)), \
            kw, (2, 2)
    if name == "wide_filters":
        mc, labels, flux, errs, dist = wide_problem()
        n = len(flux)
        kw = dict(data_coords=np.tile(COORD, (n, 1)), parallax=1.0 / dist,
                  parallax_err=0.02 / dist, Nmc_prior=8, Ndraws=16,
                  batch_size=4, n_sel_max=32, verbose=False,
                  return_results=True, engine="fused", tile=64,
                  screen_k=128)
        return (mc, labels, None), (flux, errs, np.ones(flux.shape, bool)), \
            kw, (2, 2)
    raise KeyError(name)


FIT_CASES = ("funnel_model_mesh", "funnel_data_mesh", "dense_data_mesh",
             "xla_funnel_model_mesh", "model_only_mesh", "ext_prior_padding",
             "wide_filters", "save_file")

# The three errors of `brutus_tpu/fitting.py:763-775`: (mesh shape, fit
# keywords, exception, message).
ERRORS = {
    "dense_fused_model_mesh": ((1, 4), dict(engine="fused", screen_k=0),
                               ValueError, "funnel"),
    "ext_prior_sharded_funnel": ((1, 4), dict(
        engine="fused", tile=64, screen_k=128,
        lnprior_ext={"feh": np.tile([[-0.5, 0.3]], (4, 1))}),
        NotImplementedError, "lnprior_ext"),
    "batch_not_divisible": ((2, 2), dict(batch_size=3), ValueError,
                            "divisible"),
}

# `_select_blocks_sharded` against the JAX package's: 8 stars, 64 local
# blocks on each of 4 shards, 12 blocks kept, blocks of 8 models.
SEL = dict(B=8, nblocks=64, nb=12, block=8)


def select_scores():
    rng = np.random.default_rng(41)
    return rng.normal(size=(SEL["B"], WORLD * SEL["nblocks"])).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

def _world_main(rank, rdv, out_dir):
    """One rank of the four-process world: every case in order; what
    the tests read is pickled to `out_dir/rank<r>.pkl`."""
    import torch.distributed as dist
    from brutus_tpu_torch.config import FitConfig
    from brutus_tpu_torch.convert import from_numpy_grid
    from brutus_tpu_torch.ops.funnel import _select_blocks_sharded
    from brutus_tpu_torch.ops.screen_xla import loglike_grid_screened_xla
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT))
    TPAR.initialize()                      # an existing world is joined
    rec = {"rank": rank}

    def run(name, fn):
        t0 = time.time()
        try:
            rec[name] = fn()
        except Exception as err:           # recorded; the test fails
            rec[name] = err
        rec[name + ":seconds"] = time.time() - t0

    def meshes():
        m = TPAR.make_mesh()
        out = dict(default=(dict(m.shape), m.coords))
        m = TPAR.make_mesh(n_data=2)
        out["n_data=2"] = (dict(m.shape), m.coords)
        m = TPAR.make_mesh(n_model=1)
        out["n_model=1"] = (dict(m.shape), m.coords)
        try:
            TPAR.make_mesh(n_data=3)
        except ValueError as err:
            out["n_data=3"] = str(err)
        return out
    run("meshes", meshes)

    def shards():
        mc, _, _ = jax_test_grid()
        mesh = TPAR.make_mesh(n_data=1, n_model=WORLD)
        dev, (lab,), n = TPAR.shard_grid(mesh, mc[:250], np.arange(250.0))
        return dev.numpy(), lab.numpy(), n
    run("shard_grid", shards)

    def select():
        mesh = TPAR.make_mesh(n_data=1, n_model=WORLD)
        nbl = SEL["nblocks"]
        local = torch.as_tensor(select_scores()[:, rank * nbl:
                                                (rank + 1) * nbl])
        bidx, idx, mine = _select_blocks_sharded(
            local, SEL["nb"], SEL["block"], mesh.get_group("model"))
        return bidx.numpy(), idx.numpy(), mine.numpy()
    run("select_blocks", select)

    def fit(name, save_file=None):
        bf_args, args, kw, shape = fit_case(name)
        mesh = TPAR.make_mesh(*shape)
        bf = BruteForce(*bf_args, device="cpu")
        return bf.fit(*args, mesh=mesh, save_file=save_file, **kw)
    for name in FIT_CASES:
        if name == "save_file":
            run(name, lambda: fit(name, os.path.join(out_dir, "mesh.h5")))
        else:
            run(name, lambda: fit(name))

    def shortlists():
        """The reference-semantics funnel's shortlists on the 2 x 2
        mesh, every rank on all stars."""
        mc, labels, flux, err, dist = xla_funnel_problem()
        mesh = TPAR.make_mesh(n_data=2, n_model=2)
        tabs = from_numpy_grid(mc, labels, device="cpu",
                               lnprior=np.zeros(len(mc)), n_shards=2,
                               shard=mesh.coords[1])
        t = torch.as_tensor
        res = loglike_grid_screened_xla(
            t(flux), t(err), torch.ones(flux.shape, dtype=torch.bool),
            tabs.table, tabs.maskrow, tabs.n_real, tabs.aux_names,
            parallax=t(1.0 / dist).float(),
            parallax_err=t(0.05 / dist).float(),
            cfg=FitConfig(mag_direct_init=True), screen_k=256,
            screen_block=32, last=tabs.last,
            model_group=mesh.get_group("model"))
        return {k: res[k].numpy() for k in ("lnlike", "chi2", "scale", "av",
                                            "rv", "global_idx")}
    run("xla_shortlists", shortlists)

    def errors():
        out = {}
        mc, labels, lmask = jax_test_grid()
        data, errs, mask, coords = jax_test_stars(mc)
        for name, (shape, kw, _, _) in ERRORS.items():
            mesh = TPAR.make_mesh(*shape)
            k = dict(base_kw(4), **kw)
            try:
                BruteForce(mc, labels, lmask, device="cpu").fit(
                    data, errs, mask, mesh=mesh, **k)
                out[name] = None
            except Exception as err:
                out[name] = (type(err), str(err))
        return out
    run("errors", errors)

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)
    dist.destroy_process_group()


def spawn_world(fn, n, args, deadline):
    """Run `fn(rank, *args)` in `n` spawned processes; raise if one fails
    or the world outlives `deadline` seconds (then it is killed)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    t_end = time.time() + deadline
    try:
        while not ctx.join(timeout=5):
            if time.time() > t_end:
                raise TimeoutError(f"world of {n} outlived {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' records, by rank."""
    d = tmp_path_factory.mktemp("world")
    t0 = time.time()
    spawn_world(_world_main, WORLD, (str(d / "rdv"), str(d)), WORLD_TIMEOUT)
    recs = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    recs[0]["dir"] = d
    recs[0]["world_seconds"] = time.time() - t0
    return recs


@pytest.fixture
def two_threads():
    """Two intra-op threads for this process's single-process runs, so
    the world's four processes and the other test workers keep the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _got(world, name, rank=0):
    v = world[rank][name]
    if isinstance(v, Exception):
        raise AssertionError(f"case {name} failed on rank {rank}: "
                             f"{type(v).__name__}: {v}") from v
    return v


def _single(name, **extra):
    bf_args, args, kw, _ = fit_case(name)
    return BruteForce(*bf_args, device="cpu").fit(*args, **dict(kw, **extra))


def _assert_equal(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# The mesh API against the JAX package, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,fill", [(10, None), (12, None), (7, -1.0)])
def test_pad_to_multiple_matches_jax(n, fill):
    """`pad_to_multiple` equals the JAX package's, array and length."""
    from brutus_tpu.parallel import pad_to_multiple as j_pad
    x = np.arange(2.0 * n).reshape(n, 2)
    for axis in (0, 1):
        got, m = TPAR.pad_to_multiple(x, 4, axis=axis, fill=fill)
        want, mj = j_pad(x, 4, axis=axis, fill=fill)
        np.testing.assert_array_equal(got, want)
        assert m == mj


def test_mesh_shapes_match_jax():
    """The mesh shapes of `make_mesh`'s defaults over 8 devices, and its
    `ValueError`, as the JAX package's on conftest's 8 virtual
    devices."""
    from brutus_tpu.parallel import make_mesh as j_make_mesh
    for kw in (dict(), dict(n_data=2, n_model=4), dict(n_data=2),
               dict(n_model=2), dict(n_data=8), dict(n_model=1)):
        jm = j_make_mesh(**kw)
        assert _mesh_shape(8, **kw) == (jm.shape["data"], jm.shape["model"])
    for kw in (dict(n_data=3), dict(n_data=2, n_model=2), dict(n_model=5)):
        with pytest.raises(ValueError):
            j_make_mesh(**kw)
        with pytest.raises(ValueError, match="devices"):
            _mesh_shape(8, **kw)


def test_initialize_single_process(monkeypatch):
    """`initialize()` with one process and no coordinator warns and
    carries on (twice: idempotent), creating no process group; the mesh
    then spans this process's device (JAX: `test_initialize_single_
    process`).  A world of several processes without a coordinator
    raises."""
    import torch.distributed as dist
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for _ in range(2):
        with pytest.warns(UserWarning, match="single-process"):
            TPAR.initialize()
    assert not dist.is_initialized()
    mesh = TPAR.make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices.size == 1 and mesh.get_group("model") is None
    with pytest.raises(ValueError, match="one rank per device"):
        TPAR.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="coordinator"):
        TPAR.initialize(num_processes=2, process_id=0)


def test_placements():
    """The DTensor placements of the three shardings (JAX: `P("model")`,
    `P("data")`, `P()` on the `("data", "model")` mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    assert TPAR.model_sharding(None) == (Replicate(), Shard(0))
    assert TPAR.data_sharding(None) == (Shard(0), Replicate())
    assert TPAR.replicated(None) == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# The world's cases
# ---------------------------------------------------------------------------

def test_world_meshes(world):
    """`make_mesh` in the four-rank world: all on `model` by default,
    2 x 2 and 4 x 1 as asked, row-major coordinates, and the JAX
    package's `ValueError` for 3 x ?."""
    for r in range(WORLD):
        m = _got(world, "meshes", r)
        assert m["default"] == ({"data": 1, "model": 4}, (0, r))
        assert m["n_data=2"] == ({"data": 2, "model": 2}, divmod(r, 2))
        assert m["n_model=1"] == ({"data": 4, "model": 1}, (r, 0))
        assert "mesh 3x1 != 4 devices" in m["n_data=3"]


def test_shard_grid_matches_jax(world):
    """The four ranks' `shard_grid` slices of 250 models, concatenated,
    equal the JAX package's `shard_grid` over 4 shards of the virtual
    mesh (padded to 252 with faint copies; labels repeated)."""
    import jax
    from brutus_tpu.parallel import make_mesh as j_make_mesh
    from brutus_tpu.parallel import shard_grid as j_shard_grid
    mc, _, _ = jax_test_grid()
    jm = j_make_mesh(n_data=1, n_model=4, devices=jax.devices()[:4])
    jdev, (jlab,), jn = j_shard_grid(jm, mc[:250], np.arange(250.0))
    parts = [_got(world, "shard_grid", r) for r in range(WORLD)]
    assert all(p[2] == jn == 250 for p in parts)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  np.asarray(jdev))
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                  np.asarray(jlab))


def test_select_blocks_sharded_matches_jax(world):
    """`_select_blocks_sharded` at 4 shards (B=8, 64 local blocks,
    nb=12) against the JAX package's under `shard_map` on 4 virtual
    devices: equal `bidx`, `idx` and, shard by shard, `mine`."""
    import jax
    import jax.numpy as jnp
    from brutus_tpu.ops.pallas_loglike import _select_blocks_sharded as jsel
    from brutus_tpu.parallel import make_mesh as j_make_mesh
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    import inspect
    kw = {("check_vma" if "check_vma" in inspect.signature(shard_map)
           .parameters else "check_rep"): False}
    jm = j_make_mesh(n_data=1, n_model=4, devices=jax.devices()[:4])

    def body(bs):
        b, i, m = jsel(bs, SEL["nb"], SEL["block"], "model", WORLD)
        return b[None], i[None], m[None]
    fn = shard_map(body, mesh=jm, in_specs=(P(None, "model"),),
                   out_specs=(P("model"),) * 3, **kw)
    jb, ji, jmine = (np.asarray(x) for x in fn(jnp.asarray(select_scores())))
    for r in range(WORLD):
        bidx, idx, mine = _got(world, "select_blocks", r)
        np.testing.assert_array_equal(bidx, jb[r])
        np.testing.assert_array_equal(idx, ji[r])
        np.testing.assert_array_equal(mine, jmine[r])


def _assert_close(out, ref):
    """The JAX package's limits for a mesh against one device (`tests/
    test_parallel.py`: log-evidence rtol 1e-6 / atol 1e-5, chi2min rtol
    1e-6), with every integer output equal and every other float output
    within rtol = atol = 1e-5 (`test_fit_rows_do_not_depend_on_batch_
    size`'s limit)."""
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["log_evidence"], ref["log_evidence"],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out["chi2min"], ref["chi2min"], rtol=1e-6)
    for k in ref:
        if ref[k].dtype.kind == "f":
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _fit_equal(world, name, **extra):
    """The mesh's results against the single-process run: equal bit for
    bit on a mesh whose `data` axis is 1; with a `data` axis over 1 each
    rank fits a share of each batch, and on the CPU the plain versions'
    float32 reductions round by an ulp differently for batches of other
    sizes (as `test_fit_rows_do_not_depend_on_batch_size` finds on one
    process), so those are held to `_assert_close`.  Every rank returns
    the same whole result."""
    out = _got(world, name)
    n_data = fit_case(name)[3][0]
    (_assert_equal if n_data == 1 else _assert_close)(
        out, _single(name, **extra))
    for r in range(1, WORLD):
        _assert_equal(_got(world, name, r), out)
    return out


def test_screened_engine_model_mesh(world, two_threads):
    """The funnel on a 2 x 2 mesh (JAX: `test_screened_engine_model_
    mesh`): each model shard screens half the grid, the shortlists
    merge, each data rank fits two stars; the outputs against the
    single-process funnel's as `_fit_equal` holds them, the same on
    every rank; drawn models lie in the grid."""
    out = _fit_equal(world, "funnel_model_mesh")
    assert ((out["model_idx"] >= 0) & (out["model_idx"] < 256)).all()


def test_screened_engine_data_mesh(world, two_threads):
    """The funnel on a 4 x 1 mesh, one star per rank (JAX: `test_
    screened_engine_data_mesh`), against the single-process run as
    `_fit_equal` holds it."""
    _fit_equal(world, "funnel_data_mesh")


def test_fused_engine_data_mesh(world, two_threads):
    """The dense fused engine (K1 dense) on a 4 x 1 mesh (JAX: `test_
    fused_engine_data_mesh`), against the single-process run as
    `_fit_equal` holds it."""
    _fit_equal(world, "dense_data_mesh")


def test_xla_funnel_model_mesh(world, two_threads):
    """The reference-semantics funnel on a 2 x 2 mesh at `tests/
    test_screen_xla.py::test_xla_funnel_model_mesh`'s settings and
    limits (log-evidence rtol 1e-6 / atol 1e-5, chi2min rtol 1e-6,
    model_idx agreement above 0.95, drawn models in the grid), and as
    `_fit_equal` holds the others.  A fifth star (model 995) puts the
    padding past model 999, held by shard 1 alone, into its shortlist:
    the faint copy every shard fits there is the last model's
    (`GridTables.last`), as in the single-process run."""
    out = _got(world, "xla_funnel_model_mesh")
    ref = _single("xla_funnel_model_mesh")
    np.testing.assert_allclose(out["log_evidence"], ref["log_evidence"],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out["chi2min"], ref["chi2min"], rtol=1e-6)
    assert (out["model_idx"] == ref["model_idx"]).mean() > 0.95
    assert ((out["model_idx"] >= 0) & (out["model_idx"] < 1000)).all()
    _fit_equal(world, "xla_funnel_model_mesh")
    short = _got(world, "xla_shortlists")
    assert (short["global_idx"] >= 1000).any(), "no padding shortlisted"


def test_xla_funnel_shortlists_match_jax_sharded(world):
    """The reference-semantics funnel's shortlists on the 2 x 2 mesh
    against the JAX package's `loglike_grid_screened_xla` in its
    `model_axis` mode under `shard_map` on a 2 x 2 virtual mesh, at
    `tests/test_torch_screen_xla.py`'s limits: the same shortlist set
    per star, and on its real models lnlike rtol 1e-4 / atol 0.1,
    chi2, scale, av, rv rtol = atol = 2e-3."""
    import inspect
    import jax
    import jax.numpy as jnp
    from brutus_tpu.config import FitConfig as JFitConfig
    from brutus_tpu.ops.screen_xla import (prepare_screen_xla,
                                           loglike_grid_screened_xla as jx)
    from brutus_tpu.parallel import make_mesh as j_make_mesh
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    kw = {("check_vma" if "check_vma" in inspect.signature(shard_map)
           .parameters else "check_rep"): False}
    mc, labels, flux, err, dist = xla_funnel_problem()
    M = len(mc)
    aux = dict(lnprior=np.zeros(M, np.float32),
               feh=np.asarray(labels["feh"], np.float32),
               loga=np.asarray(labels["loga"], np.float32))
    tabw, tabc, packed, names, n_real = prepare_screen_xla(
        mc, aux=aux, block=32, n_shards=2)
    jm = j_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    t = P(None, None, "model")
    d = P("data")
    flux6, err6 = np.vstack([flux, flux[-1:]]), np.vstack([err, err[-1:]])
    dist6 = np.append(dist, dist[-1])

    def body(tw, tc, pb, f, e, m, px, pe):
        res = jx(f, e, m, tw, tc, pb, n_real, parallax=px, parallax_err=pe,
                 cfg=JFitConfig(mag_direct_init=True), screen_k=256,
                 aux_names=names, model_axis="model", n_model_shards=2)
        return {k: res[k] for k in ("lnlike", "chi2", "scale", "av", "rv",
                                    "global_idx")}
    fn = shard_map(body, mesh=jm, in_specs=(t, t, P("model", None, None),
                                            d, d, d, d, d),
                   out_specs=d, **kw)
    jres = fn(tabw, tabc, packed, jnp.asarray(flux6), jnp.asarray(err6),
              jnp.ones(flux6.shape, bool),
              jnp.asarray((1.0 / dist6).astype(np.float32)),
              jnp.asarray((0.05 / dist6).astype(np.float32)))
    jres = {k: np.asarray(v)[:len(flux)] for k, v in jres.items()}
    res = _got(world, "xla_shortlists")
    for b in range(len(flux)):
        g, jg = res["global_idx"][b], jres["global_idx"][b]
        assert set(g) == set(jg)
        ot, oj = np.argsort(g), np.argsort(jg)
        real = np.sort(g) < M
        for k, tol in (("lnlike", dict(rtol=1e-4, atol=0.1)),
                       ("chi2", dict(rtol=2e-3, atol=2e-3)),
                       ("scale", dict(rtol=2e-3, atol=2e-3)),
                       ("av", dict(rtol=2e-3, atol=2e-3)),
                       ("rv", dict(rtol=2e-3, atol=2e-3))):
            np.testing.assert_allclose(res[k][b][ot][real],
                                       jres[k][b][oj][real], err_msg=k,
                                       **tol)


def test_model_only_mesh(world, two_threads):
    """`engine=None` with a dense grid (default `screen_k`) on a 1 x 4
    mesh resolves to the dense reference engine over the sharded grid
    (JAX: `test_model_only_mesh`, which holds finiteness): finite, and
    equal to the single-process `engine="xla"` run, whose grid is not
    padded (256 models split evenly)."""
    out = _got(world, "model_only_mesh")
    assert np.isfinite(out["log_evidence"]).all()
    _fit_equal(world, "model_only_mesh", engine="xla")


def test_sharded_ext_prior_with_padding(world, two_threads):
    """250 models on 1 x 4 with `lnprior_ext` (JAX: `test_sharded_ext_
    prior_with_padding`): `engine=None` resolves to the dense reference
    engine, the grid is padded to 252 (faint copies, grid prior -1e30),
    the external prior with zeros; every drawn model is real and the
    log-evidences are finite; equal to the single-process
    `engine="xla"` run on the unpadded grid."""
    out = _got(world, "ext_prior_padding")
    assert np.isfinite(out["log_evidence"]).all()
    assert (out["model_idx"] < 250).all()
    _fit_equal(world, "ext_prior_padding", engine="xla")


def test_screened_engine_model_mesh_wide_filters(world, two_threads):
    """F=49 on 2 x 2 (JAX: `test_screened_engine_model_mesh_wide_
    filters`), against the single-process funnel as `_fit_equal` holds
    it."""
    _fit_equal(world, "wide_filters")


def test_save_file_written_by_first_rank(world, two_threads, tmp_path):
    """`save_file` on a 2 x 2 mesh: the first rank alone writes it, and
    its datasets hold what the single-process run's file holds, integer
    datasets equal and float ones within `_assert_close`'s rtol = atol =
    1e-5 (the mesh's `data` axis is 2)."""
    from brutus_tpu_torch.io import load_results
    _fit_equal(world, "save_file")
    ref = tmp_path / "one.h5"
    _single("save_file", save_file=str(ref))
    got = load_results(str(world[0]["dir"] / "mesh.h5"))
    want = load_results(str(ref))
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_mesh_errors(world, name):
    """The errors of `brutus_tpu/fitting.py:763-775`, on every rank: the
    dense fused engine on a model mesh (`ValueError`, "...requires the
    funnel..."), `lnprior_ext` on a model-sharded funnel
    (`NotImplementedError`), a batch the data axis does not divide
    (`ValueError`)."""
    _, _, exc, match = ERRORS[name]
    for r in range(WORLD):
        got = _got(world, "errors", r)[name]
        assert got is not None, f"{name} did not raise"
        assert issubclass(got[0], exc) and match in got[1], got


def _two_process_main(rank, rdv, out_dir):
    """A rank of the two-process world of `test_multihost_two_process_
    psum`: `initialize` with a coordinator, a 1 x 2 mesh, then the sum
    of a model-sharded `arange(8)` over it."""
    from brutus_tpu_torch.parallel.mesh import all_reduce
    torch.set_num_threads(1)
    TPAR.initialize(coordinator_address=f"file://{rdv}", num_processes=2,
                    process_id=rank)
    mesh = TPAR.make_mesh(n_data=1, n_model=2)
    local, _, _ = TPAR.shard_grid(mesh, np.arange(8.0)[:, None, None])
    total = all_reduce(local.sum(), "sum", mesh.get_group("model"))
    with open(os.path.join(out_dir, f"psum{rank}.txt"), "w") as f:
        f.write(f"MHOK pid={rank} procs={mesh.size} "
                f"total={float(total):.1f}")


def test_multihost_two_process_psum(tmp_path):
    """Two processes join one world through `initialize(coordinator_
    address=..., num_processes=2, process_id=...)` and sum a
    model-sharded array over their 1 x 2 mesh (JAX: `test_multihost_
    two_process_psum`): 28.0 on both."""
    spawn_world(_two_process_main, 2, (str(tmp_path / "rdv"),
                                       str(tmp_path)), WORLD_TIMEOUT)
    for r in range(2):
        line = (tmp_path / f"psum{r}.txt").read_text()
        assert line == f"MHOK pid={r} procs=2 total=28.0", line
