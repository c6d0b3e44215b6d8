"""The port's funnel likelihood (`brutus_tpu_torch.ops.funnel`: K2 screen,
K3 slab gather, K1 shortlist fit) against `brutus_tpu`'s
`loglike_grid_screened`, run in Pallas interpret mode as the JAX
package's own tests run it.

Inputs come from a numpy seed; the JAX side gets explicit float32
arrays (conftest turns x64 on).  The CUDA kernels against these plain
versions: `tests/test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from brutus_tpu.config import FitConfig
from brutus_tpu.ops import pallas_loglike as PL
from brutus_tpu_torch.config import FitConfig as TFitConfig
from brutus_tpu_torch.convert import from_numpy_grid
from brutus_tpu_torch.ops import funnel as TF

TILE = 512


def _problem(M, F, B, seed, masked=False):
    rng = np.random.default_rng(seed)
    mc = np.stack([rng.uniform(8.0, 16.0, (M, F)),
                   rng.uniform(0.4, 1.1, (M, F)),
                   rng.uniform(0.05, 0.2, (M, F))], -1).astype(np.float32)
    idx = rng.integers(0, M, B)
    av = rng.uniform(0.1, 1.2, B)
    rv = rng.uniform(2.8, 3.8, B)
    dist = rng.uniform(0.5, 2.0, B)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * err
    mask = np.ones((B, F), bool)
    if masked:
        mask[0, F // 2:] = False
        mask[1, 3] = False
    plx = (1.0 / dist).astype(np.float32)
    plxe = (0.05 / dist).astype(np.float32)
    plx[-1] = np.nan                          # one star without parallax
    plxe[-1] = np.nan
    lab = np.zeros(M, [("feh", float), ("loga", float)])
    lab["feh"] = rng.uniform(-2.0, 0.3, M)
    lab["loga"] = rng.uniform(8.0, 10.1, M)
    lnprior = rng.uniform(-1.0, 0.0, M).astype(np.float32)
    return dict(mc=mc, flux=flux.astype(np.float32),
                err=err.astype(np.float32), mask=mask, plx=plx, plxe=plxe,
                lab=lab, lnprior=lnprior, idx=idx)


CASES = {
    # F=8 as on the main path, one star with half its bands masked.
    "f8": dict(M=2048, F=8, B=5, seed=11, masked=True, sblock=64, k=512),
    # F=49, the full filter set: the port uses the stacked pack here too.
    "f49": dict(M=1024, F=49, B=4, seed=211, masked=True, sblock=64,
                k=256),
}


def _run_jax(p, case):
    aux = dict(lnprior=p["lnprior"],
               feh=p["lab"]["feh"].astype(np.float32),
               loga=p["lab"]["loga"].astype(np.float32))
    st, packed, names, n_real, maskrow = PL.prepare_screen(
        p["mc"], aux=aux, tile=TILE, screen_block=case["sblock"])
    args = (jnp.asarray(p["flux"]), jnp.asarray(p["err"]),
            jnp.asarray(p["mask"]), st, packed, maskrow, n_real)
    kw = dict(parallax=jnp.asarray(p["plx"]),
              parallax_err=jnp.asarray(p["plxe"]), cfg=FitConfig(),
              tile=TILE, screen_k=case["k"], screen_block=case["sblock"],
              aux_names=names, interpret=True)
    B = p["flux"].shape[0]
    bscore = np.asarray(PL.loglike_grid_screened(*args, stop_after="screen",
                                                 **kw))[:B]
    coef, aux_g, idx = PL.loglike_grid_screened(*args, stop_after="gather",
                                                **kw)
    res = PL.loglike_grid_screened(*args, **kw)
    if "pack_rows" in res:
        pack = np.asarray(res["pack_rows"])[:B, :12 + len(names)]
    else:      # F=49: the TPU switches its stacked pack off (:1288,1320)
        rows = [res[k] for k in ("lnlike", "chi2", "scale", "av", "rv")]
        rows += list(res["icov_parts"]) + [res["aux"][n] for n in names]
        rows.append(res["global_idx"].astype(jnp.float32))
        pack = np.stack([np.asarray(r) for r in rows], 1)
    return dict(bscore=bscore, coef=np.asarray(coef)[:, :B],
                aux=np.asarray(aux_g)[:, :B], idx=np.asarray(idx)[:B],
                pack=pack, names=PL.pack_row_names(names))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = CASES[request.param]
    p = _problem(c["M"], c["F"], c["B"], c["seed"], c["masked"])
    tabs = from_numpy_grid(p["mc"], p["lab"], device="cpu",
                           lnprior=p["lnprior"], tile=TILE)
    return c, p, tabs, _run_jax(p, c)


def _star_inputs(p, device="cpu"):
    t = lambda x: torch.as_tensor(x, device=device)
    cfg = TFitConfig()
    fp, wf, mg, wm, mk, nd, tv = TF.prepare_star_data(
        t(p["flux"]), t(p["err"]), t(p["mask"]), cfg)
    plx, plxw = TF._screen_parallax(t(p["plx"]), t(p["plxe"]))
    star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
    star4 = torch.stack([fp, wf, mg, wm], 1).contiguous()
    return star2, srow5, star4


def test_screen_block_scores_match(case):
    """K2 block maxima.  Tolerance 1.0 on -chi2/2: the score cancels
    sums of size ~SNR^2 x mag^2 x F (~1e6 at SNR 60) down to chi2 ~ 10,
    so float32 rounding in another summation order moves it by ~0.3
    (the TPU's split-bf16 sums differ from plain f32 FMAs in their last
    bits).  Block sets agree up to blocks within that tolerance of the
    selection boundary."""
    c, p, tabs, ref = case
    star2, srow5, _ = _star_inputs(p)
    bs = TF.screen_blocks(tabs.table, tabs.maskrow, star2, srow5,
                          c["F"], c["sblock"], TFitConfig()).numpy()
    assert bs.shape == ref["bscore"].shape
    real = ref["bscore"] > -1e29
    np.testing.assert_array_equal(bs > -1e29, real)
    np.testing.assert_allclose(bs[real], ref["bscore"][real], atol=1.0)
    nb = c["k"] // c["sblock"]
    for b in range(bs.shape[0]):
        top_t = set(np.argsort(-bs[b], kind="stable")[:nb])
        top_j = set(np.argsort(-ref["bscore"][b], kind="stable")[:nb])
        edge = np.sort(ref["bscore"][b])[::-1][nb - 1]
        for blk in top_t ^ top_j:
            assert abs(ref["bscore"][b, blk] - edge) < 1.0, (b, blk)


def test_gather_is_exact(case):
    """K3 on the JAX package's own block choice: bit-identical slabs."""
    c, p, tabs, ref = case
    block = c["sblock"]
    bidx = torch.as_tensor(ref["idx"][:, ::block] // block,
                           dtype=torch.int32)
    out = TF.gather_slabs(tabs.table, bidx, block).numpy()
    n_coef = 3 * c["F"]
    np.testing.assert_array_equal(out[:n_coef], ref["coef"])
    np.testing.assert_array_equal(out[n_coef:], ref["aux"][:3])


def _assert_pack_close(pack, ref):
    """Stacked packs agree: lnlike within 0.02 nats (plus 1e-5
    relative) on every model within 20 nats of its star's best (the
    posterior culls at ln(1e-3) = -6.9; on the star with 4 of 8 bands
    the fixed iteration budget stops short of convergence and float32
    rounding order moves the stopping point by up to ~0.01 nats, far
    below the MC noise of the evidence); every fit field within 1e-3
    relative
    (floored at 1e-3 of the field's scale) for all but 0.5% of models,
    because the fixed-budget iterations branch on float comparisons
    (freeze, step damping) that a last-bit difference can flip for a
    poorly fitting model.  Aux rows and grid indices are copied: exact."""
    names = TF.pack_row_names(("lnprior", "feh", "loga"))
    for i, n in enumerate(names):
        a, b = pack[:, i], ref[:, i]
        if n in ("lnprior", "feh", "loga", "gidx"):
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        ok = b > -1e29 if n == "lnlike" else np.isfinite(b)
        floor = 1e-3 * np.abs(b[ok]).max()
        rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), floor)
        assert (rel > 1e-3).mean() < 5e-3, (n, (rel > 1e-3).mean())
    lnl, lnl_ref = pack[:, 0], ref[:, 0]
    near = lnl_ref > lnl_ref.max(1, keepdims=True) - 20.0
    np.testing.assert_allclose(lnl[near], lnl_ref[near], rtol=1e-5,
                               atol=0.02)
    np.testing.assert_array_equal(lnl.argmax(1), lnl_ref.argmax(1))


def test_fit_pack_matches(case):
    """K1 on the JAX package's gathered slabs (see `_assert_pack_close`
    for the tolerances)."""
    c, p, tabs, ref = case
    _, _, star4 = _star_inputs(p)
    coef = torch.as_tensor(np.concatenate([ref["coef"], ref["aux"][:3]]))
    idx = torch.as_tensor(np.array(ref["idx"]), dtype=torch.int32)
    ndim = p["mask"].sum(1).astype(np.float32)
    tv = p["err"].astype(np.float32) ** 2
    half = (ndim - 3.0) / 2.0
    from scipy.special import gammaln
    srow = np.stack([-0.5 * (ndim * np.log(2 * np.pi)
                             + (np.log(tv) * p["mask"]).sum(1)),
                     -(half * np.log(2.0) + gammaln(half)), half - 1.0], 1)
    n_real = tabs.n_real if tabs.n_real < tabs.table.shape[1] else -1
    P = ref["idx"].shape[1]
    tile = TILE
    while P % tile:
        tile //= 2
    pack = TF.fit_pack(star4, coef, idx, torch.as_tensor(
        srow, dtype=torch.float32), 3, 15, n_real, tile,
        TFitConfig()).numpy()
    assert tuple(ref["names"]) == TF.pack_row_names(
        ("lnprior", "feh", "loga"))
    _assert_pack_close(pack, ref["pack"])


def test_funnel_end_to_end_matches(case):
    """The whole funnel: same shortlist (grid indices in the same
    order) and the same pack, to the K1 tolerances above."""
    c, p, tabs, ref = case
    t = torch.as_tensor
    out = TF.loglike_grid_screened(
        t(p["flux"]), t(p["err"]), t(p["mask"]), tabs.table, tabs.maskrow,
        tabs.n_real, tabs.aux_names, parallax=t(p["plx"]),
        parallax_err=t(p["plxe"]), cfg=TFitConfig(), tile=TILE,
        screen_k=c["k"], screen_block=c["sblock"])
    pack = out["pack"].numpy()
    np.testing.assert_array_equal(pack[:, -1], ref["pack"][:, -1])
    np.testing.assert_array_equal(out["ndim"].numpy(), p["mask"].sum(1))
    _assert_pack_close(pack, ref["pack"])
    if c["F"] == 8:
        # the injected model wins for every fully observed star
        best = pack[:, 0].argmax(1)
        rows = np.arange(len(best))
        np.testing.assert_array_equal(pack[rows, -1, best][2:],
                                      p["idx"][2:])


def test_padding_mask_is_exact_past_2_24():
    """K1's padding mask compares grid indices as integers.  Past 2**24
    float32 holds only even integers: on a grid of 2**24 + 4097 real
    models (not a multiple of any tile), the last real model's index
    2**24 + 4096 equals `n_real` once both are rounded, so a comparison
    of floats would kill it.  Each star sits at the last real index:
    its own model must stay finite and win, every model past it is
    masked, and the pack equals the same fit with every index shifted
    below 2**24 (bit for bit, the grid-index row aside)."""
    P, F, B = 64, 8, 3
    p = _problem(P, F, B, seed=5)
    n_real = 2 ** 24 + 4097
    _, _, star4 = _star_inputs(p)
    cfg = TFitConfig()
    mk = torch.as_tensor(p["mask"])
    srow = TF.post_consts(mk, mk.sum(1).to(torch.float32),
                          torch.as_tensor(p["err"]) ** 2)
    coef = torch.as_tensor(p["mc"].transpose(2, 1, 0).reshape(3 * F, P))
    coef = coef[:, None, :].expand(3 * F, B, P).contiguous()
    pos = torch.arange(P, dtype=torch.int64)
    own = torch.as_tensor(p["idx"])[:, None]
    gidx = (n_real - 1 - own + pos).to(torch.int32)
    pack = TF.fit_pack(star4, coef, gidx, srow, 0, 12, n_real, 64, cfg)
    low = TF.fit_pack(star4, coef, gidx - 2 ** 24, srow, 0, 12,
                      n_real - 2 ** 24, 64, cfg)
    assert torch.equal(pack[:, :11], low[:, :11])
    lnl = pack[:, 0]
    win = lnl.argmax(1)
    assert torch.equal(win, own[:, 0])
    assert torch.isfinite(lnl.gather(1, own)).all()
    past = pos[None] > own
    assert past.any() and (lnl[past] < -1e29).all()
    assert (lnl[~past] > -1e29).all()
