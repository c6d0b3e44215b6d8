"""The dense engine (`BruteForce.fit(screen_k=0)`) against the
benchmark's plain float64 reference (`gpubench/reference.py`), on the
CPU at a small size: the cell `dense.survey1k` built from its own files
(configuration, traffic mix, limits), its grid cut to 20,000 models and
its calls to 32 stars, judged by `gpubench/check.py` under the cell's
own limits; the reference in TF32 in the program's place, and a dense
step that hands on stale answers, fail them."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import cell, check  # noqa: E402

CELL = "dense.survey1k"
SHRINK = {"grid": {"n_model": 20000}, "fit": {"n_sel_max": 512},
          "traffic": {"call_stars": {"fixed": 32}, "pool_calls": 2},
          "settings": {"keep_rows_per_call": 8, "check_stars": 12,
                       "trace_calls": 1}}


def _judged(seed, prec="f64"):
    """Two calls of the shrunk cell on the CPU, the sampled stars'
    compared numbers (the program's, or the control's with `prec`
    "tf32"), and whether they pass the cell's limits."""
    c = cell.Cell(CELL, seed, "cpu", shrink=SHRINK)
    assert c.s["config"]["fit"]["screen_k"] == 0
    for i in range(2):
        c.call(i)
    st = c.s["settings"]
    recs = check.sample(c.kept, st["check_stars"], seed, 0, 1)
    values = check.numbers(recs, c.cats, c.mc, c.labels, c.dmap,
                           c.s["config"]["fit"], "cpu", seed, prec=prec)
    return check.judge(values, st["limits"])


@pytest.mark.parametrize("seed", [11, 2200000017, 3000000019])
def test_dense_engine_is_correct_against_the_reference(seed):
    correct, checks = _judged(seed)
    assert set(checks) >= {"cov_dev", "lnprob_z", "logwt_dev",
                           "fit_excess", "logz_p90"}
    assert correct, checks


def test_the_tf32_control_is_not_correct():
    """The reference in TF32 put in the program's place fails the
    cell's limits."""
    correct, checks = _judged(11, "tf32")
    assert not correct, checks


def test_a_stale_dense_step_is_not_correct(monkeypatch):
    """Each dense batch hands on the answers of the previous batch of
    its size: `correct` comes out false."""
    from brutus_tpu_torch import fitting
    orig, last = fitting._dense_step, {}

    def stale(*a, **k):
        out = orig(*a, **k)
        key = out["av"].shape
        prev, last[key] = last.get(key), out
        return out if prev is None else prev
    monkeypatch.setattr(fitting, "_dense_step", stale)
    correct, checks = _judged(13)
    assert not correct, checks
