"""CPU tests of the dense engine's readers (`metrics/dense_*.py`,
`metrics/fit_dense_roofline.py`) on a hand-made Chrome trace of two
dense calls, two batches each, with their records as
`brutus_tpu_torch.profiling.calls()` keeps them; each reads nothing on a
funnel context, nothing without records, and the stage readers nothing
on a program that marks no dense stages; the roofline's count against
`chip_smoke.fit_dense_bound`.

    python -m pytest -q -p no:cacheprovider gpubench/tests
"""

import json
import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gpubench")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from brutus_tpu_torch import profiling  # noqa: E402
from gpubench import cell, counts, tracing  # noqa: E402

STARS, BATCH, F, N_MODEL = 16, 8, 8, 2000
MP = 2048                   # N_MODEL padded to the 512-model tile
CALL_US = 11000.0           # the second call, us after the first
BATCH_US = 2500.0           # the second batch, us after the first
OFF_US = 5000.0             # the records' clock (ns / 1e3) less the trace's
CALL = [("bf.fit", 1010, 10990), ("bf.setup", 1020, 1500),
        ("bf.dust", 1500, 1700), ("bf.tables", 1700, 1800),
        ("bf.wait", 7000, 7500), ("bf.unpack", 7500, 7700)]
# one batch: (name, start, end) in us on the trace's clock
BATCH_SPANS = [("bf.launch", 2000, 4400), ("bf.upload", 2000, 2050),
               ("bf.likelihood", 2050, 2400), ("bf.noise", 2400, 2700),
               ("bf.posterior", 2700, 4200), ("bf.select", 2700, 3300),
               ("bf.mc", 3300, 3900), ("bf.draws", 3900, 4200),
               ("bf.pack", 4200, 4300), ("bf.copy", 4300, 4400)]
STAGES = ("bf.noise", "bf.select", "bf.mc", "bf.draws")
# kernels of one batch: (name, correlation, launch, device start, end)
KERNELS = [("void fit_kernel<8>", 1, 2100, 2110, 2410),
           ("vectorized_elementwise_kernel<Philox>", 2, 2450, 2460, 2500),
           ("vectorized_elementwise_kernel<BoxMuller>", 3, 2600, 2610, 2640),
           ("reduce_kernel<amax>", 4, 2800, 2810, 2910),
           ("topk_kernel", 5, 3100, 3110, 3160),
           ("vectorized_elementwise_kernel<prior>", 6, 3400, 3410, 3470),
           ("reduce_kernel<logsumexp>", 7, 3800, 3810, 3830),
           ("gather_elementwise_kernel", 8, 4000, 4010, 4025),
           ("CatArrayBatchedCopy", 9, 4250, 4260, 4270)]
COPIES = [("Memcpy DtoH (Device -> Pinned)", 4350, 4450)]
N_LAUNCHES = 4              # 2 calls x 2 batches
KSTARS = 2 * STARS / 1e3
EXPECTED = {
    "dense_fit_ms_per_kstar": N_LAUNCHES * 0.300 / KSTARS,
    # select: 100 + 50 us a batch
    "dense_select_ms_per_kstar": N_LAUNCHES * 0.150 / KSTARS,
    # noise 40 + 30, mc 60 + 20, draws 15 us a batch
    "dense_mc_ms_per_kstar": N_LAUNCHES * 0.165 / KSTARS,
    # 2 in bf.noise, 5 in bf.posterior a batch
    "dense_posterior_launches_per_star": N_LAUNCHES * 7 / (2 * STARS),
}
READERS = sorted(EXPECTED) + ["fit_dense_roofline"]


def _batches(i):
    """Call `i`'s batch spans and kernels, shifted to their places."""
    spans, kernels = [], []
    for j in range(STARS // BATCH):
        s = i * CALL_US + j * BATCH_US
        spans += [(n, a + s, b + s) for n, a, b in BATCH_SPANS]
        kernels += [(n, c + 100 * (2 * i + j), t + s, a + s, b + s)
                    for n, c, t, a, b in KERNELS]
    return spans, kernels


def _call_spans(i, stages=True):
    spans = [(n, a + i * CALL_US, b + i * CALL_US) for n, a, b in CALL]
    spans += [s for s in _batches(i)[0] if stages or s[0] not in STAGES]
    return spans


def _events():
    ev = []
    x = lambda cat, name, a, b, **args: ev.append(dict(
        ph="X", cat=cat, name=name, ts=a, dur=b - a, args=args))
    for i in range(2):
        x("user_annotation", tracing.SPAN, 1000 + i * CALL_US,
          11000 + i * CALL_US)
        for name, corr, launch, d0, d1 in _batches(i)[1]:
            x("cuda_runtime", "cudaLaunchKernel", launch, launch + 5,
              correlation=corr)
            x("kernel", name, d0, d1, correlation=corr)
        for name, a, b in COPIES:
            for j in range(STARS // BATCH):
                s = i * CALL_US + j * BATCH_US
                x("gpu_memcpy", name, a + s, b + s)
    return ev


def _records(stages=True):
    ns = lambda t: int(round((t + OFF_US) * 1e3))
    recs = []
    for i in range(2):
        sp = _call_spans(i, stages)
        recs.append(dict(
            t0=ns(sp[0][1]), t1=ns(sp[0][2]), counters={},
            spans=[(n, ns(a), ns(b)) for n, a, b in sp[1:]],
            kernel_launches=[(k[0], ns(k[2])) for k in _batches(i)[1]
                             if any(h in k[0] for h in tracing.HAND_WRITTEN)]))
    return recs


def _context(tmp_path, mask, screen_k=0):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=_events())))
    fit = dict(screen_k=screen_k, screen_block=64, batch_size=BATCH)
    cat = dict(flux=np.zeros((STARS, F)), mask=mask)
    c = types.SimpleNamespace(s=dict(config=dict(fit=fit)),
                              mc=np.zeros((N_MODEL, F, 3)), cats=[cat])
    return tracing.Trace(str(path)).context(c, [0, 1])


def _every_band():
    return np.ones((STARS, F), bool)


def _some_bands():
    """A quarter of the stars without the last three bands."""
    mask = _every_band()
    mask[::4, 5:] = False
    return mask


def _keep_records(monkeypatch, stages=True):
    monkeypatch.setattr(profiling, "calls",
                        lambda: [dict(t0=0)] + _records(stages))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_hand_made_trace(tmp_path, monkeypatch, name):
    _keep_records(monkeypatch)
    ctx = _context(tmp_path, _some_bands())
    assert cell.reader(HERE, name)(ctx) == pytest.approx(EXPECTED[name],
                                                         rel=1e-9)


def test_roofline_counts_chip_smoke_dense_bound_on_every_band(
        tmp_path, monkeypatch):
    """With every band usable, each launch's least time is
    `chip_smoke.fit_dense_bound(8, Mp, F, moving=0)` (ms), and the share
    is their sum over the fit kernels' device time."""
    _keep_records(monkeypatch)
    ctx = _context(tmp_path, _every_band())
    least_ms, by = chip_smoke.fit_dense_bound(BATCH, MP, F, 0)
    assert by == "operations"
    want = 100.0 * N_LAUNCHES * least_ms * 1e-3 / (N_LAUNCHES * 300e-6)
    got = cell.reader(HERE, "fit_dense_roofline")(ctx)
    assert got == pytest.approx(want, rel=1e-12)


def test_roofline_counts_each_stars_own_bands(tmp_path, monkeypatch):
    """A star without three bands takes the pair work of five: the
    share falls by those pairs' operations, the per-model term and the
    table's bytes staying as they are."""
    _keep_records(monkeypatch)
    full = cell.reader(HERE, "fit_dense_roofline")(
        _context(tmp_path, _every_band()))
    some = cell.reader(HERE, "fit_dense_roofline")(
        _context(tmp_path, _some_bands()))
    fewer = STARS // 4 * 2 * MP * (counts.fit_ops(F)[0]
                                  - counts.fit_ops(5)[0])
    drop = 100.0 * fewer / counts.F32_OPS_PER_S / (N_LAUNCHES * 300e-6)
    assert full - some == pytest.approx(drop, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_on_a_funnel_context(tmp_path, monkeypatch,
                                                  name):
    _keep_records(monkeypatch)
    ctx = _context(tmp_path, _some_bands(), screen_k=512)
    assert ctx.engine == "funnel"
    assert cell.reader(HERE, name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_records_reads_nothing(tmp_path, monkeypatch, name):
    """Where the program keeps no records (a program without
    `profiling.calls`), the reader reports nothing and does not raise."""
    monkeypatch.delattr(profiling, "calls")
    assert cell.reader(HERE, name)(_context(tmp_path, _some_bands())) \
        is None


@pytest.mark.parametrize("name", READERS)
def test_stage_readers_need_the_dense_stage_spans(tmp_path, monkeypatch,
                                                  name):
    """On a program whose dense step marks only `bf.likelihood` and
    `bf.posterior`, the stage readers report nothing; the fit kernel's
    two still read."""
    _keep_records(monkeypatch, stages=False)
    got = cell.reader(HERE, name)(_context(tmp_path, _some_bands()))
    if name in ("dense_fit_ms_per_kstar", "fit_dense_roofline"):
        assert got is not None
    else:
        assert got is None
