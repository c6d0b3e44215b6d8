"""CPU tests of the readers of the program's spans and counters
(`spans.py` and the metrics that use it) on a hand-made Chrome trace of
two calls, with its records as `brutus_tpu_torch.profiling.calls()`
keeps them; and that the readers that were there read the same with the
program's `bf.*` events in the trace and without them.

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

from brutus_tpu_torch import profiling  # noqa: E402
from gpubench import cell, spans, tracing  # noqa: E402

STARS = 16          # per call
SHIFT = 11000.0     # the second call, us after the first
OFF_US = 5000.0     # the records' clock (ns / 1e3) less the trace's
# one call: (name, start, end) in us on the trace's clock
CALL = [("bf.fit", 1010, 10990), ("bf.setup", 1020, 1500),
        ("bf.grid_prior", 1100, 1400), ("bf.dust", 1500, 1700),
        ("bf.tables", 1700, 2700), ("bf.launch", 3000, 6000),
        ("bf.upload", 3000, 3100), ("bf.screen", 3100, 3500),
        ("bf.gather", 3500, 3700), ("bf.fit_models", 3700, 4000),
        ("bf.noise", 4000, 4500), ("bf.select", 4500, 5000),
        ("bf.mc", 5000, 5500), ("bf.draws", 5500, 5800),
        ("bf.pack", 5800, 5900), ("bf.copy", 5900, 6000),
        ("bf.wait", 6000, 7000), ("bf.unpack", 7000, 7200)]
# kernels: (name, correlation, launch, device start, device end)
KERNELS = [("void screen_kernel<8>", 1, 3400, 3450, 3950),
           ("gather_kernel(float const*)", 2, 3600, 3950, 4050),
           ("void fit_kernel<8>", 3, 3800, 4050, 4350),
           ("vectorized_elementwise_kernel<AU>", 4, 4100, 4350, 4400),
           ("vectorized_elementwise_kernel<BU>", 5, 4200, 4400, 4480),
           ("reduce_kernel<512>", 6, 4600, 4600, 4700),
           ("void mc_kernel<true>", 7, 5100, 5100, 5300),
           ("gather_elementwise_kernel", 8, 5600, 5600, 5650)]
COPIES = [("Memcpy HtoD (Pageable -> Device)", 1800, 2600),
          ("Memcpy DtoH (Device -> Pinned)", 5950, 6050)]
MEMSETS = [("Memset (Device)", 4700, 4710)]
HOST = [("aten::mul", 4080, 4110), ("aten::bitwise_and", 4150, 4250),
        ("aten::topk", 4520, 4990)]
COUNTERS = [dict(h2d_bytes=84e6, k4_valid=900, k4_columns=1000),
            dict(h2d_bytes=86e6, k4_valid=700, k4_columns=1000)]
EXPECTED = {
    "grid_prior_ms": 0.4,           # median of 0.3 and 0.5
    "tables_ms": 1.0,
    "dust_ms": 0.2,
    "upload_mb_per_call": 85.0,
    "wait_ms_per_kstar": 2.0 / 0.032,
    # gaps inside bf.launch: 450 + 120 + 390 + 300 + 300 us a call,
    # over the 21,000-us window
    "step_idle_share": 2 * 1560 / 21000,
    "noise_ms_per_kstar": 0.26 / 0.032,
    "select_ms_per_kstar": 0.2 / 0.032,
    "k4_valid_share": 0.8,
}


def _call_spans(i):
    out = [(n, a + i * SHIFT, b + i * SHIFT) for n, a, b in CALL]
    if i == 1:      # the second call's grid prior takes 0.5 ms
        out = [(n, a, b + 200 if n == "bf.grid_prior" else b)
               for n, a, b in out]
    return out


def _events(with_program):
    ev = []
    x = lambda cat, name, a, b, **args: ev.append(dict(
        ph="X", cat=cat, name=name, ts=a, dur=b - a, args=args))
    for i in range(2):
        s = i * SHIFT
        x("user_annotation", tracing.SPAN, 1000 + s, 11000 + s)
        if with_program:
            for n, a, b in _call_spans(i):
                x("user_annotation", n, a, b)
        for name, corr, launch, d0, d1 in KERNELS:
            c = corr + 100 * i
            x("cuda_runtime", "cudaLaunchKernel", launch + s, launch + s + 5,
              correlation=c)
            x("kernel", name, d0 + s, d1 + s, correlation=c)
        for name, a, b in COPIES:
            x("gpu_memcpy", name, a + s, b + s)
        for name, a, b in MEMSETS:
            x("gpu_memset", name, a + s, b + s)
        for name, a, b in HOST:
            x("cpu_op", name, a + s, b + s)
    return ev


def _records():
    ns = lambda t: int(round((t + OFF_US) * 1e3))
    recs = []
    for i in range(2):
        sp = _call_spans(i)
        fit = sp[0]
        recs.append(dict(
            t0=ns(fit[1]), t1=ns(fit[2]), counters=dict(COUNTERS[i]),
            spans=[(n, ns(a), ns(b)) for n, a, b in sp[1:]],
            kernel_launches=[(k[0], ns(k[2] + i * SHIFT)) for k in KERNELS
                             if any(h in k[0] for h in tracing.HAND_WRITTEN)]))
    return recs


def _cell():
    fit = dict(screen_k=512, screen_block=64, batch_size=8)
    cat = dict(flux=np.zeros((STARS, 8)), mask=np.ones((STARS, 8), bool))
    return types.SimpleNamespace(s=dict(config=dict(fit=fit)),
                                 mc=np.zeros((2048, 8, 3)), cats=[cat])


def _context(tmp_path, with_program=True):
    path = tmp_path / f"trace_{with_program}.json"
    path.write_text(json.dumps(dict(traceEvents=_events(with_program))))
    tr = tracing.Trace(str(path))
    return tr, tr.context(_cell(), [0, 1])


@pytest.fixture
def records(monkeypatch):
    recs = _records()
    monkeypatch.setattr(profiling, "calls", lambda: [dict(t0=0)] + recs)
    return recs


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_new_reader_reads_the_hand_made_trace(tmp_path, records, name):
    _, ctx = _context(tmp_path)
    v = cell.reader(HERE, name)(ctx)
    assert v == pytest.approx(EXPECTED[name], rel=1e-9), name


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_new_reader_without_records_reads_nothing(tmp_path, monkeypatch,
                                                  name):
    """Where the program keeps no records (a program without
    `profiling.calls`), the reader reports nothing and does not raise."""
    monkeypatch.delattr(profiling, "calls")
    _, ctx = _context(tmp_path)
    assert cell.reader(HERE, name)(ctx) is None


def _old_readers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    return [n for n in names if n not in EXPECTED]


@pytest.mark.parametrize("name", _old_readers() + ["breakdown"])
def test_old_readers_ignore_the_program_spans(tmp_path, records, name):
    """The readers that were there, and the breakdown, read the same on
    the trace with the program's `bf.*` events and without them."""
    got = []
    for with_program in (True, False):
        tr, ctx = _context(tmp_path, with_program)
        got.append(tr.breakdown(ctx) if name == "breakdown"
                   else cell.reader(HERE, name)(ctx))
    assert got[0] is not None
    assert got[0] == got[1]


def test_records_are_placed_on_the_trace_clock(tmp_path, records):
    """The records' spans land where the trace's own `bf.*` events are,
    and the kernels launched in each stage are found by its span."""
    _, ctx = _context(tmp_path)
    placed = spans.program_spans(ctx)
    assert spans.offset_us(ctx, records) == -OFF_US
    want = sorted((_call_spans(0) + _call_spans(1)),
                  key=lambda s: (s[1], -s[2]))
    assert [(n, pytest.approx(a), pytest.approx(b))
            for n, a, b in want] == placed
    stage = {"bf.screen": "screen_kernel", "bf.gather": "gather_kernel",
             "bf.fit_models": "fit_kernel", "bf.mc": "mc_kernel"}
    for span, kernel in stage.items():
        found = spans.launched_in(ctx, placed, span)
        assert [k[0] for k in found] == [k[0] for k in ctx.kernels
                                         if kernel in k[0]]


def test_records_that_cannot_be_paired_place_nothing(tmp_path, records,
                                                     capsys):
    records[1]["kernel_launches"].pop()
    _, ctx = _context(tmp_path)
    assert spans.program_spans(ctx) is None
    assert "traced call 1 has" in capsys.readouterr().err


def test_overlap_of_two_interval_lists():
    assert spans.overlap_us([(0, 10), (20, 30), (40, 50)],
                            [(5, 25), (45, 60)]) == 5 + 5 + 5
