"""CPU tests of the `setup_reuse_share` reader on records as
`brutus_tpu_torch.profiling.calls()` keeps them: the share of the traced
calls whose record says they reused the set-up, and nothing where no
record holds the counter.

    python -m pytest -q -p no:cacheprovider gpubench/tests
"""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gpubench")
sys.path.insert(0, ROOT)

from brutus_tpu_torch import profiling  # noqa: E402
from gpubench import cell  # noqa: E402

BASE = dict(h2d_bytes=5e5, k4_valid=900, k4_columns=1000)


def _read(monkeypatch, counters):
    """The reader on the records of len(counters) traced calls, after
    one older record that is not among them."""
    recs = [dict(t0=i, t1=i + 1, counters=dict(c), spans=[],
                 kernel_launches=[]) for i, c in enumerate(counters)]
    old = dict(t0=-1, t1=0, counters=dict(BASE, setup_reused=0), spans=[],
               kernel_launches=[])
    monkeypatch.setattr(profiling, "calls", lambda: [old] + recs)
    ctx = types.SimpleNamespace(calls=list(range(len(counters))))
    return cell.reader(HERE, "setup_reuse_share")(ctx)


@pytest.mark.parametrize("flags, share", [((1, 1, 1, 1), 1.0),
                                          ((0, 1, 1, 1), 0.75),
                                          ((0, 0), 0.0)])
def test_reads_the_share_of_reused_calls(monkeypatch, flags, share):
    got = _read(monkeypatch, [dict(BASE, setup_reused=f) for f in flags])
    assert got == pytest.approx(share, rel=1e-12)


def test_records_without_the_counter_read_nothing(monkeypatch):
    assert _read(monkeypatch, [BASE, BASE]) is None


def test_a_program_without_records_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "calls")
    ctx = types.SimpleNamespace(calls=[0, 1])
    assert cell.reader(HERE, "setup_reuse_share")(ctx) is None
