"""
Tracing and throughput instrumentation (mirrors `brutus_tpu/profiling.py`).

  * `trace(...)` — context manager around `torch.profiler` writing a
    Chrome trace of the host and the card (TensorBoard's PyTorch
    profiler plugin and Perfetto read it), as `jax.profiler` writes an
    XPlane trace;
  * `annotate(...)` — a named region in that trace
    (`torch.profiler.record_function`, as `jax.profiler.TraceAnnotation`);
  * `Throughput` — a running rate + ETA meter on the host clock;
  * `span(...)`, `call(...)`, `count(...)` and `calls()` — the spans and
    counters inside `BruteForce.fit` (the `bf.*` names, README), which
    record only while a `torch.profiler` session records (`trace`, or
    any other).  A span is then a `record_function` region on the
    profiler's timeline, the one that holds the card's kernels, and is
    also kept, with the counts, in the open call's record, beside the
    time of each hand-written kernel's launch, which places the record
    on that timeline.  Otherwise a span is one shared null context and
    a count does nothing.
"""

import collections
import contextlib
import functools
import os
import sys
import time

import torch

_NULL = contextlib.nullcontext()
# The records of the last calls made while a profiler recorded, and
# the calls open now (innermost last).
_CALLS = collections.deque(maxlen=256)
_OPEN = []
_autograd_profiler = torch.autograd.profiler


@contextlib.contextmanager
def trace(logdir, with_host=True):
    """Capture a trace of the enclosed block into `logdir` (mirrors
    `profiling.trace`): the host's activity always, as
    `jax.profiler.start_trace` records it whatever `with_host` says, and
    the card's kernels and copies where PyTorch sees a card.  The trace
    is one `<host>_<pid>.<ms>.pt.trace.json` file in `logdir`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    handler = torch.profiler.tensorboard_trace_handler(str(logdir))
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield


def annotate(name):
    """Named region that shows up inside profiler traces (mirrors
    `profiling.annotate`)."""
    return torch.profiler.record_function(name)


def recording():
    """Whether a `torch.profiler` session records in this process (the
    flag `torch.profiler` keeps for fast checks from Python)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """A `record_function` region that also keeps `(name, start, end)`
    (`time.time_ns()`, read around the region, so that the kept span
    holds the traced one) in the open call's record."""

    def __init__(self, name):
        self.name = name
        self.region = torch.profiler.record_function(name)

    def __enter__(self):
        self.t0 = time.time_ns()
        self.region.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.region.__exit__(*exc)
        if _OPEN:
            _OPEN[-1]["spans"].append((self.name, self.t0, time.time_ns()))
        return out


def span(name):
    """A `name` span while a profiler records; otherwise one shared null
    context, so a span costs a flag check and allocates nothing.  Spans
    nest as `with` blocks do: a span's parent is the innermost span open
    on its thread, and its call the `call` span around it."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


class _Call(_Span):
    """One call's span and record: `t0`, `t1` (`time.time_ns()`),
    `counters`, `spans` (the spans inside it, in the order they end)
    and `kernel_launches` (`(kernel, time.time_ns())` just before each
    hand-written kernel's launch).  Counts given as device scalars are
    summed and read once, when the call ends."""

    def __enter__(self):
        super().__enter__()
        self.record = dict(t0=self.t0, t1=None, counters={}, spans=[],
                           kernel_launches=[], on_device={})
        _OPEN.append(self.record)
        return self.record

    def __exit__(self, *exc):
        _OPEN.pop()             # calls nest: this one is the innermost
        c = self.record["counters"]
        for k, v in self.record.pop("on_device").items():
            c[k] = c.get(k, 0) + torch.stack(v).sum(dtype=torch.int64).item()
        out = self.region.__exit__(*exc)
        self.record["t1"] = time.time_ns()
        _CALLS.append(self.record)
        return out


def call(name):
    """A `name` span that is one call: while a profiler records, the
    spans and counts inside it go to its record, kept in `calls()` when
    it ends; otherwise the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return _Call(name)
    return _NULL


def traced_call(name):
    """Decorator: every call of the function runs inside `call(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with call(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name, n):
    """Add `n` to counter `name` of the open call, while a profiler
    records; otherwise nothing.  `n` is a number, or a device scalar
    that holds a whole number: those stay on the device until the call
    ends, so that counting never waits for the card."""
    if _OPEN and _autograd_profiler._is_profiler_enabled:
        rec = _OPEN[-1]
        if isinstance(n, torch.Tensor):
            rec["on_device"].setdefault(name, []).append(n)
        else:
            rec["counters"][name] = rec["counters"].get(name, 0) + n


def kernel_launch(kernel):
    """Note the time of a hand-written kernel's launch in the open
    call's record, while a profiler records."""
    if _OPEN and _autograd_profiler._is_profiler_enabled:
        _OPEN[-1]["kernel_launches"].append((kernel, time.time_ns()))


def calls():
    """The records of the last calls (at most 256), oldest first: each a
    dict of `t0`, `t1` (`time.time_ns()`), `counters`, `spans` and
    `kernel_launches` (`_Call`)."""
    return list(_CALLS)


class Throughput:
    """Running throughput/ETA meter (mirrors `profiling.Throughput`, the
    same output on the host clock).

    Example
    -------
    >>> meter = Throughput(total=len(stars), unit="stars")
    >>> for batch in batches:
    ...     process(batch)
    ...     meter.update(len(batch))
    """

    def __init__(self, total=None, unit="items", stream=sys.stderr,
                 report_every=1.0):
        self.total = total
        self.unit = unit
        self.stream = stream
        self.report_every = report_every
        self.t0 = time.perf_counter()
        self.done = 0
        self._last_report = 0.0

    @property
    def elapsed(self):
        return time.perf_counter() - self.t0

    @property
    def rate(self):
        dt = self.elapsed
        return self.done / dt if dt > 0 else 0.0

    @property
    def eta(self):
        if self.total is None or self.rate == 0:
            return float("nan")
        return (self.total - self.done) / self.rate

    def update(self, n=1, extra=""):
        self.done += n
        now = self.elapsed
        if self.stream is not None and (now - self._last_report
                                        >= self.report_every):
            self._last_report = now
            msg = (f"\r{self.done}"
                   + (f"/{self.total}" if self.total else "")
                   + f" {self.unit}  ({self.rate:.2f}/s")
            if self.total:
                msg += f", eta {self.eta:.1f} s"
            msg += ") " + extra + "   "
            self.stream.write(msg)
            self.stream.flush()

    def close(self):
        if self.stream is not None:
            self.stream.write("\n")
            self.stream.flush()


__all__ = ["trace", "annotate", "Throughput", "recording", "span",
           "call", "traced_call", "count", "kernel_launch", "calls"]
