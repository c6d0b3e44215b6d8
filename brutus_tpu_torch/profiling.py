"""
Tracing and throughput instrumentation (mirrors `brutus_tpu/profiling.py`).

  * `trace(...)` — context manager around `torch.profiler` writing a
    Chrome trace of the host and the card (TensorBoard's PyTorch
    profiler plugin and Perfetto read it), as `jax.profiler` writes an
    XPlane trace;
  * `annotate(...)` — a named region in that trace
    (`torch.profiler.record_function`, as `jax.profiler.TraceAnnotation`);
  * `Throughput` — a running rate + ETA meter on the host clock.
"""

import contextlib
import os
import sys
import time

import torch


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


__all__ = ["trace", "annotate", "Throughput"]
