"""Timers and device traces (port of nautilus_tpu/utils/timer.py).

- ``FunctionTimer``: a context manager printing the wall ms of its block;
- ``CumulativeFunctionTimer``: sums the wall time of many invocations and
  prints their mean at exit;
- ``RateLoop``: paces a loop at a fixed rate;
- ``span``, ``tracing``, ``take``: the program's tracer.  With tracing on,
  ``span(name)`` records (name, parent index, start ns, end ns) in memory;
  ``take()`` hands the records over and clears them.  While a profiler session records, a span
  is also a ``torch.profiler.record_function`` region, tracing on or off,
  so a profiled run's timeline carries the program's names.  With tracing
  off and no profiler, a span is one shared no-op context manager;
- ``profile_to``: records a ``torch.profiler`` session (host and, where a
  card is present, device activity) and writes it as a Chrome trace;
  ``device_busy_s`` reads from such a trace, or from the session itself, how
  long the card was busy.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"


class FunctionTimer:
    """Context manager printing elapsed wall ms on exit.

    >>> with FunctionTimer("associate"):
    ...     do_work()
    associate took 12.345 ms
    """

    def __init__(self, name: str, printer=print):
        self.name = name
        self.printer = printer
        self.elapsed_ms: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self.printer(f"{self.name} took {self.elapsed_ms:.3f} ms")
        return False


class CumulativeFunctionTimer:
    """Accumulates invocation times; reports the mean at exit (or on
    demand)."""

    _instances: Dict[str, "CumulativeFunctionTimer"] = {}

    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.invocations = 0
        CumulativeFunctionTimer._instances[name] = self

    @contextlib.contextmanager
    def scope(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_s += time.perf_counter() - t0
            self.invocations += 1

    @property
    def mean_ms(self) -> float:
        return (self.total_s / self.invocations * 1e3) if self.invocations \
            else 0.0

    def report(self) -> str:
        return (f"{self.name}: {self.mean_ms:.3f} ms mean over "
                f"{self.invocations} invocations")

    @classmethod
    def report_all(cls, printer=print):
        for t in cls._instances.values():
            if t.invocations:
                printer(t.report())


atexit.register(CumulativeFunctionTimer.report_all)


class RateLoop:
    """Fixed-rate loop pacing: call ``sleep()`` at the end of each pass; it
    sleeps out the rest of the 1/hz period, and after an over-long pass
    restarts the phase instead of bursting through catch-up passes."""

    def __init__(self, hz: float):
        if hz <= 0:
            raise ValueError(f"RateLoop needs hz > 0, got {hz}")
        self.period_s = 1.0 / hz
        self._next = time.perf_counter() + self.period_s

    def sleep(self):
        now = time.perf_counter()
        remaining = self._next - now
        if remaining > 0:
            time.sleep(remaining)
            self._next += self.period_s
        else:
            self._next = now + self.period_s


class Span(NamedTuple):
    """One finished span.  parent: the index of the enclosing span in the
    same ``take()``, or -1.  Times are Unix-epoch ns (``time.time_ns``),
    the clock of the profiler's event times."""

    name: str
    parent: int
    t0_ns: int
    t1_ns: int


_NOOP = contextlib.nullcontext()
_on = False
_spans: List[list] = []     # [name, parent, t0_ns, t1_ns] in start order
_open: List[int] = []       # indices of the spans open now, innermost last


class _Recorded:
    """A span while tracing is on: an in-memory record, inside a
    record_function region of the same name while a profiler records."""

    __slots__ = ("name", "region", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.region = (torch.profiler.record_function(self.name)
                       if torch.autograd._profiler_enabled() else _NOOP)
        self.region.__enter__()
        t0 = time.time_ns()
        self.record = [self.name, _open[-1] if _open else -1, t0, 0]
        _open.append(len(_spans))
        _spans.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record[3] = time.time_ns()
        _open.pop()
        return self.region.__exit__(*exc)


def span(name: str):
    """A context manager naming the enclosed work (see the module notes).
    It never synchronises the card: a span that ends right after a host
    read holds its device work, any other span only the host's."""
    if _on:
        return _Recorded(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOOP


def tracing(on: bool = True):
    """Switch the in-memory tracer on or off; records made so far stay
    until ``take()``."""
    global _on
    _on = bool(on)


def take() -> List[Span]:
    """The spans recorded since the last take(), which are cleared.  Call
    it outside any span: a parent index counts from this take's first
    span."""
    spans = [Span(*r) for r in _spans]
    _spans.clear()
    return spans


@contextlib.contextmanager
def profile_to(log_dir=None):
    """Profile the enclosed region (host ops and, with a card, its kernels
    and copies); with a ``log_dir``, write the Chrome trace
    ``log_dir/trace.json``.  Yields the ``torch.profiler.profile`` object.
    A solve of a thousand poses records millions of events, hundreds of MB
    as a trace file: measure such a region in memory (log_dir None and
    ``device_busy_s`` on the yielded object)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / TRACE_FILE))


# Chrome trace categories of the card's own work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_s(source) -> float:
    """Seconds in which the card ran at least one kernel, copy or set: the
    union of their intervals, since work on several streams overlaps.  Over
    the profiled region's wall it is the device's busy share.

    source: a Chrome trace file written by profile_to, or the profile
    object profile_to yielded (read in memory; regions named with
    span, which the trace also shows on the card's timeline, are not work
    and are left out)."""
    if isinstance(source, (str, Path)):
        events = json.loads(Path(source).read_text())["traceEvents"]
        spans = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    else:
        from torch.autograd import DeviceType
        spans = sorted((e.start_ns() * 1e-3, e.end_ns() * 1e-3)
                       for e in source.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA
                       and not e.is_user_annotation())
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 <= end:
            continue
        busy_us += t1 - max(t0, end)
        end = t1
    return busy_us * 1e-6
