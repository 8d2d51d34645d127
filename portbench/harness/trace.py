"""Spans around the program's calls and the profiler's trace of the device.

A span times one call into a layer of the program by the host's clock, the
device synchronised at both ends, on whichever thread makes the call (the
profiler records the CPU side of the thread that started it only).  Spans
exist in the traced run only (``--trace 1``); in the measured run
:meth:`Tracer.wrap` leaves the program untouched.

:meth:`Tracer.start` and :meth:`Tracer.stop` bound the profiler's window,
which a driver may keep shorter than the measured window where the trace
would grow too large (a MusicGen decode step launches about 1,400 device
operations); :meth:`Tracer.collect` reads it once the window is over.

From the trace: each kernel's name and duration (also inside CUDA graphs),
the device's busy time (the union of the intervals in which an operation ran
on it), the window's length, the ten operations that took most time, and the
idle time by the innermost span the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import time
import typing as tp

import torch

from .device import Device

Interval = tp.Tuple[str, int, int]          # (name, start ns, end ns)


def _merge(intervals: tp.Iterable[tp.Tuple[int, int]]) -> tp.List[tp.Tuple[int, int]]:
    out: tp.List[tp.Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


class Trace:
    """What one profiler window saw."""

    def __init__(self, kernels: tp.List[Interval], spans: tp.List[Interval], start_ns: int,
                 end_ns: int):
        self.kernels, self.spans = kernels, spans
        self.start_ns, self.end_ns = start_ns, end_ns

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> tp.List[tp.Tuple[int, int]]:
        return _merge((max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.kernels
                      if e > self.start_ns and s < self.end_ns)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_times(self, match: tp.Callable[[str], bool]) -> tp.List[float]:
        """Seconds of each kernel whose name ``match`` accepts."""
        return [(e - s) / 1e9 for name, s, e in self.kernels if match(name)]

    def device_ops(self, top: int = 10) -> tp.List[tp.List[tp.Any]]:
        total: tp.Dict[str, float] = collections.Counter()
        for name, s, e in self.kernels:
            total[name] += (e - s) / 1e9
        return [[name[:200], sec] for name, sec in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> tp.List[tp.List[tp.Any]]:
        """Idle seconds of the device by the innermost span that covered each
        gap's middle ('outside spans' where none did)."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [t for iv in busy for t in iv] + [self.end_ns]
        total: tp.Dict[str, float] = collections.Counter()
        for start, end in zip(edges[::2], edges[1::2]):
            if end <= start:
                continue
            mid = (start + end) // 2
            covering = [(e - s, name) for name, s, e in self.spans if s <= mid < e]
            total[min(covering)[1] if covering else 'outside spans'] += (end - start) / 1e9
        return [[name, sec] for name, sec in total.most_common(top)]


class Tracer:
    """Spans and the profiler of one run; inert unless ``enabled``."""

    def __init__(self, device: Device, enabled: bool):
        self.device, self.enabled = device, enabled
        self.spans: tp.Dict[str, tp.List[float]] = collections.defaultdict(list)
        self.intervals: tp.List[Interval] = []       # every span, wall-clock ns
        self.trace: tp.Optional[Trace] = None
        self._prof = None
        self._results = None          # a closed window's events, until collect()
        self._started = 0.0
        self._length_ns = 0
        self._wall0 = 0

    @contextlib.contextmanager
    def span(self, name: str) -> tp.Iterator[None]:
        if not self.enabled:
            yield
            return
        self.device.sync()
        t0, wall0 = time.perf_counter(), time.time_ns()
        yield
        self.device.sync()
        self.spans[name].append(time.perf_counter() - t0)
        self.intervals.append((name, wall0, time.time_ns()))

    def wrap(self, obj: tp.Any, attr: str, name: str) -> None:
        """In the traced run, time every call of ``obj.attr`` as the span
        ``name`` (an attribute set on the instance)."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, timed)

    def start(self) -> None:
        if (not self.enabled or self._prof is not None or self.trace is not None
                or self._results is not None):
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.device.sync()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._started, self._wall0 = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        """Close the profiler's window (cheap); :meth:`collect` reads it."""
        if self._prof is None:
            return
        self.device.sync()
        self._length_ns = int((time.perf_counter() - self._started) * 1e9)
        self._prof.__exit__(None, None, None)
        self._results, self._prof = self._prof.profiler.kineto_results, None

    def collect(self) -> None:
        """Read the closed window's events into :attr:`trace`; run it once
        the measured window is over, since it takes seconds for a million
        kernels."""
        results = self._results
        if results is None:
            return
        start_ns = results.trace_start_ns()
        kernels: tp.List[Interval] = []
        for ev in results.events():
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                start = ev.start_ns()
                kernels.append((ev.name(), start, start + ev.duration_ns()))
        # the spans' wall clock in the trace's time base
        offset = start_ns - self._wall0
        spans = [(name, s + offset, e + offset) for name, s, e in self.intervals]
        self._results = None
        self.trace = Trace(kernels, spans, start_ns, start_ns + self._length_ns)
