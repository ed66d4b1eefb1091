"""The device's timeline over a profiled sub-window of a traced run.

``Profiler`` prepares ``torch.profiler`` (CPU and CUDA activities, CUPTI
on the card) in set-up, starts it at a unit boundary inside the measured
window and stops it at a later one; the profiled units run inside one
``rtbench.profiled`` range.  ``DeviceTrace`` keeps what the readers need
from the events: the card's operations (kernels, copies, sets) as
intervals with their names, and the benchmark's own ranges
(``rtbench.<span>``), on the profiler's clock in microseconds.  A process
profiles once: a second ``torch.profiler`` session in one process has
dropped the card's kernel events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from rtbench.spans import PREFIX

WINDOW = PREFIX + "profiled"


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` ((start, end, ...) tuples)
    clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for iv in sorted(intervals):
        s, e = max(iv[0], end), min(iv[1], hi)
        if e > s:
            busy += e - s
            end = e
    return busy


@dataclass
class DeviceTrace:
    t0: float  # the profiled range on the profiler's clock (us)
    t1: float
    ops: list = field(default_factory=list)    # (start, end, name)
    spans: list = field(default_factory=list)  # (start, end, span name)

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        from torch.autograd import DeviceType

        host = [e for e in events if e.name == WINDOW
                and e.device_type == DeviceType.CPU]
        if len(host) != 1:
            raise RuntimeError(f"profile: {len(host)} ranges {WINDOW!r}")
        t0, t1 = host[0].time_range.start, host[0].time_range.end
        ops, spans = [], []
        for e in events:
            name = e.name
            if e.device_type == DeviceType.CUDA:
                # A range's device-side annotation spans the range; it is
                # no operation of the card's.
                if not name.startswith(PREFIX):
                    ops.append((e.time_range.start, e.time_range.end, name))
            elif name.startswith(PREFIX) and name != WINDOW:
                spans.append((e.time_range.start, e.time_range.end,
                              name[len(PREFIX):]))
        return cls(t0, t1, sorted(ops), sorted(spans))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, lo=None, hi=None) -> float:
        return union_us(self.ops, self.t0 if lo is None else lo,
                        self.t1 if hi is None else hi) / 1e6

    def kernel_s(self, match: str) -> float:
        """Device seconds of the operations whose name holds ``match``."""
        return sum(e - s for s, e, n in self.ops
                   if match in n and s >= self.t0 and e <= self.t1) / 1e6

    def spans_named(self, name: str) -> list:
        return [(s, e) for s, e, n in self.spans if n == name]

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds], ...] of the operations that took most device
        time in the window, summed by name."""
        by = {}
        for s, e, n in self.ops:
            if s >= self.t0 and e <= self.t1:
                by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])][:k]

    def idle_gaps(self, k: int = 10) -> list:
        """[[span, seconds], ...]: the longest stretches of the window in
        which the card ran nothing, each named by the innermost
        benchmark span around its middle (``outside spans`` where none
        is)."""
        gaps, end = [], self.t0
        for s, e, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            around = [(e - s, n) for s, e, n in self.spans if s <= mid <= e]
            out.append([min(around)[1] if around else "outside spans",
                        (b - a) / 1e6])
        return out


class Profiler:
    """One profiled sub-window.  ``prepare`` (in set-up) pays the
    profiler's own start, several seconds of CUPTI's; ``start`` and
    ``stop`` are called by the driver between units."""

    def __init__(self):
        self.prof = self.window = None
        self.trace = None

    def prepare(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.prepare_trace()

    def start(self) -> None:
        from torch.profiler import record_function

        self.prof.start_trace()
        self.window = record_function(WINDOW)
        self.window.__enter__()

    def stop(self) -> None:
        import torch

        self.window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop_trace()
        self.trace = DeviceTrace.from_events(self.prof.events())
        self.prof = None
