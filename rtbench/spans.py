"""Spans the benchmark records around its calls into the program.

A span is a name, its start and end on the host clock (perf_counter
seconds) and a few attributes.  With ``annotate`` each span is also a
``torch.profiler.record_function`` range named ``rtbench.<name>``, so a
profiled window's device operations can be placed inside the host's
spans.  Spans stay in memory; readers take them after the run.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

PREFIX = "rtbench."


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.items: list[Span] = []
        # Set while the profiler records: spans started then are marked.
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        attrs["profiled"] = self.profiling
        rec = None
        if self.annotate:
            import torch

            rec = torch.profiler.record_function(PREFIX + name)
            rec.__enter__()
        s = Span(name, time.perf_counter(), 0.0, attrs)
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            if rec is not None:
                rec.__exit__(None, None, None)
            self.items.append(s)

    def named(self, name: str, profiled=None, **match) -> list[Span]:
        """Spans called ``name`` whose attributes hold ``match``; with
        ``profiled`` True or False only those started inside or outside
        the profiled sub-window."""
        return [s for s in self.items if s.name == name
                and (profiled is None or s.attrs["profiled"] == profiled)
                and all(s.attrs.get(k) == v for k, v in match.items())]
