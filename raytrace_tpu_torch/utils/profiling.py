"""Profiling and metrics (counterpart of raytrace_tpu/utils/profiling.py).

- ``span(name, **attrs)``: the program's tracer.  A span is a name, its
  start and end on ``time.perf_counter()`` (the clock of the host spans
  of the benchmark, ``rtbench/spans.py``), the span around it in the same
  thread (``parent``) and its attributes.  Every span goes into one
  process-wide ring of the last ``RING`` spans (``dropped`` counts those
  pushed out); ``spans(since)`` is the public read.  While
  ``torch.profiler`` records, a span is also a host range named
  ``rt.<name>`` in the profile (a function-scope range, which puts no
  annotation of its own on the card's timeline), so a trace shows the
  program's phases beside the card's kernels.
- ``trace(log_dir)``: context manager around ``torch.profiler`` that
  records the enclosed block (the host's operations, and the card's
  kernels where CUDA is available) and writes a Chrome trace into
  ``log_dir`` (open it in chrome://tracing or Perfetto).
- ``BatchMetrics``: per-batch counters (rays, seconds, Mrays/s, spp/s)
  with a JSONL sink, the JAX package's records and lines.

The spans the program records (attributes in brackets):

- ``scene.compile``: ``models/compile.compile_scene``;
- ``renderer.init`` [renderer]: ``Renderer.__init__``, with children
  ``renderer.init.world_tables`` [tables: those computed at set-up],
  ``.upload``, ``.bvh``, ``.tris``, ``.sphere_tree``, ``.object_tree``
  and ``.anim_geom``;
- ``renderer.step`` [renderer, b0, k, path]: ``Renderer._step``, with
  children ``renderer.step.geometry`` [h2d_bytes], ``.launch``,
  ``.wait`` (each of the step's waits on the card), ``.accumulate``,
  ``.debug`` and ``.world_table`` [batch] (a static scene's table built
  after set-up: ahead, between ``.launch`` and ``.wait``, or inside
  ``.geometry``); ``renderer.step.record`` follows its step and books the
  step span's seconds into ``RenderStats`` and ``BatchMetrics``;
- ``renderer.readback`` [d2h_bytes]: ``Renderer.image()``;
- ``kernels.build`` [library]: an nvcc run of ``ops/_build.build``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger(__name__)

# Spans the ring holds: a 10 s live preview records about 17k.
RING = 1 << 16
# Prefix of a span's range in a profile.
RANGE_PREFIX = "rt."
_clock = time.perf_counter


class Span:
    """One timed region; the context manager that ``span`` returns."""

    __slots__ = ("name", "t0", "t1", "parent", "attrs", "seq", "_tracer",
                 "_stack", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name, self.attrs, self._tracer = name, attrs, tracer
        self.t0 = self.t1 = 0.0
        self.parent = self.seq = self._stack = self._range = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        self._stack = stack = self._tracer._local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._stack.pop()
        self._stack = None
        self._tracer._push(self)


class _Stacks(threading.local):
    def __init__(self):
        self.stack = []


class Tracer:
    """A bounded ring of finished spans, shared by the process's threads;
    each thread keeps its own stack of open spans for the parent links.
    A span's ``seq`` numbers it among the spans pushed, so the ring has
    dropped all but the last ``len(ring)`` of them."""

    def __init__(self, size: int = RING):
        self._ring = collections.deque(maxlen=size)
        # deque.append and next() on a count are each one step under the
        # interpreter lock: threads share both without a lock of ours.
        self._seq = itertools.count()
        self._local = _Stacks()

    def _push(self, s: Span) -> None:
        s.seq = next(self._seq)
        self._ring.append(s)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def spans(self, since: Optional[float] = None) -> List[Span]:
        """The ring's spans in the order they ended; with ``since`` only
        those started at or after that ``perf_counter`` time."""
        # One copy in C, which no other thread's append can interleave.
        out = list(self._ring)
        if since is None:
            return out
        return [s for s in out if s.t0 >= since]

    @property
    def dropped(self) -> int:
        """Spans pushed out of the ring."""
        out = self.spans()
        return max(s.seq for s in out) + 1 - len(out) if out else 0


_TRACER = Tracer()


def span(name: str, **attrs) -> Span:
    """A span of the process's tracer: ``with span("renderer.step", k=4):``."""
    return _TRACER.span(name, **attrs)


def spans(since: Optional[float] = None) -> List[Span]:
    """The process's recorded spans (``Tracer.spans``)."""
    return _TRACER.spans(since)


def dropped() -> int:
    """Spans the process's ring has pushed out."""
    return _TRACER.dropped


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir``; yields the profiler, whose
    ``trace_path`` names the file once the block has ended.  A profiler
    that cannot start or write raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            # The block's kernels end inside the profiled window.
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    log.info("profile written to %s", prof.trace_path)


@dataclass
class BatchRecord:
    batch: int
    seconds: float
    rays: float
    pixels: int
    spp: int

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0

    @property
    def spp_per_sec(self) -> float:
        return self.spp / self.seconds if self.seconds > 0 else 0.0


@dataclass
class BatchMetrics:
    """Per-batch render metrics with optional JSONL persistence."""

    pixels: int
    spp: int
    jsonl_path: Optional[str] = None
    records: List[BatchRecord] = field(default_factory=list)

    def record(self, batch: int, seconds: float, rays: float) -> BatchRecord:
        rec = BatchRecord(batch=batch, seconds=seconds, rays=rays,
                          pixels=self.pixels, spp=self.spp)
        self.records.append(rec)
        log.debug(
            "batch %d: %.3fs, %.2fM rays, %.1f Mrays/s, %.2f spp/s",
            batch, seconds, rays / 1e6, rec.mrays_per_sec, rec.spp_per_sec,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({
                    "batch": batch, "seconds": seconds, "rays": rays,
                    "mrays_per_sec": rec.mrays_per_sec,
                    "spp_per_sec": rec.spp_per_sec,
                }) + "\n")
        return rec

    @property
    def total_rays(self) -> float:
        return sum(r.rays for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    @property
    def mrays_per_sec(self) -> float:
        t = self.total_seconds
        return self.total_rays / t / 1e6 if t > 0 else 0.0
