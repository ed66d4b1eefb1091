"""The program's own spans, for the readers of per-layer metrics.

The program records a span at each layer boundary of its Renderer
(``raytrace_tpu_torch/utils/profiling.py``: ``spans(since)`` on the host's
``perf_counter`` clock, ``dropped()`` for those its ring pushed out).
``window_spans`` gives a run's spans of the measured window, less those
inside a benchmark span of the profiled sub-window (the profiler's cost
is not theirs), as ``Run.host_spans`` does for the benchmark's own.

``idle_by_span`` puts the card's idle time in the profiled sub-window
down to the program's spans: each idle instant to the innermost program
span around it, as ``DeviceTrace.idle_gaps`` names a gap by the
benchmark's spans.  The program's spans are on the host clock and the
trace on the profiler's, so the two are tied by the benchmark's profiled
spans, which exist on both (``run.spans`` and ``run.trace.spans``): paired
by name in start order, the offset is the median of the pairs' (profiler
start - host start), those far from it set aside.

Every call returns None where it finds nothing to read: a program
without the tracer, an untraced run, a ring that dropped spans of the
window, no pair, or pairs of which fewer than half lie within
``MAX_SPREAD_US`` of their median offset.
"""

from __future__ import annotations

import statistics

MAX_SPREAD_US = 100.0
# The program's span names the readers take (a step's and an init's
# children are named after them: "renderer.step.geometry", ...).
STEP = "renderer.step"
WAIT = "renderer.step.wait"
INIT = "renderer.init"


def _program():
    try:
        from raytrace_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    return profiling


def program_spans(run) -> list | None:
    """The program's spans that started in the measured window, or None
    (no tracer, or its ring dropped spans of the window)."""
    prof = _program()
    if prof is None:
        return None
    ring = prof.spans()
    # The ring pushes out its oldest spans: the window lost none where the
    # oldest one kept ended before the window opened.
    if prof.dropped() and (not ring or ring[0].t1 >= run.outcome.t0):
        return None
    return [s for s in ring if s.t0 >= run.outcome.t0]


def window_spans(run) -> list | None:
    """``program_spans`` less those inside a benchmark span of the
    profiled sub-window, or all where every one was."""
    spans = program_spans(run)
    if spans is None:
        return None
    profiled = [(s.t0, s.t1) for s in run.spans.items
                if s.attrs.get("profiled")]
    out = [s for s in spans
           if not any(a <= s.t0 <= b for a, b in profiled)]
    return out or spans


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def children(spans, parents, name: str) -> dict:
    """{id(parent): [its children called ``name``]} for ``parents``."""
    out = {id(p): [] for p in parents}
    for s in spans:
        if s.name == name and id(s.parent) in out:
            out[id(s.parent)].append(s)
    return out


def per_init_ms(run, names) -> float | None:
    """Milliseconds a Renderer spends in its ``renderer.init`` children
    called one of ``names``: their sum over the window's Renderers, over
    the Renderers."""
    spans = window_spans(run)
    if spans is None:
        return None
    inits = named(spans, INIT)
    if not inits:
        return None
    ids = {id(s) for s in inits}
    total = sum(s.seconds for s in spans
                if s.name in names and id(s.parent) in ids)
    return 1e3 * total / len(inits)


def clock_offset_us(run) -> float | None:
    """The profiler's clock less the host's (microseconds), from the
    benchmark's profiled spans: the median of the pairs within
    ``MAX_SPREAD_US`` of all pairs' median, or None where no pair exists
    or fewer than half of them are that close.  A pair whose host stamp
    came late (host noise between the profiler's stamp and
    ``perf_counter``) is set aside."""
    t = run.trace
    if t is None:
        return None
    offsets = []
    for name in sorted({n for _, _, n in t.spans}):
        host = sorted(s.t0 for s in run.spans.items
                      if s.name == name and s.attrs.get("profiled"))
        dev = sorted(s for s, _ in t.spans_named(name))
        if len(host) == len(dev):
            offsets += [d - 1e6 * h for h, d in zip(host, dev)]
    if not offsets:
        return None
    mid = statistics.median(offsets)
    kept = [o for o in offsets if abs(o - mid) <= MAX_SPREAD_US]
    if 2 * len(kept) < len(offsets):
        return None
    return statistics.median(kept)


def idle_gaps_us(trace) -> list:
    """[(start, end), ...] of the profiled sub-window in which the card
    ran nothing (the profiler's clock, microseconds)."""
    gaps, end = [], trace.t0
    for s, e, _ in trace.ops:
        s, e = max(s, trace.t0), min(e, trace.t1)
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.t1 > end:
        gaps.append((end, trace.t1))
    return gaps


def idle_by_span(run) -> dict | None:
    """{span name: seconds}: the card's idle time in the profiled
    sub-window by the innermost program span around each idle instant
    (the key "" where none is), or None."""
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0.0:
        return None
    offset = clock_offset_us(run)
    spans = program_spans(run)
    if offset is None or spans is None:
        return None
    # Sweep the boundaries of the gaps and of the mapped spans in time
    # order; between two boundaries the innermost open span is the one
    # started last.
    events = []
    for i, s in enumerate(spans):
        a, b = 1e6 * s.t0 + offset, 1e6 * s.t1 + offset
        if b > t.t0 and a < t.t1:
            events += [(a, 1, i), (b, -1, i)]
    for a, b in idle_gaps_us(t):
        events += [(a, 2, -1), (b, -2, -1)]
    events.sort()
    out, open_, idle, last = {}, {}, False, None
    for when, kind, i in events:
        if idle and last is not None and when > last:
            inner = max(open_.values(), default=None,
                        key=lambda s: (s.t0, -s.t1))
            key = "" if inner is None else inner.name
            out[key] = out.get(key, 0.0) + (when - last) / 1e6
        last = when
        if kind == 1:
            open_[i] = spans[i]
        elif kind == -1:
            open_.pop(i, None)
        else:
            idle = kind == 2
    return out


def idle_pct(run, keep) -> float | None:
    """The share of the profiled sub-window (%) in which the card was
    idle while the innermost program span's name passed ``keep``."""
    by = idle_by_span(run)
    if by is None:
        return None
    return 100.0 * sum(v for k, v in by.items() if keep(k)) / (
        run.trace.window_s)
