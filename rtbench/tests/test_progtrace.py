"""The readers of the program's spans (rtbench/progtrace.py and the
metrics that use it) on synthetic runs: the clock offset between the
host's spans and the profiler's, idle time put down to the innermost
program span, the refusals, and the host-clock readers' choice of
spans."""

from dataclasses import dataclass, field

import pytest

from rtbench import core, drive, progtrace
from rtbench.devtrace import DeviceTrace
from rtbench.spans import Span as BenchSpan
from rtbench.spans import Spans

# The profiler's clock less the host's, in microseconds.
OFFSET_US = 123_456.5
# The window opens at 100 s on the host clock.
T0 = 100.0


@dataclass(eq=False)
class ProgSpan:
    name: str
    t0: float
    t1: float
    parent: object = None
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self):
        return self.t1 - self.t0


class FakeProgram:
    def __init__(self, spans, dropped=0):
        self._spans, self._dropped = spans, dropped

    def spans(self, since=None):
        return [s for s in self._spans if since is None or s.t0 >= since]

    def dropped(self):
        return self._dropped


def _bench_spans(items):
    out = Spans()
    out.items = [BenchSpan(n, a, b, {"profiled": p}) for n, a, b, p in items]
    return out


def _run(bench_items, trace=None):
    out = drive.Outcome(t0=T0, t1=T0 + 1.0)
    return core.Run("fow-offline", {}, {}, None, _bench_spans(bench_items),
                    out, 1.0, trace)


def _us(t):
    """A host time on the profiler's clock."""
    return 1e6 * t + OFFSET_US


def _trace(bench_items, ops, jitter_us=0.0, late=1):
    """The profiled sub-window [T0 + 0.1, T0 + 0.5] s with ``ops`` (host
    seconds) and the profiled benchmark spans shifted by the offset, the
    last ``late`` of them further by ``jitter_us``."""
    prof = [(n, a, b) for n, a, b, p in bench_items if p]
    spans = [(_us(a), _us(b), n) for n, a, b in prof]
    for i in range(len(spans) - late, len(spans)):
        s, e, n = spans[i]
        spans[i] = (s + jitter_us, e + jitter_us, n)
    return DeviceTrace(_us(T0 + 0.1), _us(T0 + 0.5),
                       ops=sorted((_us(a), _us(b), n) for a, b, n in ops),
                       spans=sorted(spans))


# One image in the profiled sub-window: a Renderer's construction (its
# world tables, then its tree), a chunk and the readback.
BENCH = [("renderer_init", T0 + 0.01, T0 + 0.05, False),
         ("chunk", T0 + 0.05, T0 + 0.09, False),
         ("renderer_init", T0 + 0.10, T0 + 0.20, True),
         ("chunk", T0 + 0.20, T0 + 0.40, True),
         ("readback", T0 + 0.40, T0 + 0.45, True)]


def _program_spans():
    """The program's spans under BENCH: a set-up Renderer before the
    window, one outside the profiled sub-window and one inside it."""
    out = []

    def renderer(serial, t, tables_s, tree_s, step_at, step_s, wait_s):
        init = ProgSpan("renderer.init", t, t + tables_s + tree_s,
                        attrs={"renderer": serial})
        out.extend([ProgSpan("renderer.init.world_tables", t, t + tables_s,
                             init, {"tables": 25}),
                    ProgSpan("renderer.init.sphere_tree", t + tables_s,
                             init.t1, init), init])
        step = ProgSpan("renderer.step", step_at, step_at + step_s,
                        attrs={"renderer": serial, "b0": 0, "k": 12,
                               "path": "fused"})
        out.extend([ProgSpan("renderer.step.wait", step.t1 - wait_s,
                             step.t1, step), step,
                    ProgSpan("renderer.step.record", step.t1,
                             step.t1 + 0.0001)])

    # Set-up's, before the window.
    renderer(0, T0 - 5.0, 0.020, 0.005, T0 - 4.9, 0.010, 0.004)
    # Tables 10-22 ms, tree 22-26, step 50-80 (waits from 53).
    renderer(1, T0 + 0.01, 0.012, 0.004, T0 + 0.05, 0.030, 0.027)
    # Profiled: tables 100-150 ms, tree 150-180, step 200-280 (waits from
    # 240), its record 280-280.1.
    renderer(2, T0 + 0.10, 0.050, 0.030, T0 + 0.20, 0.080, 0.040)
    return out


@pytest.fixture
def program(monkeypatch):
    prog = FakeProgram(_program_spans())
    monkeypatch.setattr(progtrace, "_program", lambda: prog)
    return prog


def test_offset_comes_back():
    run = _run(BENCH, _trace(BENCH, []))
    assert progtrace.clock_offset_us(run) == pytest.approx(OFFSET_US,
                                                           abs=1e-3)


def test_pairs_that_disagree_give_nothing(program):
    ops = [(T0 + 0.1, T0 + 0.105, "k")]
    # One pair of three late (host noise between the profiler's stamp and
    # perf_counter, 106-182 us on the card) is set aside: the others give
    # the offset, and both idle readers read.
    for late_us in (150.0, 182.0, 5000.0):
        run = _run(BENCH, _trace(BENCH, ops, jitter_us=late_us))
        assert progtrace.clock_offset_us(run) == pytest.approx(OFFSET_US,
                                                               abs=1e-3)
        for name in ("init_idle_pct.fow", "step_idle_pct.fow"):
            assert core.Bench().reader(name)(run) is not None
    # Half of the pairs 300 us off the others: no offset, no reading.
    four = BENCH + [("chunk", T0 + 0.45, T0 + 0.48, True)]
    run = _run(four, _trace(four, ops, jitter_us=300.0, late=2))
    assert progtrace.clock_offset_us(run) is None
    assert core.Bench().reader("init_idle_pct.fow")(run) is None
    assert core.Bench().reader("step_idle_pct.fow")(run) is None
    # Within the limit every pair is kept.
    run = _run(BENCH, _trace(BENCH, ops, jitter_us=50.0))
    assert progtrace.clock_offset_us(run) == pytest.approx(OFFSET_US,
                                                           abs=1e-3)
    assert core.Bench().reader("init_idle_pct.fow")(run) is not None
    # No pair: nothing.
    no_pairs = [(n, a, b, False) for n, a, b, _ in BENCH]
    assert progtrace.clock_offset_us(_run(no_pairs, _trace(BENCH, ops))) \
        is None


def test_an_idle_gap_in_the_world_tables_is_init_idle(program):
    # The card busy over the whole sub-window but for 20 ms inside the
    # profiled Renderer's world tables and 10 ms inside its step before
    # the wait.
    ops = [(T0 + 0.10, T0 + 0.12, "k"), (T0 + 0.14, T0 + 0.21, "k"),
           (T0 + 0.22, T0 + 0.5, "k")]
    run = _run(BENCH, _trace(BENCH, ops))
    by = progtrace.idle_by_span(run)
    assert by["renderer.init.world_tables"] == pytest.approx(0.02, abs=1e-7)
    assert by["renderer.step"] == pytest.approx(0.01, abs=1e-7)
    window = 0.4
    assert core.Bench().reader("init_idle_pct.fow")(run) == pytest.approx(
        100 * 0.02 / window, abs=1e-4)
    assert core.Bench().reader("step_idle_pct.fow")(run) == pytest.approx(
        100 * 0.01 / window, abs=1e-4)
    # Both inside the card's idle share.
    idle = core.Bench().reader("device_idle_pct.fow")(run)
    assert idle == pytest.approx(100 * 0.03 / window, abs=1e-4)


def test_a_wait_is_not_step_idle(program):
    # Idle only inside the profiled step's wait.
    ops = [(T0 + 0.10, T0 + 0.25, "k"), (T0 + 0.27, T0 + 0.5, "k")]
    run = _run(BENCH, _trace(BENCH, ops))
    assert progtrace.idle_by_span(run) == {
        "renderer.step.wait": pytest.approx(0.02, abs=1e-7)}
    assert core.Bench().reader("step_idle_pct.fow")(run) == 0.0


def test_host_readers_leave_out_set_up_and_profiled_spans(program):
    run = _run(BENCH)
    b = core.Bench()
    # Only the window's Renderer outside the profiled sub-window: 12 ms of
    # tables, 4 of tree, a 30 ms step of which 27 waited.
    assert b.reader("init_tables_ms.fow")(run) == pytest.approx(12.0)
    assert b.reader("init_trees_ms.fow")(run) == pytest.approx(4.0)
    assert b.reader("step_host_ms")(run) == pytest.approx(3.0)
    assert b.reader("step_host_ms.fow")(run) == pytest.approx(3.0)
    # With every span of the window profiled, those are read.
    every = [(n, a, b, True) for n, a, b, _ in BENCH]
    assert b.reader("init_tables_ms.fow")(_run(every)) == pytest.approx(
        (12.0 + 50.0) / 2)


def test_a_ring_that_dropped_the_window_gives_nothing(monkeypatch):
    spans = [s for s in _program_spans() if s.t0 >= T0]
    monkeypatch.setattr(progtrace, "_program",
                        lambda: FakeProgram(spans, dropped=3))
    run = _run(BENCH, _trace(BENCH, [(T0 + 0.1, T0 + 0.2, "k")]))
    for name in ("init_tables_ms.fow", "step_host_ms", "init_idle_pct.fow"):
        assert core.Bench().reader(name)(run) is None
    # Spans pushed out before the window are no loss.
    monkeypatch.setattr(progtrace, "_program",
                        lambda: FakeProgram(_program_spans(), dropped=3))
    assert core.Bench().reader("init_tables_ms.fow")(run) is not None


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setattr(progtrace, "_program", lambda: None)
    run = _run(BENCH, _trace(BENCH, [(T0 + 0.1, T0 + 0.2, "k")]))
    for name in ("init_tables_ms.fow", "init_trees_ms.fow", "step_host_ms",
                 "init_idle_pct.fow", "step_idle_pct.fow"):
        assert core.Bench().reader(name)(run) is None
