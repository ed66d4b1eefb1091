"""step_host_ms (ms): the host's own time in a step: each of the
program's ``renderer.step`` spans less its ``renderer.step.wait``
children (the host waiting on the card), the mean over the window's
steps outside the profiled sub-window.  Host clock, the program's spans
(rtbench/progtrace.py)."""

from rtbench import progtrace


def read(run):
    spans = progtrace.window_spans(run)
    if spans is None:
        return None
    steps = progtrace.named(spans, progtrace.STEP)
    if not steps:
        return None
    waits = progtrace.children(spans, steps, progtrace.WAIT)
    own = [s.seconds - sum(w.seconds for w in waits[id(s)]) for s in steps]
    return 1e3 * sum(own) / len(own)
