"""step_idle_pct (%): the share of the profiled sub-window in which the
card ran nothing while the host was inside a step but not waiting on
the card (the program's ``renderer.step`` span and its children other
than ``renderer.step.wait``, and the ``renderer.step.record`` that books
it; the innermost span around each idle instant).  torch.profiler for
the card, the program's spans mapped onto its clock (rtbench/
progtrace.py)."""

from rtbench import progtrace


def read(run):
    step = progtrace.STEP
    return progtrace.idle_pct(
        run, lambda name: name != progtrace.WAIT and (
            name == step or name.startswith(step + ".")))
