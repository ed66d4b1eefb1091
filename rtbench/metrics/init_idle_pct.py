"""init_idle_pct (%): the share of the profiled sub-window in which the
card ran nothing while the host was inside a new Renderer's
construction (the program's ``renderer.init`` span and its children,
the innermost span around each idle instant).  torch.profiler for the
card, the program's spans mapped onto its clock (rtbench/
progtrace.py)."""

from rtbench import progtrace


def read(run):
    init = progtrace.INIT
    return progtrace.idle_pct(
        run, lambda name: name == init or name.startswith(init + "."))
