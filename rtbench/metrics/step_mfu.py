"""step_mfu (%): the whole window's share of the chip's peak: the least
time of all the work the profiled calls did (work.py, as for K4's
roofline) over the profiled sub-window's length, whatever ran the work
and whatever else the host did.  torch.profiler for the window."""

from rtbench.work import least_seconds


def read(run):
    if run.trace is None or run.trace.window_s <= 0.0:
        return None
    units = run.units(profiled=True)
    if not units:
        return None
    least = least_seconds(run.facts, sum(u.samples for u in units),
                          sum(u.rays for u in units),
                          sum(u.batches for u in units))
    return 100.0 * least / run.trace.window_s
