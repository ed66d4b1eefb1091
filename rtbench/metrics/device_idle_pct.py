"""device_idle_pct (%): the share of the profiled sub-window in which the
card ran no kernel, copy or set: one minus the union of the profiler's
device intervals over the window's length.  torch.profiler (CUPTI)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0.0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
