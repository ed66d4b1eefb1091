"""host_gap_ms.preview (ms): the host's share of a stepped batch: each
profiled ``render_batches`` call's wall time (the ``rtbench.step``
range) less the card's busy time inside it, the mean over the calls.
torch.profiler: the range and the device intervals on one clock."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    steps = t.spans_named("step")
    if not steps:
        return None
    gaps = [(e - s) / 1e6 - t.busy_s(s, e) for s, e in steps]
    return 1e3 * sum(gaps) / len(gaps)
