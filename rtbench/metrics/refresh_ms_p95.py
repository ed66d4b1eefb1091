"""refresh_ms_p95 (ms): a refresh is one stepped render_batches call and
the running mean's copy to the host; the 95th percentile over the
window's refreshes outside the profiled sub-window (statistics.quantiles
in 20).  Host clock, a refresh at a time."""

import statistics


def read(run):
    s = run.host_spans("refresh")
    if len(s) < 20:
        return None
    return 1e3 * statistics.quantiles(s, n=20)[18]
