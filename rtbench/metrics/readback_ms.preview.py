"""readback_ms.preview (ms): Renderer.image(), the running mean copied to
the host, once a refresh; the mean over the window's refreshes outside
the profiled sub-window.  Host clock."""


def read(run):
    s = run.host_spans("readback")
    return 1e3 * sum(s) / len(s) if s else None
