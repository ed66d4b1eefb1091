"""renderer_init_ms (ms): a new Renderer on the compiled scene,
once an image, ended by a synchronize; the mean over the window's images
outside the profiled sub-window.  Host clock."""


def read(run):
    s = run.host_spans("renderer_init")
    return 1e3 * sum(s) / len(s) if s else None
