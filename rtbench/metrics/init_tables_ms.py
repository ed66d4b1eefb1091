"""init_tables_ms (ms): a new Renderer's world tables (the program's
``renderer.init.world_tables`` span: one sphere table a batch time, on
the host), the mean a Renderer over the window's Renderers outside the
profiled sub-window.  Host clock, the program's spans (rtbench/
progtrace.py)."""

from rtbench import progtrace


def read(run):
    return progtrace.per_init_ms(run, {"renderer.init.world_tables"})
