"""init_trees_ms (ms): a new Renderer's sphere trees (the program's
``renderer.init.sphere_tree`` and ``renderer.init.object_tree`` spans:
the mid-time table, the Morton order and the tree's build, its device
work enqueued), the mean a Renderer over the window's Renderers outside
the profiled sub-window.  Host clock, the program's spans (rtbench/
progtrace.py)."""

from rtbench import progtrace


def read(run):
    return progtrace.per_init_ms(run, {"renderer.init.sphere_tree",
                                       "renderer.init.object_tree"})
