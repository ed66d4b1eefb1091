"""scene_setup_s (s): set-up's compile_scene and its first Renderer's
construction (upload, world tables, trees), ended by a synchronize.
Host clock, around both calls."""


def read(run):
    spans = [s for s in run.spans.items if s.attrs.get("setup")
             and s.name in ("scene_compile", "renderer_init")]
    return sum(s.seconds for s in spans) if spans else None
