"""setup_s (s): from the run's process start (the first line of run.py)
to the first timed call: imports, CUDA, the scene made from the seed,
compile_scene, the kernel library (built on a checkout's first run) and
the cell's warm-up.  Host clock."""


def read(run):
    return run.setup_s
