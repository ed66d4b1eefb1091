"""Run one cell of the benchmark once, on the card it is started on.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (imports, CUDA, the scene made from the seed, ``compile_scene``,
the kernel library, the cell's warm-up), then the measured window, then
the check against the plain reference, then one JSON line on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``check``, holds
every number compared beside its limit, which are also the last lines on
standard error.  Without a CUDA device, with fewer devices than the cell
asks for, without the program beside the benchmark, or with JAX or the
JAX package loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# glibc's allocator policy, fixed before anything large is allocated: a
# block up to 32 MiB (the ceiling of glibc's own moving threshold) comes
# from the heap, and the heap keeps up to 256 MiB free.  With glibc's
# moving thresholds a run's 10-13 MB images came from fresh pages, faulted
# in on every copy to the host, in some runs and not in others, by the
# allocator's history (PERF.md).
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3


def fix_allocator() -> None:
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt(M_MMAP_THRESHOLD, 32 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, 256 << 20)
    except (OSError, AttributeError):
        pass  # not glibc: its own policy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_allocator()

    from rtbench import core

    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    if not (ROOT / core.PROGRAM / "__init__.py").exists():
        print(f"rtbench: the program {core.PROGRAM}/ is not beside the "
              f"benchmark in {ROOT}", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("rtbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"rtbench: the cell needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    try:
        result = core.run(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    except core.ConfigError as exc:
        print(f"rtbench: {exc}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"rtbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    for line in core.compared_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
