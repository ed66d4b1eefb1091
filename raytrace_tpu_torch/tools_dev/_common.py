"""What the dev probes share: their command line, the card's name and
power limit and an ulp distance (their CUDA-event timing is
tools/smoke_lib.median_ms, as chip_smoke.py's)."""

from __future__ import annotations

import argparse
import subprocess

import torch


def parse(argv, description: str, extra=None) -> argparse.Namespace:
    """``--device`` (cuda, the default, or cpu) and a probe's own options
    (``extra(parser)``).  Raises where cuda is asked for and there is no
    card: a probe never falls back to the CPU."""
    parser = argparse.ArgumentParser(
        description=description.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: the kernels on cuda:0; cpu: the plain "
                             "versions")
    if extra is not None:
        extra(parser)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a card, or pass "
                               "--device cpu for the plain versions")
        args.device = torch.device("cuda:0")
    else:
        args.device = torch.device("cpu")
    return args


def card_line(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu (plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 ulps between a and b, element by
    element (the count of floats between them; 0 where they are equal)."""
    def ordered(v):
        i = v.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())
