"""The one driver of every traffic mix: it reads a mix's parameters
(traffic/<mix>.json) and drives the program's Renderer through its
public calls for the measured window.

A mix's parameters:

- ``renderer_per_image``: true renders whole images back to back, each
  on a new ``Renderer`` over the compiled scene, the way ``render_all``
  and the CLI render one; false renders one progressive image for the
  whole window, its batch count raised so that it never finishes there.
- ``chunk``: batches a ``render_batches`` call, or ``"auto"`` for the
  Renderer's ``chunk_size()`` (a whole image's last chunk is what is
  left).
- ``batches_per_second_cap`` (progressive only): the batches a second
  the progressive image is sized for, well above what the card renders.
- ``profile_seconds``: how long the traced run's profiled sub-window
  lasts; it starts at ``PROFILE_START`` of the window, and starts and
  stops between calls.

A whole image is copied to the host once, at its end; a progressive
image's running mean after every call, as a live preview refreshes.  The
check keeps ``KEEP`` answers (finished images or running means) drawn
from the seed over the window, and the last; for a progressive image
also one of its first ``EARLY`` + 1 refreshes, where few samples let the
check see the sample count.

Every call is a unit: its batches, samples and rays, its host span, and
whether it ran inside the profiled sub-window.  The window closes at the
first call boundary past its length; it is measured from the first
call's start to the last call's end, so rates take all the work and all
the time of the window.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from rtbench.check import substream

PROFILE_START = 0.3
KEEP = 3
EARLY = 6


@dataclass
class Unit:
    batches: int
    samples: int
    rays: int
    profiled: bool


@dataclass
class Kept:
    label: str
    image: np.ndarray
    scale: float
    samples: int


@dataclass
class Outcome:
    units: list = field(default_factory=list)
    kept: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    t0: float = 0.0
    t1: float = 0.0
    error: str = ""

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Keeper:
    """The answers kept for the check: a seeded reservoir of ``k`` over
    all answers, the forced ones, and the last."""

    def __init__(self, seed: int, k: int, forced=()):
        self.rng = substream(seed, 2)
        self.k, self.forced = k, set(forced)
        self.pool, self.fixed, self.seen = [], [], 0
        self.last = None

    def offer(self, kept: Kept) -> None:
        i = self.seen
        self.seen += 1
        self.last = kept
        if i in self.forced:
            self.fixed.append(kept)
        elif len(self.pool) < self.k:
            self.pool.append(kept)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.pool[j] = kept

    def answers(self) -> list:
        out = self.fixed + self.pool
        if self.last is not None and all(a is not self.last for a in out):
            out.append(self.last)
        return out


class _Window:
    """The measured window's clock and the profiled sub-window in it."""

    def __init__(self, seconds: float, mix: dict, spans, profiler):
        self.seconds, self.spans, self.profiler = seconds, spans, profiler
        self.p0 = PROFILE_START * seconds
        self.p1 = self.p0 + mix["profile_seconds"]
        self.t0 = time.perf_counter()

    def more(self) -> bool:
        """At a call boundary: whether the window goes on (starting or
        stopping the profiled sub-window there)."""
        el = time.perf_counter() - self.t0
        prof, on = self.profiler, self.spans.profiling
        if prof is not None:
            if not on and prof.trace is None and el >= self.p0:
                prof.start()
                self.spans.profiling = True
            elif on and (el >= self.p1 or el >= self.seconds):
                self.close_profile()
        return el < self.seconds

    def close_profile(self) -> None:
        if self.spans.profiling:
            self.profiler.stop()
            self.spans.profiling = False


def progressive_batches(mix: dict, seconds: float) -> int:
    """The batch count a progressive image is given: more than the window
    can render at ``batches_per_second_cap``."""
    return int(math.ceil(mix["batches_per_second_cap"] * seconds)) + 64


def chunk_of(mix: dict, renderer) -> int:
    if mix["chunk"] == "auto":
        return renderer.chunk_size()
    return int(mix["chunk"])


def warm_up(mix: dict, renderer, batches: int) -> None:
    """Set-up's run of every call shape the window will make: a chunk,
    a whole image's last short chunk, and the readback."""
    chunk = chunk_of(mix, renderer)
    renderer.render_batches(chunk)
    rest = batches % chunk
    if mix["renderer_per_image"] and rest:
        renderer.render_batches(rest)
    renderer.image()


def drive(mix: dict, make_renderer, renderer, *, offset: int, batches: int,
          spp: int, pixels: int, seconds: float, seed: int, spans,
          profiler=None, sync=lambda: None) -> Outcome:
    """Drive the window.  ``make_renderer()`` makes a Renderer at batch
    ``offset``; ``renderer`` is set-up's (the progressive image goes on
    from it); ``batches`` the batches of a whole image; ``spp`` a
    pixel's samples a batch, ``pixels`` the frame's."""
    spp_frame = spp * pixels
    out = Outcome()
    forced = ()
    if not mix["renderer_per_image"]:
        forced = (int(substream(seed, 3).integers(0, EARLY + 1)),)
    keep = _Keeper(seed, KEEP, forced)
    win = _Window(seconds, mix, spans, profiler)
    out.t0 = win.t0

    def call(r, k):
        rays0 = r.stats.rays_traced
        with spans.span("chunk" if mix["renderer_per_image"] else "step"):
            got = r.render_batches(k)
        out.units.append(Unit(got, got * spp_frame,
                              r.stats.rays_traced - rays0, spans.profiling))
        return got

    try:
        if mix["renderer_per_image"]:
            while win.more():
                with spans.span("renderer_init"):
                    r = make_renderer()
                    sync()
                done = 0
                chunk = chunk_of(mix, r)
                while done < batches and win.more():
                    done += call(r, min(chunk, batches - done))
                if done == batches:
                    out.attempted += 1
                    with spans.span("readback"):
                        img = r.image()
                    keep.offer(Kept(f"image {keep.seen}", img,
                                    (offset + batches) / batches,
                                    batches * spp))
        else:
            r = renderer
            chunk = chunk_of(mix, r)
            while win.more():
                out.attempted += 1
                with spans.span("refresh"):
                    if call(r, chunk) == 0:
                        raise RuntimeError(
                            "the progressive image ran out of batches")
                    with spans.span("readback"):
                        img = r.image()
                held = r.current_batch - offset
                keep.offer(Kept(f"refresh {keep.seen}", img,
                                (offset + held) / held, held * spp))
    except Exception as exc:  # the program failed: counted, and reported
        out.failed += 1
        out.error = f"{type(exc).__name__}: {exc}"
    out.t1 = time.perf_counter()
    if profiler is not None:
        win.close_profile()
    out.kept = keep.answers()
    return out
