"""How ``correct`` is decided: the program's images against the
configuration's plain reference (reference/pathtracer.py unless the
configuration names another, ``core.reference_of``), on pixels drawn
from the seed.

An answer is an image the timed path produced (a finished render, or a
preview's running mean) with the number n of samples a pixel behind it.
The reference traces S stratified samples of each drawn pixel in
float64 and gives each pixel's mean mu and the mean within-cell variance
v of one sample.  A correct image's pixel x is then a draw whose error
x - mu has mean 0 and variance v (1/n + 1/S), whatever the pixel.  Over
the drawn pixels p and channels c the numbers compared are:

- ``noise_ratio``: sum (x - mu)^2 / sum v (1/n + 1/S), near 1 for a
  correct image; a biased image reads above it, and so does one made of
  fewer samples than it claims (about 2 with half of them);
- ``bias_z``: |sum (x - mu)| / sqrt(sum v (1/n + 1/S)), the signed
  errors' sum in standard deviations, about |N(0, 1)| for a correct
  image; it finds a small bias that is the same across pixels;
- ``bad_values``: the values of the whole image that are not finite or
  are negative (radiance is neither), with the limit 0.

Each number is the worst over the answers checked; the limits are the
configuration's (its ``check``), set from readings of the program and of
the control (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUMBERS = ("noise_ratio", "bias_z", "bad_values")


def substream(seed: int, tag: int) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64,
                                                         tag]))


def draw_pixels(seed: int, width: int, height: int, count: int):
    """(px, py): ``count`` distinct pixels of the frame (all of them for
    a smaller frame), drawn from the seed."""
    n = width * height
    flat = np.sort(substream(seed, 1).choice(n, size=min(count, n),
                                             replace=False))
    return flat % width, flat // width


@dataclass
class Answer:
    label: str
    values: np.ndarray  # [P, 3] the image at the drawn pixels, a mean
    samples: int        # n: samples a pixel behind it
    bad: int            # non-finite or negative values of the whole image


def answer(label: str, image: np.ndarray, scale: float, samples: int,
           px, py) -> Answer:
    """An answer from a host image [H, W, 3] whose mean over its samples
    is ``image * scale``."""
    bad = int(np.count_nonzero(~np.isfinite(image)) + np.count_nonzero(
        image < 0.0))
    return Answer(label, image[py, px].astype(np.float64) * scale, samples,
                  bad)


def numbers(ans: Answer, mean: np.ndarray, var: np.ndarray,
            ref_samples: int) -> dict:
    err = ans.values - mean
    expected = float((var * (1.0 / ans.samples + 1.0 / ref_samples)).sum())
    finite = np.isfinite(err).all()
    if not finite or expected <= 0.0:
        return {"noise_ratio": float("inf"), "bias_z": float("inf"),
                "bad_values": ans.bad}
    return {"noise_ratio": float((err * err).sum() / expected),
            "bias_z": float(abs(err.sum()) / np.sqrt(expected)),
            "bad_values": ans.bad}


def judge(answers, mean, var, ref_samples: int, limits: dict):
    """(correct, {number: {"value": worst, "limit": limit}}).  With no
    answer there is nothing to vouch for: not correct."""
    worst = {k: 0.0 for k in NUMBERS}
    for ans in answers:
        for k, v in numbers(ans, mean, var, ref_samples).items():
            worst[k] = max(worst[k], v)
    if not answers:
        worst = {k: float("inf") for k in NUMBERS}
    table = {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}
    return all(worst[k] <= limits[k] for k in NUMBERS), table
