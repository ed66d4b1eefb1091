"""Vose alias-table construction for area-proportional light-triangle
sampling (reference: raytracer/src/light.rs:136-194).

Given per-triangle areas, builds (probability, alias) pairs such that
drawing u1, u2 ~ U[0,1), picking slot i = floor(u1 * n) and returning
``i if u2 < probability[i] else alias[i]`` samples triangle i with
probability area_i / total_area.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_alias_table(areas: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Returns (probabilities [n] f32, aliases [n] i32, total_area).

    Follows the exact construction order of light.rs:136-177 (stack-based
    small/large worklists, f64 total accumulation) so tables match the
    reference entry-for-entry.
    """
    areas = np.asarray(areas, dtype=np.float32)
    n = len(areas)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32), 0.0

    total_area = float(np.sum(areas.astype(np.float64)))
    q = (areas * np.float32(n) / np.float32(total_area)).astype(np.float32).tolist()

    small = [i for i, v in enumerate(q) if v < 1.0]
    large = [i for i, v in enumerate(q) if v >= 1.0]

    probabilities = [0.0] * n
    aliases = [0] * n

    while small and large:
        s = small.pop()
        l = large.pop()
        probabilities[s] = q[s]
        aliases[s] = l
        q[l] -= 1.0 - q[s]
        if q[l] < 1.0:
            small.append(l)
        else:
            large.append(l)

    for i in small + large:
        probabilities[i] = 1.0
        aliases[i] = i

    return (
        np.asarray(probabilities, dtype=np.float32),
        np.asarray(aliases, dtype=np.int32),
        total_area,
    )
