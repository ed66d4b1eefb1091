"""TRS transform decomposition and interpolation
(reference: raytracer/src/decomposed_transform.rs).

Motion blur interpolates rigid motion correctly by decomposing each
object-to-world matrix into translation / rotation-quaternion / scale and
interpolating the parts (translation & scale lerp, rotation slerp,
decomposed_transform.rs:17-24), then recombining as T·R·S.

Host (numpy) versions live here; the device-side per-batch interpolation in
``raytrace_tpu/ops/transforms.py`` uses the same math in jax.numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DecomposedTransform:
    translation: np.ndarray  # [3]
    rotation: np.ndarray     # [4] quaternion (x, y, z, w), unit
    scale: np.ndarray        # [3]

    def lerp(self, other: "DecomposedTransform", t: float) -> "DecomposedTransform":
        return DecomposedTransform(
            translation=(1 - t) * self.translation + t * other.translation,
            rotation=quat_slerp(self.rotation, other.rotation, t),
            scale=(1 - t) * self.scale + t * other.scale,
        )

    def to_matrix(self) -> np.ndarray:
        return trs_to_matrix(self.translation, self.rotation, self.scale)


def quat_from_mat3(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (rows = basis-vector components, i.e. standard
    row-major m @ v) to quaternion (x, y, z, w).  Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float64)
    return q / np.linalg.norm(q)


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Spherical lerp with shortest-path sign flip and nlerp fallback for
    nearly-parallel quaternions (glam Quat::slerp semantics)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    dot = float(np.dot(a, b))
    if dot < 0.0:
        b = -b
        dot = -dot
    if dot > 0.9995:
        out = a + t * (b - a)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b


def trs_to_matrix(translation, rotation, scale) -> np.ndarray:
    """4x4 = T · R · S (glam Mat4::from_scale_rotation_translation)."""
    m = np.eye(4, dtype=np.float64)
    r = quat_to_mat3(np.asarray(rotation, dtype=np.float64))
    m[:3, :3] = r * np.asarray(scale, dtype=np.float64)[None, :]
    m[:3, 3] = translation
    return m


def decompose_matrix(m: np.ndarray) -> DecomposedTransform:
    """Mat4 → TRS (decomposed_transform.rs:67-96): translation = last column,
    scale = column lengths, rotation from the scale-normalized 3x3."""
    m = np.asarray(m, dtype=np.float64)
    translation = m[:3, 3].copy()
    scale = np.array(
        [np.linalg.norm(m[:3, 0]), np.linalg.norm(m[:3, 1]), np.linalg.norm(m[:3, 2])]
    )
    rot = np.stack([m[:3, i] / scale[i] for i in range(3)], axis=1)
    rotation = quat_from_mat3(rot)
    return DecomposedTransform(translation=translation, rotation=rotation, scale=scale)
