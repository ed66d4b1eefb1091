"""Instance & transform schema (reference: scene_file/src/instance.rs).

An instance places a named primitive in the world with an optional transform.
Transforms are stored as T·R·S components (instance.rs:43-54) and may be
``static`` or ``animated`` (a start/end pair lerped over the shutter interval
[0, 1] for motion blur).

JSON shapes:
    {"name": "box1"}
    {"name": "box1", "transform": {"static": {"translate": [..], ...}}}
    {"name": "globe", "transform": {"animated": [{...start...}, {...end...}]}}
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ._tagged import SceneError, dataclass_to_json


@dataclass
class Rotate:
    axis: List[float]
    degrees: float


@dataclass
class Transform:
    translate: Optional[List[float]] = None
    rotate: Optional[Rotate] = None
    scale: Optional[List[float]] = None

    def to_json(self):
        out = {}
        if self.translate is not None:
            out["translate"] = list(self.translate)
        if self.rotate is not None:
            out["rotate"] = {"axis": list(self.rotate.axis), "degrees": self.rotate.degrees}
        if self.scale is not None:
            out["scale"] = list(self.scale)
        return out

    @staticmethod
    def from_json(data) -> "Transform":
        if data is None:
            return Transform()
        rot = None
        if data.get("rotate") is not None:
            r = data["rotate"]
            rot = Rotate(axis=r["axis"], degrees=r["degrees"])
        return Transform(
            translate=data.get("translate"),
            rotate=rot,
            scale=data.get("scale"),
        )

    def to_matrix(self) -> np.ndarray:
        """4x4 object-to-world matrix = T · R · S (instance.rs:43-54)."""
        m = np.eye(4, dtype=np.float64)
        if self.scale is not None:
            s = np.eye(4)
            s[0, 0], s[1, 1], s[2, 2] = self.scale
            m = s
        if self.rotate is not None:
            axis = np.asarray(self.rotate.axis, dtype=np.float64)
            n = np.linalg.norm(axis)
            axis = axis / n if n > 0 else axis * 0.0
            ang = math.radians(self.rotate.degrees)
            c, s_ = math.cos(ang), math.sin(ang)
            x, y, z = axis
            r = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_, x * z * (1 - c) + y * s_, 0],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c), y * z * (1 - c) - x * s_, 0],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_, c + z * z * (1 - c), 0],
                [0, 0, 0, 1],
            ])
            m = r @ m
        if self.translate is not None:
            t = np.eye(4)
            t[:3, 3] = self.translate
            m = t @ m
        return m


@dataclass
class TransformType:
    """Static or animated transform.  ``end`` is None for static transforms."""

    start: Transform
    end: Optional[Transform] = None

    @property
    def is_animated(self) -> bool:
        return self.end is not None

    def to_json(self):
        if self.end is None:
            return {"static": self.start.to_json()}
        return {"animated": [self.start.to_json(), self.end.to_json()]}

    @staticmethod
    def from_json(data) -> "TransformType":
        if not isinstance(data, dict) or len(data) != 1:
            raise SceneError(f"transform: expected tagged object, got {data!r}")
        (tag, body), = data.items()
        if tag == "static":
            return TransformType(start=Transform.from_json(body))
        if tag == "animated":
            if not isinstance(body, list) or len(body) != 2:
                raise SceneError("transform.animated: expected [start, end]")
            return TransformType(
                start=Transform.from_json(body[0]), end=Transform.from_json(body[1])
            )
        raise SceneError(f"transform: unknown variant '{tag}'")


@dataclass
class Instance:
    name: str
    transform: Optional[TransformType] = None

    def to_json(self):
        out = {"name": self.name}
        if self.transform is not None:
            out["transform"] = self.transform.to_json()
        return out

    @staticmethod
    def from_json(data) -> "Instance":
        t = data.get("transform")
        return Instance(
            name=data["name"],
            transform=TransformType.from_json(t) if t is not None else None,
        )

    def object_to_world_matrices(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(start_matrix, end_matrix_or_None); identity when no transform."""
        if self.transform is None:
            return np.eye(4), None
        start = self.transform.start.to_matrix()
        end = self.transform.end.to_matrix() if self.transform.end is not None else None
        return start, end
