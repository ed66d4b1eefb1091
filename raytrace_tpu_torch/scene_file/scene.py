"""SceneFile root object (reference: scene_file/src/lib.rs:26-95).

Load/save JSON, resolve relative image paths against the scene directory
(lib.rs:58-62), enforce render limits (spp <= 64, batches <= 32,
lib.rs:64-79) and warn on duplicate texture names (lib.rs:82-95).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List

from ._tagged import SceneError
from .camera import PerspectiveCamera, camera_from_json
from .instance import Instance
from .material import Material, material_from_json
from .primitive import Primitive, primitive_from_json, adjust_primitive_relative_path
from .render import Render
from .sky import Sky, sky_from_json
from .texture import (
    Texture,
    adjust_relative_path,
    texture_from_json,
    validate_texture,
)

log = logging.getLogger(__name__)

MAX_SAMPLES_PER_PIXEL = 64
MAX_SAMPLE_BATCHES = 32


@dataclass
class SceneFile:
    cameras: List[PerspectiveCamera] = field(default_factory=list)
    textures: List[Texture] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    primitives: List[Primitive] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    sky: Sky = None
    render: Render = None

    # ---------------------------------------------------------------- io

    @staticmethod
    def from_json_dict(data: dict) -> "SceneFile":
        try:
            return SceneFile(
                cameras=[camera_from_json(c) for c in data["cameras"]],
                textures=[texture_from_json(t) for t in data["textures"]],
                materials=[material_from_json(m) for m in data["materials"]],
                primitives=[primitive_from_json(p) for p in data["primitives"]],
                instances=[Instance.from_json(i) for i in data["instances"]],
                sky=sky_from_json(data["sky"]),
                render=Render.from_json(data["render"]),
            )
        except KeyError as e:
            raise SceneError(f"scene file missing required section: {e}") from e

    def to_json_dict(self) -> dict:
        return {
            "cameras": [c.to_json() for c in self.cameras],
            "textures": [t.to_json() for t in self.textures],
            "materials": [m.to_json() for m in self.materials],
            "primitives": [p.to_json() for p in self.primitives],
            "instances": [i.to_json() for i in self.instances],
            "sky": self.sky.to_json(),
            "render": self.render.to_json(),
        }

    @staticmethod
    def load_json(path: str) -> "SceneFile":
        try:
            with open(path, "r") as f:
                data = json.load(f)
        except json.JSONDecodeError as e:
            raise SceneError(f"Unable to parse scene file '{path}': {e}") from e
        scene = SceneFile.from_json_dict(data)
        relative_to = os.path.dirname(os.path.abspath(path))
        scene.adjust_relative_paths(relative_to)
        scene.enforce_render_limits()
        return scene

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)

    # ------------------------------------------------------------- fixups

    def adjust_relative_paths(self, relative_to: str) -> None:
        for tex in self.textures:
            adjust_relative_path(tex, relative_to)
        for prim in self.primitives:
            adjust_primitive_relative_path(prim, relative_to)

    def enforce_render_limits(self) -> None:
        if self.render.samples_per_pixel > MAX_SAMPLES_PER_PIXEL:
            log.info(
                "Samples per pixel %d too high. Limiting to %d.",
                self.render.samples_per_pixel, MAX_SAMPLES_PER_PIXEL,
            )
            self.render.samples_per_pixel = MAX_SAMPLES_PER_PIXEL
        if self.render.sample_batches > MAX_SAMPLE_BATCHES:
            log.info(
                "Sample batches %d too high. Limiting to %d.",
                self.render.sample_batches, MAX_SAMPLE_BATCHES,
            )
            self.render.sample_batches = MAX_SAMPLE_BATCHES

    # ------------------------------------------------------------ queries

    def get_textures(self) -> Dict[str, Texture]:
        """Unique-name texture map; duplicate names keep the first occurrence
        with a warning (lib.rs:82-95)."""
        out: Dict[str, Texture] = {}
        for tex in self.textures:
            if tex.name in out:
                log.warning("Texture name '%s' is used multiple times", tex.name)
            else:
                out[tex.name] = tex
        return out

    def validate(self) -> None:
        all_textures = self.get_textures()
        for tex in self.textures:
            validate_texture(tex, all_textures)

    def get_camera(self, name: str) -> PerspectiveCamera:
        for cam in self.cameras:
            if cam.name == name:
                return cam
        raise SceneError(f"Camera {name} not found")
