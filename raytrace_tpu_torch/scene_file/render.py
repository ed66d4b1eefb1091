"""Render settings schema (reference: scene_file/src/render.rs:5-11)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Render:
    camera: str
    samples_per_pixel: int
    sample_batches: int
    max_ray_depth: int
    aspect_ratio: float

    def to_json(self):
        return {
            "camera": self.camera,
            "samples_per_pixel": self.samples_per_pixel,
            "sample_batches": self.sample_batches,
            "max_ray_depth": self.max_ray_depth,
            "aspect_ratio": self.aspect_ratio,
        }

    @staticmethod
    def from_json(data) -> "Render":
        return Render(
            camera=data["camera"],
            samples_per_pixel=int(data["samples_per_pixel"]),
            sample_batches=int(data["sample_batches"]),
            max_ray_depth=int(data["max_ray_depth"]),
            aspect_ratio=float(data["aspect_ratio"]),
        )
