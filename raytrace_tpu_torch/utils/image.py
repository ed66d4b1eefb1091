"""Image IO and colour conversion.

The reference never persisted images at all (its blit pass converts the
linear accumulation buffer to the sRGB swapchain, fragment.glsl:8-12); here
the same linear→sRGB transfer function (common.glsl:400-412) feeds a PNG
writer — a strict capability upgrade.
"""

from __future__ import annotations

import numpy as np


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    """Piecewise sRGB OETF on clamped linear RGB (common.glsl:401-407)."""
    x = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    lower = x * 12.92
    higher = 1.055 * np.power(x, 1.0 / 2.4, where=x > 0, out=np.zeros_like(x)) - 0.055
    return np.where(x < 0.0031308, lower, higher)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """Inverse transfer (common.glsl:415-421)."""
    x = np.clip(np.asarray(srgb, np.float32), 0.0, 1.0)
    lower = x / 12.92
    higher = np.power((x + 0.055) / 1.055, 2.4)
    return np.where(x < 0.04045, lower, higher)


def to_srgb_u8(linear: np.ndarray) -> np.ndarray:
    return np.round(linear_to_srgb(linear) * 255.0).astype(np.uint8)


def write_png(path: str, linear_rgb: np.ndarray) -> None:
    """Write a linear-light [H,W,3] float image as an sRGB PNG."""
    from PIL import Image

    Image.fromarray(to_srgb_u8(linear_rgb), mode="RGB").save(path)


def read_png_linear(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        srgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(srgb)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
