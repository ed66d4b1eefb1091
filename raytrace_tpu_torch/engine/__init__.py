"""The render engine: device scene arrays, the wavefront loop, Renderer."""

from .renderer import Renderer, RenderStats

__all__ = ["Renderer", "RenderStats"]
