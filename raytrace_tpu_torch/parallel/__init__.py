"""Multi-device rendering over torch.distributed (counterpart of
raytrace_tpu/parallel): image rows over "px", each pixel's samples over
"sp" and the scene's primitives over "sc", one process a rank."""

from .multichip import MultiChipRenderer, make_layout

__all__ = ["MultiChipRenderer", "make_layout"]
