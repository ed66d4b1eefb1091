"""raytrace_tpu_torch — the wavefront path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``raytrace_tpu`` (JAX/XLA/Pallas), which stays the reference the
port is tested against.  Module names mirror the JAX package so each
counterpart is easy to find:

- ``ops``:    per-ray math on tensors — RNG, camera rays, sphere closest hit
              (plain PyTorch, plus the CUDA sweep kernel in ``csrc/``),
              fat-row shading and the no-light NEE branch; the fused
              bounce kernel (``ops/megakernel.py``, ``csrc/megakernel.cu``)
              and its plain version.
- ``engine``: device scene arrays, the wavefront bounce loop, and the
              progressive ``Renderer`` (fused kernel or wavefront) with
              checkpoint/resume.
- ``cli``:    ``render`` on the command line.

The numpy-only host layers (``raytrace_tpu.scene_file``, ``.models``,
``.tools.chacha``, ``.utils.image``) are imported as they are; none of
them loads JAX.  Everything here takes an explicit ``device``; the per-ray
PCG state tensor is the only source of randomness.
"""

__version__ = "0.1.0"
