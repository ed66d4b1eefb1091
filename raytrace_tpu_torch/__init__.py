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
- ``scene_file``, ``models``, ``tools.chacha``, ``utils.image``: the
              numpy host layers (scene JSON schema, ``compile_scene``,
              the host RNG, PNG output), copies of the JAX package's
              modules of the same names, held to them by
              ``tests/test_torch_host_layers.py``.

The port imports nothing of the JAX package.  Everything here takes an
explicit ``device``; the per-ray PCG state tensor is the only source of
randomness.
"""

__version__ = "0.1.0"
