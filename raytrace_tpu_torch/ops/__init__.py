"""Per-ray math on tensors (counterparts of ``raytrace_tpu.ops``)."""
