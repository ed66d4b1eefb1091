"""Dev probes on the card (counterparts of the repository's ``tools_dev/``
probes P1-P3): ``probe_ops`` (op-support probes), ``probe_trig`` (the
sphere-UV trigonometry) and ``micro_raygen`` (K4's raygen alone), each a
CUDA kernel beside its plain PyTorch version, each with a ``main(argv)``
that runs on ``cuda:0`` unless ``--device cpu`` is given."""
