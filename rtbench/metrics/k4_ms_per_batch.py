"""k4_ms_per_batch (ms): the device time of the fused bounce kernel K4
(kernels named ``megakernel``: ops/megakernel.py -> csrc/megakernel.cu)
in the profiled sub-window, over the batches its calls rendered.
torch.profiler (CUPTI)."""

K4 = "megakernel"


def read(run):
    if run.trace is None:
        return None
    batches = sum(u.batches for u in run.units(profiled=True))
    k4 = run.trace.kernel_s(K4)
    return 1e3 * k4 / batches if batches and k4 > 0.0 else None
