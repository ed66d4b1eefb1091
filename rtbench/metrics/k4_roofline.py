"""k4_roofline (%): the least time of the work K4 did in the profiled
sub-window (work.py: the larger of its FP32 operations over the FP32
peak and its bytes over the HBM peak, counted from the scene, the
samples and the rays traced, never from K4's tree or walk) over K4's
device time there.  torch.profiler (CUPTI) for the time."""

from rtbench.work import least_seconds

K4 = "megakernel"


def read(run):
    if run.trace is None:
        return None
    units = run.units(profiled=True)
    k4 = run.trace.kernel_s(K4)
    if not units or k4 <= 0.0:
        return None
    least = least_seconds(run.facts, sum(u.samples for u in units),
                          sum(u.rays for u in units),
                          sum(u.batches for u in units))
    return 100.0 * least / k4
