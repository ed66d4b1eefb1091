"""msamples_per_s (Msamples/s): pixel-samples of every call finished in
the measured window (whole images or not) over the window's seconds,
from the first call's start to the last call's end.  Host clock; every
call ends in the program's synchronize or a copy to the host."""


def read(run):
    out = run.outcome
    if out.seconds <= 0.0:
        return None
    return sum(u.samples for u in out.units) / out.seconds / 1e6
