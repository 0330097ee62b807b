"""The compute kernels' share of their roofline: the least time the
chip could take for the window's work (the configuration's work model
times the frames finished: bytes over the memory bandwidth or
operations over the float32 rate, whichever is larger) over the device
time of every compute kernel in the trace (copies and sets excluded)."""

from portbench.peaks import least_seconds


def read(run):
    t = run.trace
    if not t or t["kernel_s"] <= 0 or run.work_bytes <= 0:
        return None
    return 100.0 * least_seconds(run.work_bytes, run.work_flops) / t["kernel_s"]
