"""Host-to-device copies in the device trace: their bytes over their
device time, in GB/s."""


def read(run):
    t = run.trace
    if not t or t["htod_s"] <= 0 or t["htod_bytes"] <= 0:
        return None
    return t["htod_bytes"] / t["htod_s"] / 1e9
