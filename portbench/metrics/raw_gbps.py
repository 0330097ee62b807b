"""RAW bytes whose products the port finished inside the window, every
bank summed, over the whole window (first block delivered to the last
product finalized after the sources stopped), in GB/s."""


def read(run):
    return run.raw_bytes / run.window_s / 1e9
