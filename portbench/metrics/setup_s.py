"""Process start to the window's start: CUDA and the kernel libraries
loaded, every bank's RAM pool drawn, the warm-up streams, the pinned
slots allocated."""


def read(run):
    return run.setup_s
