"""Process start to the window's start: imports, the kernel from its cache,
inputs, the warm-up jobs."""


def read(run, name):
    return run.setup_s
