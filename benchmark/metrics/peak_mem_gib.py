"""torch.cuda.max_memory_allocated() over the window, in GiB."""


def read(run, name):
    return run.peak_mem_bytes / 2**30 if run.peak_mem_bytes else None
