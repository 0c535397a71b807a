"""The allocator's peak of device memory over the window (MiB):
``torch.cuda.max_memory_allocated()`` after a reset at the window's
start."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**20
