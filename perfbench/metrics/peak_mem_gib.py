"""The device memory the run's allocations reached, in GiB (2**30 bytes):
``torch.cuda.max_memory_allocated()`` read by the harness at the window's end, over
the whole run before it (set-up, warm-up and window), before the reference runs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
