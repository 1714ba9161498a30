"""peak_device_gb: ``torch.cuda.max_memory_allocated`` over the window,
the largest over the cell's cards, in GB (1e9 bytes)."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
