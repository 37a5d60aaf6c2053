"""peak_gb (GB, read by the host from the allocator): torch.cuda.max_memory_allocated
over the window, its counter reset after set-up."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 1e9
