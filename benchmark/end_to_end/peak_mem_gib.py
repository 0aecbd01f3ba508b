"""peak_mem_gib: the most device memory the allocator held during the window,
torch.cuda.max_memory_allocated() after reset_peak_memory_stats() at the
window's start, in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30
