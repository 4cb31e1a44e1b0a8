"""peak_device_gib: the allocator's peak over the window, data included
(torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""


def read(reading):
    if not reading.peak_window_bytes:
        return None
    return reading.peak_window_bytes / 2 ** 30
