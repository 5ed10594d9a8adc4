"""The traced window's peak of allocated device memory on the fullest
card (``max_memory_allocated`` after ``reset_peak_memory_stats``), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
