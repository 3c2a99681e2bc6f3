"""GiB: the device memory allocated at the peak of the window
(torch.cuda.max_memory_allocated after a reset at its start)."""

from benchmark import readings


def read(ctx):
    return readings.peak_mem_gib(ctx)
