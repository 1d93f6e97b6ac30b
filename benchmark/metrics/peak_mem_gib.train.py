"""The allocator's peak over the timed window, ``max_memory_allocated``
after a reset at the window's start, in GiB (a counter of the program's
allocator)."""

from benchmark.layers import peak_gib


def read(run):
    return peak_gib(run, "train")
