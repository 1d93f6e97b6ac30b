"""Device kernels a train step, counted in the traced window (device
trace). Layer: the handler, host side; fewer kernels a step is less host
work to launch them."""

from benchmark.layers import kernels_per_unit


def read(run):
    return kernels_per_unit(run, "train")
