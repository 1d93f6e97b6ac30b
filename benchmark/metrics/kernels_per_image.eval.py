"""Device kernels an evaluated image (its forward, PSNR, SSIM and fetch),
counted in the traced window (device trace). Layer: the handler, host
side."""

from benchmark.layers import kernels_per_unit


def read(run):
    return kernels_per_unit(run, "eval")
