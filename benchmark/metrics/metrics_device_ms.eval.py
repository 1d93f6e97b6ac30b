"""Device ms an image of the operations launched inside the benchmark's
range around the Y conversion, PSNR, SSIM and their fetch (device
trace)."""

from benchmark.layers import range_device_ms


def read(run):
    return range_device_ms(run, "eval", "bench.metrics")
