"""Device ms a train step of the operations launched inside the
benchmark's range around the degradation chain (``input_fn``): the
chain's share of the card (device trace)."""

from benchmark.layers import range_device_ms


def read(run):
    return range_device_ms(run, "train", "bench.chain")
