"""The whole evaluation's share of the card's peak: the forward FLOPs of
every image of the timed window over the window's seconds times 989
TFLOP/s (bf16, dense, H100 SXM at 700 W), in percent (host clock)."""

from benchmark.layers import mfu


def read(run):
    return mfu(run, "eval")
