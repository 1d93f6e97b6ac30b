"""The whole train step's share of the card's peak: the configuration's
model FLOPs of every step of the timed window (the trained parts forward
and backward, three times their forward; a frozen encoder's forward once;
nothing recomputed is counted) over the window's seconds times 989
TFLOP/s (bf16, dense, H100 SXM at 700 W), in percent (host clock)."""

from benchmark.layers import mfu


def read(run):
    return mfu(run, "train")
