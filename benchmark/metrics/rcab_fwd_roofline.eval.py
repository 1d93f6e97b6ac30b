"""The residual blocks' forward against its roofline, in an evaluated
image (device trace): as ``rcab_fwd_roofline.train`` at the evaluation's
launch shape."""

from benchmark.layers import block_roofline
from benchmark.roofline import rcab_forward_work


def read(run):
    return block_roofline(run, "eval", lambda n: n == "bench.block", rcab_forward_work)
