"""The residual blocks' forward against its roofline, in a train step
(device trace). The block's device time is that of the operations
launched inside the benchmark's range around each block module's forward
call (the module classes are the configuration's ``blocks``); its work
is two 3x3 conv products at the launch shape, with x read and the output
written once (``roofline.rcab_forward_work``)."""

from benchmark.layers import block_roofline
from benchmark.roofline import rcab_forward_work


def read(run):
    return block_roofline(run, "train", lambda n: n == "bench.block", rcab_forward_work)
