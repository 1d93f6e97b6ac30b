"""The residual blocks' backward against its roofline (device trace).
The block's backward device time is that of the operations launched
inside the autograd node of the block's fused call, named below (the
port's ``ops/cuda/rcab_fused.py::_RCABFunction``); its work is four
conv-sized products, the data and weight gradients of both convs (a
recompute of conv1 is not counted), at the launch shape
(``roofline.rcab_backward_work``)."""

from benchmark.layers import block_roofline
from benchmark.roofline import rcab_backward_work

BACKWARD_NODES = ("_RCABFunctionBackward",)


def read(run):
    return block_roofline(run, "train", lambda n: any(b in n for b in BACKWARD_NODES),
                          rcab_backward_work)
