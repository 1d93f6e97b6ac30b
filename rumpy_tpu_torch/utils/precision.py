"""Float64 runs of the port's float32 code.

Where float32 rounding would hide a fault (BatchNorm over a few values a
channel, gradients summed over ranks in another order), a step is held
against its reference in float64. The port computes some values in float32
whatever its modules' dtype (BatchNorm's statistics, the losses, a
sigmoid's input: ``Tensor.float()``), so widening a module is not enough:

* :func:`float_as_double` makes every ``Tensor.float()`` float64 inside a
  block, through a torch function mode (the calling thread only, undone on
  exit; nothing global is patched);
* :func:`float64` widens a handler for a block: its module, every
  submodule's ``dtype`` field, its draws (torch's default dtype) and those
  calls.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode


class _FloatAsDouble(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.float:
            return args[0].double(*args[1:], **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def float_as_double():
    """Every ``Tensor.float()`` in the block returns float64."""
    with _FloatAsDouble():
        yield


@contextlib.contextmanager
def float64(handler):
    """``handler`` in float64 inside the block, which receives its state:
    the module and each submodule's ``dtype`` widened for good (its
    optimizer dropped, to be built anew on the float64 parameters), torch's
    default dtype (the handler's draws) float64 and every
    ``Tensor.float()`` float64 until the block ends."""
    handler.module.double()
    for m in handler.module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    handler._optimizer = None
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with _FloatAsDouble():
            yield handler._own_state()
    finally:
        torch.set_default_dtype(default)
