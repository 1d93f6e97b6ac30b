"""The basic SISR family: SRCNN and VDSR.

Port of ``rumpy_tpu/models/basic.py``. Both take the Y channel of an LR
image interpolated to the HR size beforehand (``im_input = "interp"``,
``colorspace = "ycbcr"``: the data layer and ``interface.py::net_run`` do
both) and train with MSE; VDSR adds the input back (a global residual) and
clips the gradients' global norm at 0.1. Every conv pads k // 2 ('SAME' at
stride 1: 4 on each side for SRCNN's 9 x 9), cuDNN.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import Conv
from rumpy_tpu_torch.registry import register_model


class ConvStack(nn.Module):
    """Conv -> ReLU stack (SRCNN), no ReLU after the last conv;
    ``residual`` adds the input back (VDSR)."""

    def __init__(self, kernel_pattern: Sequence[int] = (9, 5, 5),
                 channel_pattern: Sequence[int] = (1, 64, 32, 1), residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual = residual
        self.convs = nn.ModuleList(
            Conv(c_in, c_out, k, dtype=dtype)
            for k, c_in, c_out in zip(kernel_pattern, channel_pattern[:-1], channel_pattern[1:]))

    def flax_children(self):
        return [(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]

    def forward(self, x):
        inp = x
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != last:
                x = torch.relu(x)
        return x + inp if self.residual else x


@register_model("srcnn")
class SRCNNHandler(BaseHandler):
    loss_type = "mse"
    colorspace = "ycbcr"
    im_input = "interp"

    def __init__(self, kernel_pattern=None, channel_pattern=None, **kwargs):
        kwargs.setdefault("in_features", 1)
        super().__init__(kernel_pattern=tuple(kernel_pattern or (9, 5, 5)),
                         channel_pattern=tuple(channel_pattern or (1, 64, 32, 1)), **kwargs)

    def build_module(self, kernel_pattern, channel_pattern):
        return ConvStack(kernel_pattern, channel_pattern, residual=False, dtype=self.dtype)


@register_model("vdsr")
class VDSRHandler(BaseHandler):
    loss_type = "mse"
    colorspace = "ycbcr"
    im_input = "interp"

    def __init__(self, kernel_pattern=None, channel_pattern=None,
                 grad_clip: Optional[float] = 0.1, **kwargs):
        kwargs.setdefault("in_features", 1)
        super().__init__(kernel_pattern=tuple(kernel_pattern or (3,) * 20),
                         channel_pattern=tuple(channel_pattern or (1,) + (64,) * 19 + (1,)),
                         grad_clip=grad_clip, **kwargs)

    def build_module(self, kernel_pattern, channel_pattern):
        return ConvStack(kernel_pattern, channel_pattern, residual=True, dtype=self.dtype)
