"""Contrastive degradation encoders.

Port of the encoder of ``rumpy_tpu/models/contrastive.py``: the DASR
encoder (six 3x3 convs with BatchNorm and LeakyReLU(0.1), global average
pooling, a two-layer projection MLP and an optional dropdown regression
head) and ``_normalize``. The MoCo / SupMoCo / WeakCon / SupCon handlers,
their queues and their joint training are ROADMAP queue 1 item 6b.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.common import BatchNorm, Conv, Linear

# (features, stride) of the six convs
DASR_SPEC = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1))


def _lrelu(v):
    return F.leaky_relu(v, 0.1)


class DASREncoder(nn.Module):
    """DASR encoder on NCHW (channels_last) input. Its stride-2 convs pad
    one pixel on every side, as the JAX package's explicit (1, 1) padding
    does. BatchNorm follows flax (``models/common.py::BatchNorm``): batch
    statistics and a running-stat update with ``train=True``, the running
    statistics otherwise."""

    def __init__(self, dropdown_q: Optional[int] = None, out_dim: int = 256,
                 in_features: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_features,) + tuple(f for f, _ in DASR_SPEC[:-1])
        self.convs = nn.ModuleList(Conv(i, f, 3, dtype=dtype, stride=s)
                                   for i, (f, s) in zip(ins, DASR_SPEC))
        self.norms = nn.ModuleList(BatchNorm(f, dtype=dtype) for f, _ in DASR_SPEC)
        self.mlp = nn.ModuleList([Linear(256, 256, dtype=dtype),
                                  Linear(256, out_dim, dtype=dtype)])
        self.dropdown = (nn.ModuleList([Linear(out_dim, 64, dtype=dtype),
                                        Linear(64, 32, dtype=dtype),
                                        Linear(32, dropdown_q, dtype=dtype)])
                         if dropdown_q is not None else None)

    def forward(self, x, train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns the pooled features (N, 256) and {"q": projection,
        "dropdown_q": the dropdown head's output, if any}."""
        for conv, norm in zip(self.convs, self.norms):
            x = _lrelu(norm(conv(x), train))
        fea = x.mean(dim=(2, 3))
        out = self.mlp[1](_lrelu(self.mlp[0](fea)))
        outputs = {"q": out}
        if self.dropdown is not None:
            d = _lrelu(self.dropdown[0](out))
            d = _lrelu(self.dropdown[1](d))
            outputs["dropdown_q"] = self.dropdown[2](d)
        return fea, outputs


def _normalize(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
