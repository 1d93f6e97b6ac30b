"""Spatial tiling for memory-bounded evaluation of large images.

Port of ``rumpy_tpu/ops/tiling.py``: SAN's ``forward_chop``, a recursive
4-way overlap-tile decomposition of an (N, H, W, C) -> (N, sH, sW, C)
forward. The recursion runs on the host and the tiles run one after
another, so the card holds one tile's activations at a time.
"""

from __future__ import annotations

from typing import Callable

import torch


def forward_chop(forward: Callable, x: torch.Tensor, scale: int, shave: int = 10,
                 max_size: int = 160000, force_split: bool = False) -> torch.Tensor:
    """``forward`` over four overlapping quadrants of NHWC ``x``, each
    chopped again while it holds more than ``max_size`` pixels and
    shaving can still shrink it; each quadrant's valid region is stitched
    into the output. ``force_split`` splits the top level whatever the
    size (SAN's evaluation always tiles); a tile then is at most the
    image, for inputs smaller than the shaved half."""
    n, h, w, c = x.shape
    if not force_split and (h * w <= max_size or h <= 2 * shave + 2 or w <= 2 * shave + 2):
        return forward(x)
    if force_split and (h // 2 == 0 or w // 2 == 0):
        return forward(x)  # nothing to split
    h_half, w_half = h // 2, w // 2
    h_size, w_size = min(h_half + shave, h), min(w_half + shave, w)
    tiles = [x[:, :h_size, :w_size], x[:, :h_size, w - w_size:],
             x[:, h - h_size:, :w_size], x[:, h - h_size:, w - w_size:]]
    outs = [forward_chop(forward, t, scale, shave, max_size) for t in tiles]
    oh, ow = h * scale, w * scale
    oh_half, ow_half = h_half * scale, w_half * scale
    oh_size, ow_size = h_size * scale, w_size * scale
    top, left = oh_size - oh + oh_half, ow_size - ow + ow_half
    out = outs[0].new_zeros((n, oh, ow, c))
    out[:, :oh_half, :ow_half] = outs[0][:, :oh_half, :ow_half]
    out[:, :oh_half, ow_half:] = outs[1][:, :oh_half, left:]
    out[:, oh_half:, :ow_half] = outs[2][:, top:, :ow_half]
    out[:, oh_half:, ow_half:] = outs[3][:, top:, left:]
    return out
