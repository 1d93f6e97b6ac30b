"""The yardstick: the card's peaks, the work of one RCAB call forward and
backward, and a configuration's model FLOPs.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at its 700 W
limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM. A share of a peak is stated
against these, with the card's power limit beside it.
"""

from __future__ import annotations

import functools

import torch

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ELT = {"bf16": 2, "f32": 4}


def conv_flops(n: int, h: int, w: int, c: int) -> int:
    """One 3x3 C -> C convolution, 2 operations a multiply-add."""
    return 2 * n * h * w * c * c * 9


def rcab_forward_work(n: int, h: int, w: int, c: int, dtype: str):
    """(operations, bytes) of one RCAB forward: its two conv products;
    x read once, the output written once, both conv weights read once."""
    e = ELT[dtype]
    return 2 * conv_flops(n, h, w, c), 2 * n * h * w * c * e + 2 * 9 * c * c * e


def rcab_backward_work(n: int, h: int, w: int, c: int, dtype: str):
    """(operations, bytes) of one RCAB backward: the data and weight
    gradients of both convs, four conv-sized products (a recompute of conv1
    is the implementation's and not counted); dout and x read once, dx
    written once, both weights read once and their float32 gradients
    written once."""
    e = ELT[dtype]
    return (4 * conv_flops(n, h, w, c),
            3 * n * h * w * c * e + 2 * 9 * c * c * e + 2 * 9 * c * c * 4)


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


@functools.lru_cache(maxsize=16)
def _forward_flops(reference: str, cfg_items: tuple, n: int, h: int, w: int):
    """(trained, frozen) forward FLOPs of the reference model at (n, h, w),
    counted by ``torch.utils.flop_counter`` on the meta device: convs and
    products only, 2 operations a multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.core import reference_module
    ref = reference_module(reference)
    with torch.device("meta"):
        model = ref.build(dict(cfg_items))
        x = torch.empty(n, 3, h, w)
        with FlopCounterMode(display=False) as total:
            ref.generate(model, x, ref.embed(model, x, False))
        with FlopCounterMode(display=False) as frozen:
            ref.embed(model, x, False)
    return total.get_total_flops() - frozen.get_total_flops(), frozen.get_total_flops()


def model_flops(cfg: dict, n: int, h: int, w: int, train: bool) -> float:
    """The configuration's model FLOPs for a batch of n LR images of h x w:
    the forward; in training the trained parts' forward plus twice it (the
    backward's data and weight gradients) and the frozen parts' forward."""
    sizes = tuple(sorted((k, v) for k, v in cfg.items() if isinstance(v, (int, float))))
    trained, frozen = _forward_flops(cfg["reference"], sizes, n, h, w)
    return (3 * trained if train else trained) + frozen
