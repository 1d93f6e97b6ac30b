"""Everything a run makes from ``--seed``: weights, HR crops, the chain's
seed, the evaluation pool and the sample of images that are checked.

Each use draws from its own stream, a generator seeded with
``stream_seed(seed, stream)`` on the run's device, in a few large calls.
The program and the reference get the same values from the same seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

WEIGHTS, CROPS, CHAIN, POOL, SAMPLE = range(5)


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def weights(shapes: dict, seed: int, device) -> dict:
    """A float32 state dict for ``shapes`` ({name: shape}) from one normal
    draw: conv and dense weights N(0, 1 / (3 fan_in)) (the variance of
    torch's U(+-1/sqrt(fan_in))), biases N(0, 0.01^2), BatchNorm scales
    1 + N(0, 0.1^2), BatchNorm biases and running means N(0, 0.1^2),
    running variances 1 + |N(0, 0.1^2)|."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, WEIGHTS), device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        v = flat[at:at + size].view(shapes[name])
        at += size
        if name.endswith("running_var"):
            v = 1.0 + 0.1 * v.abs()
        elif name.endswith("running_mean") or (".norms." in name and name.endswith(".bias")):
            v = 0.1 * v
        elif name.endswith(".scale"):
            v = 1.0 + 0.1 * v
        elif len(shapes[name]) >= 2:
            v = v / math.sqrt(3.0 * math.prod(shapes[name][1:]))
        else:
            v = 0.01 * v
        out[name] = v.contiguous()
    return out


def hr_crops(g: torch.Generator, batch: int, side: int) -> torch.Tensor:
    """(batch, side, side, 3) float32 HR crops in [0, 1]: smooth colour
    fields (bilinear from 1/8 of the side) with a fine grain on top, each
    crop at its own brightness (0.1 to 0.9) and contrast (0.3 to 1.3), as
    crops of photographs differ."""
    low = torch.rand(batch, 3, side // 8, side // 8, generator=g, device=g.device)
    level = torch.rand(batch, 2, generator=g, device=g.device)
    x = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
    x = x.permute(0, 2, 3, 1) + 0.03 * torch.randn(batch, side, side, 3, generator=g,
                                                   device=g.device)
    bright, contrast = 0.1 + 0.8 * level[:, 0], 0.3 + level[:, 1]
    x = bright[:, None, None, None] + contrast[:, None, None, None] * (x - 0.5)
    return x.clamp_(0.0, 1.0).contiguous()


def eval_pool(device, seed: int, count: int, hr_sizes, scale: int):
    """``count`` (LR (h, w, 3), HR (H, W, 3)) float32 pairs, the i-th of HR
    size ``hr_sizes[i % len(hr_sizes)]`` ([H, W] each): HR made as
    :func:`hr_crops` makes a crop, LR its ``scale`` x ``scale`` box
    average."""
    g = generator(device, seed, POOL)
    pairs = []
    for i in range(count):
        hh, ww = hr_sizes[i % len(hr_sizes)]
        low = torch.rand(1, 3, -(-hh // 8), -(-ww // 8), generator=g, device=g.device)
        level = torch.rand(2, generator=g, device=g.device)
        x = F.interpolate(low, scale_factor=8, mode="bilinear", align_corners=False)
        x = x[:, :, :hh, :ww] + 0.03 * torch.randn(1, 3, hh, ww, generator=g, device=g.device)
        x = (0.1 + 0.8 * level[0] + (0.3 + level[1]) * (x - 0.5)).clamp_(0.0, 1.0)
        lr = F.avg_pool2d(x, scale)
        pairs.append((lr[0].permute(1, 2, 0).contiguous(), x[0].permute(1, 2, 0).contiguous()))
    return pairs


def pool_order(seed: int, count: int, pool: int):
    """Which pool image the i-th request of the window takes: every image
    of the pool in turn, each round in a seeded order."""
    g = torch.Generator().manual_seed(stream_seed(seed, POOL))
    order = []
    while len(order) < count:
        order += torch.randperm(pool, generator=g).tolist()
    return order[:count]


def sample_positions(seed: int, first: int, how_many: int):
    """``how_many`` distinct request positions among the first ``first``,
    drawn from the seed: the answers that are checked."""
    g = torch.Generator().manual_seed(stream_seed(seed, SAMPLE))
    return sorted(torch.randperm(first, generator=g)[:how_many].tolist())
