"""SimCLR-style colour distortion, batched.

Port of ``rumpy_tpu/ops/color_aug.py``: torchvision's
``ColorJitter(0.8s, 0.8s, 0.8s, 0.2s)`` under ``RandomApply(p=0.8)``,
then ``RandomGrayscale(p=0.2)``, with per-image draws: brightness,
contrast, saturation and hue factors, one of the 24 orders of the four
jitter ops, and the two flags. :func:`apply_colour_distortion` takes the
draws as arguments and runs the whole (N, H, W, 3) batch with masks and
gathers, no loop over images: each of the four steps computes the four
ops and keeps, per image, the one its order names.
"""

from __future__ import annotations

import functools
from itertools import permutations

import torch

from rumpy_tpu_torch.device import true_div

_GRAY_W = (0.2989, 0.587, 0.114)


@functools.lru_cache(maxsize=8)
def _perms(device: torch.device) -> torch.Tensor:
    """The 24 orders of the four jitter ops, (24, 4), on ``device``."""
    return torch.tensor(list(permutations(range(4))), dtype=torch.int64, device=device)


def _gray(img):
    return (img[..., 0] * _GRAY_W[0] + img[..., 1] * _GRAY_W[1]
            + img[..., 2] * _GRAY_W[2])[..., None]


def _per_image(f):
    return f[:, None, None, None]


def _brightness(img, f):
    return (img * _per_image(f)).clamp(0.0, 1.0)


def _contrast(img, f):
    mean = _gray(img).mean(dim=(1, 2, 3), keepdim=True)
    f = _per_image(f)
    return (f * img + (1.0 - f) * mean).clamp(0.0, 1.0)


def _saturation(img, f):
    f = _per_image(f)
    return (f * img + (1.0 - f) * _gray(img)).clamp(0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(dim=-1)
    mn = img.amin(dim=-1)
    d = mx - mn
    safe = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d > 0, true_div(h, 6.0), torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _hue(img, shift):
    h, s, v = _rgb_to_hsv(img.clamp(0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + shift[:, None, None], 1.0), s, v)


def apply_colour_distortion(images: torch.Tensor, factors: torch.Tensor,
                            perm_idx: torch.Tensor, apply_jitter: torch.Tensor,
                            apply_gray: torch.Tensor) -> torch.Tensor:
    """images (N, H, W, 3) float in [0, 1]; factors (N, 4) = [brightness,
    contrast, saturation, hue shift]; perm_idx (N,) in 0..23; apply_jitter
    and apply_gray (N,) bool."""
    img = images.to(torch.float32)
    order = _perms(img.device)[perm_idx]  # (N, 4)
    jittered = img
    for step in range(4):
        op = _per_image(order[:, step])
        candidates = (_brightness(jittered, factors[:, 0]),
                      _contrast(jittered, factors[:, 1]),
                      _saturation(jittered, factors[:, 2]),
                      _hue(jittered, factors[:, 3]))
        out = candidates[3]
        for k in (2, 1, 0):
            out = torch.where(op == k, candidates[k], out)
        jittered = out
    out = torch.where(_per_image(apply_jitter), jittered, img)
    return torch.where(_per_image(apply_gray), _gray(out).expand_as(out), out)


def colour_distortion_draws(generator: torch.Generator, n: int,
                            dist_strength: float = 1.0):
    """Per-image draws of :func:`colour_distortion` on the generator's
    device: (factors, perm_idx, apply_jitter, apply_gray)."""
    b = 0.8 * dist_strength
    hmax = 0.2 * dist_strength
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)

    factors = torch.stack([uniform(max(0.0, 1 - b), 1 + b),
                           uniform(max(0.0, 1 - b), 1 + b),
                           uniform(max(0.0, 1 - b), 1 + b),
                           uniform(-hmax, hmax)], dim=1)
    u = torch.rand((n, 3), generator=generator, device=dev)
    return factors, (u[:, 0] * 24).to(torch.int64), u[:, 1] < 0.8, u[:, 2] < 0.2


def colour_distortion(generator: torch.Generator, images: torch.Tensor,
                      dist_strength: float = 1.0) -> torch.Tensor:
    """images: (N, H, W, 3) float [0, 1]; independent draws per image."""
    draws = colour_distortion_draws(generator, images.shape[0], dist_strength)
    return apply_colour_distortion(images, *draws)
