"""The training chain in plain PyTorch: blur, x4 downsample, noise, JPEG.

A frozen copy of the arithmetic and the random draws of the port's device
chain as it stood when the benchmark was written (``rumpy_tpu_torch``'s
``degradations/pipeline.py::ImagePipeline.degrade_batch`` with the ops of
``degradations/{blur,resize_ops,noise,compression}.py`` and
``ops/{blur_kernels,blur,resize,noise,jpeg}.py``, ``utils/color.py``),
restricted to the options the benchmark's traffic uses:

* ``realesrganblur``: a random family of ``kernel_range`` (iso and aniso
  Gaussians) with uniform probabilities, sigma and rotation uniform in
  their ranges, reflect padding, one depthwise float32 correlation;
* ``downsample``: Pillow's antialiased bicubic as two float64 products;
* ``realesrgannoise``: Gaussian (sigma in 0..255 units) or Poisson noise,
  half and half, gray with probability 0.4, clipped to [0, 1];
* ``jpegcompress``: a random quality in ``compression_range``, 4:4:4, the
  float64 8x8 DCT, Annex K tables scaled as libjpeg does, levels rounded.

The draws come from a ``torch.Generator`` in the same order and shapes as
the port's, so one seed gives both the same degradations on one device.
It imports nothing of the port. ``precision="bf16"`` rounds the image to
bfloat16 after every op: the control's chain.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BLUR_DEFAULTS = {"kernel_range": ("iso",), "kernel_size": 21, "sigma_x_range": (0.6, 5.0),
                 "sigma_y_range": (0.6, 5.0), "rotation_range": (-math.pi, math.pi),
                 "betag_range": (0.5, 8.0), "betap_range": (0.5, 8.0),
                 "omega_c_range": (math.pi / 3, math.pi)}
NOISE_DEFAULTS = {"gaussian_poisson_ratio": 0.5, "poisson_noise_scale_range": (0.0, 1.0),
                  "gaussian_noise_sigma_range": (0.0, 1.0), "gray_noise_probability": 0.4}
JPEG_DEFAULTS = {"compression_range": (20, 80), "random_compression": False, "quality": 50}

LUMA_QTABLE = [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
               [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
               [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
               [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99]]
CHROMA_QTABLE = [[17, 18, 24, 47, 99, 99, 99, 99], [18, 21, 26, 66, 99, 99, 99, 99],
                 [24, 26, 56, 99, 99, 99, 99, 99], [47, 66, 99, 99, 99, 99, 99, 99]] \
    + [[99] * 8] * 4
JPG_FWD = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                    [0.5, -0.418688, -0.081312]], dtype=np.float64)


def div(a, b):
    """IEEE division with a Python-number divisor (a CUDA tensor divided by
    a Python number is multiplied by its reciprocal instead)."""
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


# -- blur -------------------------------------------------------------------

def gaussian_kernels(ks, sx, sy, theta):
    ax = torch.arange(ks, dtype=torch.float32, device=sx.device) - float(ks // 2)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    c, s = torch.cos(theta), torch.sin(theta)
    isx, isy = 1.0 / (sx ** 2), 1.0 / (sy ** 2)
    a = (c * c * isx + s * s * isy)[:, None, None]
    b = (c * s * (isx - isy))[:, None, None]
    d = (s * s * isx + c * c * isy)[:, None, None]
    k = torch.exp(-0.5 * (a * xx * xx + 2 * b * xx * yy + d * yy * yy))
    return k / k.sum(dim=(-2, -1), keepdim=True)


def blur(g, x, cfg):
    p = {**BLUR_DEFAULTS, **cfg}
    names = tuple(p["kernel_range"])
    if set(names) - {"iso", "aniso"} or p.get("kernel_probabilities"):
        raise NotImplementedError(f"reference blur: {names}")
    n = x.shape[0]
    probs = np.asarray([1.0 / len(names)] * len(names), np.float64)
    cum = torch.as_tensor(np.cumsum(probs / probs.sum()).astype(np.float32), device=g.device)
    u = torch.rand(n, generator=g, device=g.device)
    family = torch.searchsorted(cum, cum[-1] * (1.0 - u)).clamp_(max=len(names) - 1)
    sx = uniform(g, n, *p["sigma_x_range"])
    sy = uniform(g, n, *p["sigma_y_range"])
    rot = uniform(g, n, *p["rotation_range"])
    for rng in (p["betag_range"], p["betap_range"]):  # drawn, unused by Gaussians
        uniform(g, n, rng[0], 1.0), uniform(g, n, 1.0, rng[1])
        torch.rand(n, generator=g, device=g.device)
    uniform(g, n, *p["omega_c_range"])
    zeros = torch.zeros_like(rot)
    ks = p["kernel_size"]
    fams = [gaussian_kernels(ks, sx, sx, zeros) if name == "iso"
            else gaussian_kernels(ks, sx, sy, rot) for name in names]
    kernels = torch.take_along_dim(torch.stack(fams), family.view(1, -1, 1, 1), dim=0)[0]
    b, h, w, c = x.shape
    pad = ks // 2
    xc = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w), (pad,) * 4, mode="reflect")
    weight = kernels.to(x.dtype)[:, None].expand(b, c, ks, ks).reshape(b * c, 1, ks, ks)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(xc, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


# -- downsample ---------------------------------------------------------------

def bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def resize_matrix(n_in, n_out):
    """Pillow's antialiased bicubic coefficients, rows normalised, as
    float32 values held in float64."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    ss = 1.0 / fs
    m = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        centre = (o + 0.5) * scale
        lo, hi = max(int(centre - support + 0.5), 0), min(int(centre + support + 0.5), n_in)
        xs = np.arange(lo, hi, dtype=np.float64)
        wts = bicubic((xs - centre + 0.5) * ss)
        if wts.sum() != 0.0:
            wts = wts / wts.sum()
        m[o, lo:hi] = wts
    return m.astype(np.float32).astype(np.float64)


def downsample(x, scale):
    b, h, w, c = x.shape
    wh = torch.as_tensor(resize_matrix(w, w // scale), device=x.device)
    wv = torch.as_tensor(resize_matrix(h, h // scale), device=x.device)
    y = torch.einsum("...hwc,ow->...hoc", x.to(torch.float64), wh)
    return torch.einsum("...hwc,oh->...owc", y, wv).to(x.dtype)


# -- noise ----------------------------------------------------------------------

def luma(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def poisson_vals(img):
    b = img.shape[0]
    levels = torch.round(img * 255.0).clamp(0, 255).to(torch.int64).reshape(b, -1)
    occupancy = torch.zeros((b, 256), dtype=torch.int32, device=img.device)
    occupancy.scatter_add_(1, levels, torch.ones_like(levels, dtype=torch.int32))
    nuniq = (occupancy > 0).sum(dim=-1).to(torch.float32)
    return torch.exp2(torch.ceil(torch.log2(nuniq)))


def noise(g, x, cfg):
    p = {**NOISE_DEFAULTS, **cfg}
    if not p.get("random_noise_generation", True):
        raise NotImplementedError("reference noise: fixed noise")
    n = x.shape[0]
    use_gauss = torch.rand(n, generator=g, device=g.device) < p["gaussian_poisson_ratio"]
    # Gaussian
    lo, hi = p["gaussian_noise_sigma_range"]
    sigma = lo + (hi - lo) * torch.rand(n, generator=g, device=g.device)
    gray = (torch.rand(n, generator=g, device=g.device) < p["gray_noise_probability"]).to(x.dtype)
    field = torch.randn(x.shape, generator=g, device=g.device, dtype=x.dtype)
    gm = gray[:, None, None, None]
    g_out = (x + div(sigma, 255.0)[:, None, None, None]
             * (gm * field[..., :1] + (1.0 - gm) * field)).clamp(0.0, 1.0)
    # Poisson
    lo, hi = p["poisson_noise_scale_range"]
    scale = lo + (hi - lo) * torch.rand(n, generator=g, device=g.device)
    gray = (torch.rand(n, generator=g, device=g.device) < p["gray_noise_probability"]).to(x.dtype)
    rounded = div(torch.round(x * 255.0).clamp(0, 255), 255.0)
    gray_img = div(torch.round(luma(x) * 255.0).clamp(0, 255), 255.0)
    vals_c = poisson_vals(rounded)[:, None, None, None]
    vals_g = poisson_vals(gray_img)[:, None, None, None]
    sample_c = torch.poisson(rounded * vals_c, generator=g)
    sample_g = torch.poisson(gray_img * vals_g, generator=g)
    gm = gray[:, None, None, None]
    p_noise = gm * (sample_g / vals_g - gray_img) + (1.0 - gm) * (sample_c / vals_c - rounded)
    p_out = (x + scale[:, None, None, None] * p_noise).clamp(0.0, 1.0)
    return torch.where(use_gauss[:, None, None, None], g_out, p_out)


# -- JPEG ---------------------------------------------------------------------

def dct_matrix(device):
    d = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
        for j in range(8):
            d[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    return torch.as_tensor(d.astype(np.float32).astype(np.float64), device=device)


def weighted_sum(img, weights):
    """fma(B, wb, fma(G, wg, R * wr)), each step in float64, rounded to
    float32 once a step."""
    y = (img[..., 0].double() * weights[0]).to(img.dtype)
    for c in (1, 2):
        y = (img[..., c].double() * weights[c] + y.double()).to(img.dtype)
    return y


def scaled_table(base, quality):
    q = quality.to(torch.float32)
    scale = torch.where(q < 50, div(torch.full_like(q, 5000.0), q), 200.0 - 2.0 * q)
    return torch.floor(div(base[None] * scale[:, None, None] + 50.0, 100.0)).clamp(1.0, 255.0)


def jpeg(g, x, cfg):
    p = {**JPEG_DEFAULTS, **cfg}
    n, h, w, _ = x.shape
    if h % 8 or w % 8:
        raise NotImplementedError("reference JPEG: sides that are not multiples of 8")
    if p["random_compression"]:
        lo, hi = p["compression_range"]
        quality = torch.randint(lo, hi + 1, (n,), generator=g, device=g.device).to(torch.float32)
    else:
        quality = torch.full((n,), float(p["quality"]), device=x.device)
    luma_t = torch.as_tensor(np.asarray(LUMA_QTABLE, np.float32), device=x.device)
    chroma_t = torch.as_tensor(np.asarray(CHROMA_QTABLE, np.float32), device=x.device)
    qc = scaled_table(chroma_t, quality)
    qtabs = torch.stack([scaled_table(luma_t, quality), qc, qc], dim=1)
    rows = torch.as_tensor(JPG_FWD, dtype=x.dtype).double().tolist()
    img = x * 255.0
    ycc = torch.stack([weighted_sum(img, r) + bias for r, bias in zip(rows, (0.0, 128.0, 128.0))],
                      dim=-1) - 128.0
    d = dct_matrix(x.device)
    blocks = ycc.to(torch.float64).reshape(n, h // 8, 8, w // 8, 8, 3).permute(0, 5, 1, 3, 2, 4)
    coeff = torch.einsum("ij,bcnmjk,lk->bcnmil", d, blocks, d)
    q = qtabs.to(torch.float64)[:, :, None, None]
    coeff = torch.round(coeff / q) * q
    rec = torch.einsum("ji,bcnmjk,kl->bcnmil", d, coeff, d)
    ycc = rec.permute(0, 2, 4, 3, 5, 1).reshape(n, h, w, 3).to(x.dtype) + 128.0
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    rgb = torch.stack([y + 1.402 * cr - 1.402 * 128.0,
                       y - 0.344136 * cb - 0.714136 * cr + (0.714136 + 0.344136) * 128.0,
                       y + 1.772 * cb - 1.772 * 128.0], dim=-1)
    return div(torch.round(rgb).clamp(0.0, 255.0), 255.0)


def degrade(g: torch.Generator, hr: torch.Tensor, chain: dict, precision: str = "f32"):
    """The LR batch of ``hr`` (B, H, W, 3) float32 in [0, 1] through
    ``chain`` ({"pipeline": [[op, cfg id], ...], "deg_configs": {...}},
    bench.py's layout) with draws from ``g``."""
    x = hr
    for op, cfg_id in chain["pipeline"]:
        cfg = dict(chain.get("deg_configs", {}).get(cfg_id, {}))
        if op == "realesrganblur":
            x = blur(g, x, cfg)
        elif op == "downsample":
            x = downsample(x, int(chain.get("scale", cfg.get("scale", 4))))
        elif op == "realesrgannoise":
            x = noise(g, x, cfg)
        elif op == "jpegcompress":
            x = jpeg(g, x, cfg)
        else:
            raise NotImplementedError(f"reference chain: op {op}")
        if precision == "bf16":
            x = x.to(torch.bfloat16).to(torch.float32)
    return x
