"""Image quality metrics (PSNR, SSIM, face-box PSNR) on tensors.

Port of ``rumpy_tpu/utils/metrics.py``, with its semantics:

* PSNR: float32 MSE, ``20 * log10(max / sqrt(mse))``, and 100 where the MSE
  is 0 (not inf).
* SSIM: an 11-tap Gaussian (sigma 1.5, truncate 3.5), separable filtering
  with symmetric padding (numpy's ``"symmetric"``: the edge pixel repeats),
  the population covariance, a crop of 5 pixels from each side before the
  mean, and the mean over channels.
* LPIPS (``utils/lpips.py``, AlexNet, weights from an npz): the RGB images
  where given (``rgb_a``/``rgb_ref``), else the scored pair, over
  ``max_value``.
* FR_rank: each probe's retrieval rank against the gallery of a
  ``utils/face_recognition.py::FaceRecognizer`` (``face_recognizer``), the
  RGB images where given, the probe names as identities; the features are
  read back inside the recognizer.

Everything runs where the images lie, in float32, and nothing reads a value
back to the host: :meth:`Metrics.compute` returns device tensors and
:func:`fetch` brings a batch's metrics to the host in one copy. The filter
is shifted multiply-adds (no convolution), so TF32 cannot touch it and the
card gives the CPU's bits up to the order of the final means.
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rumpy_tpu_torch.device import true_div


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor (numpy arrays land on the CPU)."""
    if torch.is_tensor(x):
        return x.float()
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _psnr_of(mse: torch.Tensor, max_value: float) -> torch.Tensor:
    val = 20.0 * torch.log10(max_value / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(val, 100.0), val)


def psnr(img1, img2, max_value: float = 255.0) -> torch.Tensor:
    """PSNR between two arrays of any (matching) shape, as a 0-d tensor."""
    a, b = _f32(img1), _f32(img2)
    return _psnr_of(((a - b) ** 2).mean(), max_value)


def psnr_batch(a, b, max_value: float = 1.0) -> torch.Tensor:
    """PSNR of each image of an (N, ...) pair: an (N,) tensor."""
    a, b = _f32(a), _f32(b)
    return _psnr_of(((a - b) ** 2).flatten(1).mean(dim=1), max_value)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _gaussian_kernel(sigma: float, truncate: float) -> tuple:
    """The normalised taps as Python floats holding float32 values."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def symmetric_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """numpy's ``np.pad(..., mode="symmetric")`` by ``r`` on both ends of
    ``dim``, for any ``r``: the side reflected with its edge repeated, which
    is a periodic extension of ``[x, flip(x)]`` (period twice the side), so
    a pad longer than the side reflects again as numpy's does. Slices and
    flips only: nothing is uploaded."""
    if r == 0:
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    period = torch.cat([x, x.flip(dim)], dim=dim)
    start = (-r) % (2 * n)
    reps = -(-(start + n + 2 * r) // (2 * n))
    tiled = period.repeat(*[reps if d == dim else 1 for d in range(x.dim())])
    return tiled.narrow(dim, start, n + 2 * r)


def _filter_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    r = len(taps) // 2
    n = x.shape[dim]
    xp = symmetric_pad(x, r, dim)
    acc = xp.narrow(dim, 0, n) * taps[0]
    for i in range(1, len(taps)):
        acc = acc + xp.narrow(dim, i, n) * taps[i]
    return acc


def _filter2d(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable filtering of a (..., H, W) tensor, H first, as the JAX
    package does."""
    return _filter_axis(_filter_axis(x, taps, -2), taps, -1)


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, data_range: float, sigma: float,
               truncate: float, k1: float, k2: float) -> torch.Tensor:
    """Per-channel SSIM of (..., H, W) float32 stacks: the mean over the
    cropped SSIM map, shape (...)."""
    taps = _gaussian_kernel(sigma, truncate)
    pad = (len(taps) - 1) // 2
    u = _filter2d(torch.stack([x, y, x * x, y * y, x * y]), taps)
    ux, uy, uxx, uyy, uxy = u.unbind(0)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    h, w = s.shape[-2:]
    return s[..., pad:h - pad, pad:w - pad].mean(dim=(-2, -1))


def ssim_single(x, y, data_range: float = 1.0, sigma: float = 1.5,
                truncate: float = 3.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """SSIM of two (H, W) single-channel float images, as a 0-d tensor."""
    return _ssim_maps(_f32(x), _f32(y), data_range, sigma, truncate, k1, k2)


def ssim(x, y, data_range: float = 1.0) -> torch.Tensor:
    """SSIM for (H, W), (H, W, C) or (N, H, W, C) channel-last images:
    channels scored on their own and averaged; (N,) for a batch."""
    x, y = _f32(x), _f32(y)
    if x.dim() == 2:
        return ssim_single(x, y, data_range)
    if x.dim() in (3, 4):
        per_c = _ssim_maps(x.movedim(-1, -3), y.movedim(-1, -3), data_range,
                           1.5, 3.5, 0.01, 0.03)
        return per_c.mean(dim=-1)
    raise ValueError(f"Unsupported ndim {x.dim()}")


# ---------------------------------------------------------------------------
# Face-boundary PSNR
# ---------------------------------------------------------------------------

# Strings that pandas' read_csv reads as NaN.
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def load_boundary_data(hr_data_loc: str) -> Dict[str, Dict[str, int]]:
    """Per-image face boxes from ``face_boundaries_0.csv`` in the HR data
    directory: first column the image name, the others (top, left, height,
    width, ...) integers. Rows with a missing value are dropped, then any
    entry holding a negative value, as the JAX package does with pandas."""
    path = os.path.join(hr_data_loc, "face_boundaries_0.csv")
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        out: Dict[str, Dict[str, int]] = {}
        for row in reader:
            name, vals = row[0], row[1:]
            if any(v.strip() in _NA for v in vals):
                continue
            entry = {k: int(float(v)) for k, v in zip(header[1:], vals)}
            if not any(v < 0 for v in entry.values()):
                out[name] = entry
    return out


def _boundary_entry(boundary_data: Dict[str, Dict[str, int]], name):
    """Boundary lookup: ``name + '.png'`` first (the reference's own rule),
    then the raw name, then a stem match."""
    n = str(name)
    entry = boundary_data.get(n + ".png")
    if entry is None:
        entry = boundary_data.get(n)
    if entry is None:
        stem = os.path.splitext(n)[0]
        for k, v in boundary_data.items():
            if os.path.splitext(str(k))[0] == stem:
                return v
    return entry


def face_psnr(im_a, im_ref, probe_names, boundary_data,
              max_value: float = 1.0) -> torch.Tensor:
    """PSNR of channel 0 with everything outside the face box zeroed in
    both images, the full image area kept in the mean; images without a
    box are scored whole. (N, H, W, C) inputs, an (N,) result."""
    a, r = _f32(im_a), _f32(im_ref)
    h, w = a.shape[1:3]
    masks = torch.ones(len(probe_names), h, w)
    for i, name in enumerate(probe_names):
        box = _boundary_entry(boundary_data, name)
        if box is not None:
            masks[i] = 0.0
            masks[i, box["top"]:box["top"] + box["height"],
                  box["left"]:box["left"] + box["width"]] = 1.0
    masks = masks.to(a.device)
    return psnr_batch(a[..., 0] * masks, r[..., 0] * masks, max_value)


def true_face_psnr(im_a, im_ref, probe_names, boundary_data,
                   max_value: float = 1.0) -> torch.Tensor:
    """PSNR of channel 0 over the face box only (the whole image where an
    image has no box). (N, H, W, C) inputs, an (N,) result."""
    a, r = _f32(im_a), _f32(im_ref)
    vals = []
    for i, name in enumerate(probe_names):
        box = _boundary_entry(boundary_data, name)
        fa, fr = a[i, ..., 0], r[i, ..., 0]
        if box is not None:
            t, l = box["top"], box["left"]
            fa = fa[t:t + box["height"], l:l + box["width"]]
            fr = fr[t:t + box["height"], l:l + box["width"]]
        vals.append(psnr(fa, fr, max_value))
    return torch.stack(vals)


# ---------------------------------------------------------------------------
# Metrics hub
# ---------------------------------------------------------------------------

def fetch(values: Dict[str, torch.Tensor]) -> Dict[str, List[float]]:
    """A batch's metrics, {key: (N,) tensor}, as {key: list of floats}, in
    one copy to the host."""
    if not values:
        return {}
    keys = list(values)
    host = torch.stack([values[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, host))


class Metrics:
    """Batch metrics calculator with the JAX package's keys: channel-last
    float images in [0, max_value]; keys ``<key_prefix><delimeter><metric>``
    or the metric's name. LPIPS needs ``lpips_weights`` (an npz; it raises
    ``NotImplementedError`` without one); FR_rank needs a
    ``face_recognizer`` with a registered gallery (``KeyError`` without)."""

    SUPPORTED = ("PSNR", "SSIM", "LPIPS", "face_PSNR", "true_face_PSNR", "FR_rank")

    def __init__(self, metrics: Sequence[str] = ("PSNR", "SSIM"),
                 delimeter: str = "-", lpips_weights: Optional[str] = None,
                 face_recognizer=None, hr_data_loc: Optional[str] = None):
        self.metrics = list(metrics)
        self.delimeter = delimeter
        self.boundary_data = None
        self.lpips = None
        self.face_recognizer = face_recognizer
        for m in self.metrics:
            if m == "LPIPS":
                from rumpy_tpu_torch.utils.lpips import LPIPS
                self.lpips = LPIPS(lpips_weights, device="cpu")  # raises without weights
            if m == "FR_rank" and face_recognizer is None:
                raise KeyError("FR_rank requires a face_recognizer (see "
                               "rumpy_tpu_torch.utils.face_recognition.FaceRecognizer)")
            if m not in self.SUPPORTED:
                raise KeyError(f"Unsupported metric {m}")
        if "face_PSNR" in self.metrics or "true_face_PSNR" in self.metrics:
            if hr_data_loc is None:
                raise KeyError("face_PSNR/true_face_PSNR need hr_data_loc "
                               "(directory containing face_boundaries_0.csv)")
            self.boundary_data = load_boundary_data(hr_data_loc)

    def _key(self, m: str, key_prefix: Optional[str]) -> str:
        return f"{key_prefix}{self.delimeter}{m}" if key_prefix else m

    def compute(self, im_a, im_ref, max_value: float = 1.0,
                key_prefix: Optional[str] = None, probe_names=None,
                rgb_a=None, rgb_ref=None) -> Dict[str, torch.Tensor]:
        """Each metric of an (N, H, W, C) pair as an (N,) tensor on the
        images' device; nothing is read back. LPIPS scores ``rgb_a`` against
        ``rgb_ref`` where given (the RGB images of a Y-channel pair), and
        FR_rank ranks ``rgb_a`` (or ``im_a``) as ``probe_names``."""
        im_a, im_ref = _f32(im_a), _f32(im_ref)
        out: Dict[str, torch.Tensor] = {}
        for m in self.metrics:
            if m == "FR_rank":
                if probe_names is None:
                    raise ValueError("Need a probe ID to evaluate face "
                                     "recognition performance.")
                ranks = self.face_recognizer.fr_rank(
                    probes=im_a if rgb_a is None else _f32(rgb_a), probe_ids=list(probe_names))
                vals = torch.as_tensor(np.asarray(ranks, np.float64), device=im_a.device)
            elif m == "LPIPS":
                la = im_a if rgb_a is None else _f32(rgb_a)
                lb = im_ref if rgb_ref is None else _f32(rgb_ref)
                if self.lpips.shift.device != la.device:
                    self.lpips.to(la.device)
                vals = self.lpips(true_div(la, max_value), true_div(lb, max_value))
            elif m in ("face_PSNR", "true_face_PSNR"):
                if probe_names is None:
                    raise ValueError("Need probe names to extract face boundaries")
                fn = face_psnr if m == "face_PSNR" else true_face_psnr
                vals = fn(im_a, im_ref, list(probe_names), self.boundary_data, max_value)
            elif m == "PSNR":
                vals = psnr_batch(im_a, im_ref, max_value)
            else:
                vals = ssim(im_a, im_ref, max_value)
            out[self._key(m, key_prefix)] = vals
        return out

    def run_metrics(self, im_a, im_ref, max_value: float = 1.0,
                    key_prefix: Optional[str] = None, probe_names=None,
                    rgb_a=None, rgb_ref=None) -> Dict[str, List[float]]:
        """Per-image metric values for an (N, H, W, C) batch pair, as lists
        of floats (``rgb_a``/``rgb_ref``: the RGB images LPIPS scores)."""
        return fetch(self.compute(im_a, im_ref, max_value, key_prefix, probe_names,
                                  rgb_a, rgb_ref))
