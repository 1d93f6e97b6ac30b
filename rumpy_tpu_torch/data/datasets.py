"""SuperResImages dataset: host-side image provider for training/eval.

Port of ``rumpy_tpu/data/datasets.py::SuperResImages``: a plain Python
indexable that decodes images, pairs LR/HR, crops and augments patches and
returns channel-last float32 numpy dicts. Same listing, split, shortlist,
blacklist and ``_qN`` tag rules, the same HR centre-crop alignment, and the
same numpy ``default_rng`` draws in the same order, so both packages give
the same crops from the same seed. Entropy patch corners come from
``ops/entropy.py``, on ``device`` (the card unless the caller says
otherwise).

Besides the image extensions the dataset reads ``.npy`` files holding a
uint8 (H, W, 3) array, so that it runs where PIL is not installed: PIL is
imported only when an image file is actually opened.

Not ported yet, and raising ``NotImplementedError`` rather than doing
something else: online degradations (the degradation slice), ``input=
"interp"`` (needs ``ops/resize.py``), random colour distortion, metadata
CSVs and facial attributes, blacklist and patch-location CSV files, loss
masks, and ``VideoSequenceImages``.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.config.constants import dataset_splits
from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
ARRAY_EXT = ".npy"
_QTAG = re.compile(r"_q(\d+)\.")


def list_images(directory: str, recursive: bool = False) -> List[str]:
    out: List[str] = []
    for root, _dirs, names in os.walk(directory):
        for n in sorted(names):
            if n.lower().endswith(IMG_EXTS + (ARRAY_EXT,)):
                out.append(os.path.join(root, n))
        if not recursive:
            break
    return sorted(out)


@functools.lru_cache(maxsize=128)
def _decode_cached(path: str, mtime_ns: int) -> np.ndarray:
    if path.lower().endswith(ARRAY_EXT):
        a = np.load(path)
        if a.dtype != np.uint8 or a.ndim != 3 or a.shape[-1] != 3:
            raise ValueError(f"{path}: expected a uint8 (H, W, 3) array, got "
                             f"{a.dtype} {a.shape}")
    else:
        from PIL import Image
        a = np.asarray(Image.open(path).convert("RGB"))
    a.flags.writeable = False  # cached copies are shared; crops copy anyway
    return a


def _decode(path: str) -> np.ndarray:
    """The image at ``path`` as uint8 (H, W, 3), from a bounded cache keyed
    by path and modification time (training re-reads the same files every
    epoch)."""
    return _decode_cached(path, os.stat(path).st_mtime_ns)


def _later(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with {slice_name}")


class SuperResImages:
    def __init__(self, lr_dir: Optional[str] = None,
                 hr_dir: Optional[str] = None,
                 dataset: Optional[str] = None,
                 split: Optional[str] = None,
                 custom_split: Optional[Sequence[int]] = None,
                 image_shortlist: Optional[str] = None,
                 recursive_search: bool = False,
                 input: str = "unmodified",
                 colorspace: str = "rgb",
                 scale: int = 4,
                 metadata_file: Optional[str] = None,
                 metadata: Optional[Sequence[str]] = None,
                 attributes_loc: Optional[str] = None,
                 data_attributes="all",
                 attribute_amplification=None,
                 metadata_normalize=True,
                 qpi_selection=None,
                 ignore_degradation_location: bool = False,
                 blacklist: Optional[Sequence[str]] = None,
                 group_select: Optional[Sequence[int]] = None,
                 crop: Optional[int] = None,
                 crop_count: int = 1,
                 patch_type: str = "random",
                 predefined_patch_locations=None,
                 predefined_patch_location: Optional[str] = None,
                 augmentations: bool = False,
                 use_hflip: bool = True,
                 use_vflip: bool = True,
                 use_rotation: bool = True,
                 use_random_colour_distort: bool = False,
                 colour_distortion_strength: float = 1.0,
                 online_degradations: bool = False,
                 degradation_pipeline=None,
                 mask_data: Optional[str] = None,
                 custom_mask_name: Optional[str] = None,
                 seed: int = 0,
                 device=None):
        if online_degradations or degradation_pipeline is not None:
            raise _later("online_degradations", "the degradation slice")
        if input == "interp":
            raise _later("input='interp'", "ops/resize.py in the degradation slice")
        if use_random_colour_distort:
            raise _later("use_random_colour_distort", "the degradation slice")
        if metadata_file is not None or attributes_loc is not None:
            raise _later("metadata CSVs and facial attributes", "the metadata slice")
        if predefined_patch_location:
            raise _later("predefined_patch_location CSV files", "the metadata slice")
        if isinstance(blacklist, str):
            raise _later("blacklist CSV files", "the metadata slice")
        if mask_data is not None or custom_mask_name:
            raise _later("loss masks from image files", "the metadata slice")
        self.scale = scale
        self.input = input
        self.colorspace = colorspace
        self.crop = crop
        self.crop_count = crop_count
        self.patch_type = patch_type
        self.predefined_patch_locations = predefined_patch_locations
        self.augmentations = augmentations
        self.use_hflip = use_hflip
        self.use_vflip = use_vflip
        self.use_rotation = use_rotation
        self.requested_metadata = list(metadata) if metadata else None
        self._rng = np.random.default_rng(seed)
        # entropy patch selection runs on this device; resolved at first use
        self.device = device

        base_dir = lr_dir if lr_dir is not None else hr_dir
        if base_dir is None:
            raise ValueError("Need lr_dir or hr_dir")
        files = list_images(base_dir, recursive_search)

        # group-tag `_qN` filtering (multi-degraded datasets)
        if group_select is not None:
            keep = set(int(g) for g in group_select)
            files = [f for f in files
                     if (_QTAG.search(os.path.basename(f)) is not None
                         and int(_QTAG.search(os.path.basename(f)).group(1))
                         in keep)]

        # split selection over the sorted listing: custom_split > named
        # split (unless a shortlist is given) > shortlist text file
        if custom_split is not None:
            lo, hi = custom_split
            files = files[lo:hi]
        elif image_shortlist is None and dataset is not None \
                and split is not None:
            lo, hi = dataset_splits[dataset][split]
            files = files[lo:hi]
        elif image_shortlist is not None:
            keep = set()
            abase = os.path.abspath(base_dir)
            with open(image_shortlist) as fh:
                for line in fh:
                    p = line.strip()
                    if not p:
                        continue
                    # entries under base_dir are kept as relative paths;
                    # anything else falls through to basename matching
                    ap = os.path.abspath(p)
                    if ap.startswith(abase + os.sep):
                        keep.add(os.path.relpath(ap, abase))
                    else:
                        keep.add(p)
                        keep.add(os.path.basename(p))
            files = [f for f in files
                     if os.path.relpath(f, base_dir) in keep
                     or os.path.basename(f) in keep]

        if blacklist:
            banned = set(os.path.basename(b) for b in blacklist)
            files = [f for f in files if os.path.basename(f) not in banned]

        self.lr_files = files
        self.lr_base = base_dir
        self.hr_dir = hr_dir
        self.metadata_keys: List[str] = []
        self.metadata_map: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.lr_files)

    # -- helpers -----------------------------------------------------------

    def _hr_path(self, lr_path: str) -> Optional[str]:
        if self.hr_dir is None:
            return None
        name = os.path.basename(lr_path)
        base = _QTAG.sub(".", name)  # strip _qN multi-degradation tag
        cand = os.path.join(self.hr_dir, base)
        if os.path.isfile(cand):
            return cand
        stem = os.path.splitext(base)[0]
        for ext in IMG_EXTS + (ARRAY_EXT,):
            c = os.path.join(self.hr_dir, stem + ext)
            if os.path.isfile(c):
                return c
        return None

    def _colorspace_convert(self, arr_u8: np.ndarray) -> np.ndarray:
        x = arr_u8.astype(np.float32) / 255.0
        if self.colorspace == "ycbcr":
            return rgb_to_ycbcr(torch.from_numpy(x), y_only=True,
                                im_type="jpg").numpy()
        return x

    def _augment(self, *imgs: np.ndarray) -> List[np.ndarray]:
        hflip = self.use_hflip and self._rng.random() < 0.5
        vflip = self.use_vflip and self._rng.random() < 0.5
        rot = self.use_rotation and self._rng.random() < 0.5

        def f(a):
            if hflip:
                a = a[:, ::-1]
            if vflip:
                a = a[::-1]
            if rot:
                a = a.transpose(1, 0, 2)
            return np.ascontiguousarray(a)
        return [f(i) for i in imgs]

    def _select_patch(self, img: np.ndarray, crop_size: int, idx: int,
                      tag: Optional[str] = None, crop_index: int = 0,
                      total: int = 1) -> Tuple[int, int]:
        """Patch corner by patch_type: predefined list / entropy / random."""
        if self.patch_type == "predefined" and self.predefined_patch_locations:
            return tuple(self.predefined_patch_locations[
                (idx + crop_index) % len(self.predefined_patch_locations)])
        if self.patch_type == "entropy" and img.shape[-1] == 3:
            from rumpy_tpu_torch.ops.entropy import entropy_patch_positions
            # multi-crop calls this once per crop_index with identical
            # (img, crop_size, total): compute the position list once per
            # item and reuse it across the crops. Key and value live in ONE
            # attribute (atomic tuple read): a concurrent prefetch thread
            # can at worst force a recompute, never hand this image another
            # image's coordinates.
            cache_key = (idx, crop_size, max(total, 1))
            cached = getattr(self, "_entropy_cache", None)
            if cached is not None and cached[0] == cache_key:
                ys, xs = cached[1]
            else:
                if not isinstance(self.device, torch.device):
                    self.device = resolve_device(self.device)
                ys, xs = entropy_patch_positions(img, crop_size, max(total, 1),
                                                 device=self.device)
                self._entropy_cache = (cache_key, (ys, xs))
            j = crop_index % len(ys)
            return int(ys[j]), int(xs[j])
        top = int(self._rng.integers(0, max(1, img.shape[0] - crop_size + 1)))
        left = int(self._rng.integers(0, max(1, img.shape[1] - crop_size + 1)))
        return top, left

    # -- main accessor -----------------------------------------------------

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        lr_path = self.lr_files[idx]
        tag = os.path.basename(lr_path)
        lr = _decode(lr_path)
        hr_path = self._hr_path(lr_path)
        out: Dict[str, Any] = {"tag": tag}
        hr = _decode(hr_path) if hr_path else None

        if hr is not None:
            # HR centre-crop alignment to LR*scale
            th, tw = lr.shape[0] * self.scale, lr.shape[1] * self.scale
            oh = (hr.shape[0] - th) // 2
            ow = (hr.shape[1] - tw) // 2
            hr = hr[oh:oh + th, ow:ow + tw]

        lr_f = self._colorspace_convert(lr)
        hr_f = self._colorspace_convert(hr) if hr is not None else None

        if self.crop is not None and self.crop_count > 1:
            # Multi-crop mode (contrastive training): stack crop_count
            # patches of the LR image on a leading axis.
            cs = self.crop
            crops = []
            for ci in range(self.crop_count):
                top, left = self._select_patch(lr_f, cs, idx, tag=tag,
                                               crop_index=ci,
                                               total=self.crop_count)
                patch = lr_f[top:top + cs, left:left + cs]
                if ci == 0 and hr_f is not None:
                    # HR aligned with the first (query) crop; geometric
                    # augmentation must hit LR and HR with the SAME draws
                    hs = cs * self.scale
                    hr_patch = hr_f[top * self.scale:top * self.scale + hs,
                                    left * self.scale:left * self.scale + hs]
                    if self.augmentations:
                        patch, hr_patch = self._augment(patch, hr_patch)
                    out["hr"] = hr_patch.astype(np.float32)
                elif self.augmentations:
                    patch, = self._augment(patch)
                crops.append(patch)
            out["lr"] = np.stack(crops).astype(np.float32)
            out["metadata"] = np.array([], np.float32)
            out["metadata_keys"] = self.metadata_keys
            return out

        if self.crop is not None:
            cs = self.crop
            top, left = self._select_patch(lr_f, cs, idx, tag=tag)
            lr_f = lr_f[top:top + cs, left:left + cs]
            if hr_f is not None:
                hs = cs * self.scale
                hr_f = hr_f[top * self.scale:top * self.scale + hs,
                            left * self.scale:left * self.scale + hs]

        if self.augmentations:
            if hr_f is not None:
                lr_f, hr_f = self._augment(lr_f, hr_f)
            else:
                lr_f, = self._augment(lr_f)

        out["lr"] = lr_f.astype(np.float32)
        if hr_f is not None:
            out["hr"] = hr_f.astype(np.float32)
        out["metadata"] = np.array([], np.float32)
        out["metadata_keys"] = self.metadata_keys
        return out


class VideoSequenceImages:
    """VSR dataset of the JAX package; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _later("VideoSequenceImages", "the video slice")
