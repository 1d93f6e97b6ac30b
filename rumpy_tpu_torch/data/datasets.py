"""SuperResImages dataset: host-side image provider for training/eval.

Port of ``rumpy_tpu/data/datasets.py::SuperResImages``: a plain Python
indexable that decodes images, pairs LR/HR, crops and augments patches and
returns channel-last float32 numpy dicts. Same listing, split, shortlist,
blacklist and ``_qN`` tag rules, the same HR centre-crop alignment, and the
same numpy ``default_rng`` draws in the same order, so both packages give
the same crops from the same seed. Entropy patch corners come from
``ops/entropy.py``, on ``device`` (the card unless the caller says
otherwise).

With ``online_degradations`` a dataset is HR-only: an item is a uniform
random crop of ``crop * scale`` HR pixels (undersized images
reflect-padded up to it), augmented and optionally colour-distorted; the
train step makes its LR on the device. ``input="interp"`` upsamples the LR
with ``ops/resize.py::pil_resize`` on the CPU, in the loader's thread.
Random colour distortion draws one seed from the dataset's rng and applies
the same draws to LR and HR.

Besides the image extensions the dataset reads ``.npy`` files holding a
uint8 (H, W, 3) array, so that it runs where PIL is not installed: PIL is
imported only when an image file is actually opened.

A ``metadata_file`` (or ``"on_site"``: ``<lr_dir>/degradation_metadata.csv``
where there is one) gives each item its image's row of degradation
metadata, read by ``data/metadata.py``, and the set its ``metadata_keys``.
An ``attributes_loc`` (CelebA's ``list_attr_celeba.txt`` layout) prepends
the image's facial attributes to that row, under ``celeba-<name>`` keys.

The CSV files are read with the ``csv`` module, as pandas reads them: a
``blacklist`` file's ``Images`` column names the images to drop, and a
``predefined_patch_location`` file gives an image (its index: the name,
or a stringified tuple whose first entry is the name) the corners of its
crops, one per crop index. A loss mask (``mask_data``: a folder of masks
named as the HR images; or ``custom_mask_name``: one file beside each HR
image) is centre-cropped to the aligned HR size (a smaller mask centred
in a zero field), then cropped and augmented with the HR image.
``VideoSequenceImages`` stacks windows of frames on the channel axis, the
frames of a window sharing one crop and one augmentation draw.
"""

from __future__ import annotations

import ast
import csv
import functools
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.config.constants import dataset_splits
from rumpy_tpu_torch.data.metadata import read_augmentation_list, read_celeba_attributes
from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.ops.color_aug import apply_colour_distortion, colour_distortion_draws
from rumpy_tpu_torch.ops.resize import pil_resize
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


def _csv_rows(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV file; blank lines are skipped, as pandas
    skips them."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        return header, [r for r in reader if r]


def read_blacklist(path: str) -> List[str]:
    """The ``Images`` column of a blacklist CSV file."""
    header, rows = _csv_rows(path)
    col = header.index("Images")
    return [r[col] for r in rows]


def read_patch_file(path: str) -> Dict[str, List[Tuple[int, ...]]]:
    """{image name: its crops' corners} of a predefined-patch CSV file:
    the first column is the index (the image name, or a stringified tuple
    whose first entry is the name), the ``high_entropy_patches_left_corner``
    column a stringified list of corners. A repeated name keeps its last
    row."""
    header, rows = _csv_rows(path)
    col = header.index("high_entropy_patches_left_corner")
    out: Dict[str, List[Tuple[int, ...]]] = {}
    for r in rows:
        key = r[0]
        try:
            parsed = ast.literal_eval(key)
            name = parsed[0] if isinstance(parsed, tuple) else parsed
        except (ValueError, SyntaxError):
            name = key
        out[str(name)] = [tuple(c) for c in ast.literal_eval(r[col])]
    return out


class SuperResImages:
    # While a dict: host ms of the items read, summed by part ("decode",
    # "select", "convert", "crop_augment"), from laps that __getitem__ takes.
    part_ms: Optional[Dict[str, float]] = None

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
        if use_random_colour_distort and colorspace != "rgb":
            raise ValueError("use_random_colour_distort operates on RGB images "
                             "(the reference distorts the image before any "
                             "colorspace transform)")
        if metadata_file == "on_site" or (metadata_file is None and metadata and lr_dir):
            # <lr_dir>/degradation_metadata.csv where there is one, as in
            # the JAX package; without one the set carries no metadata
            candidate = os.path.join(lr_dir, "degradation_metadata.csv") if lr_dir else None
            metadata_file = candidate if candidate and os.path.isfile(candidate) else None
        self.scale = scale
        self.input = input
        self.colorspace = colorspace
        self.crop = crop
        self.crop_count = crop_count
        self.patch_type = patch_type
        self.predefined_patch_locations = predefined_patch_locations
        # per-image patch corners from a CSV file
        self.patch_file = (read_patch_file(predefined_patch_location)
                           if predefined_patch_location else None)
        self.augmentations = augmentations
        self.use_hflip = use_hflip
        self.use_vflip = use_vflip
        self.use_rotation = use_rotation
        self.use_random_colour_distort = use_random_colour_distort
        self.colour_distortion_strength = colour_distortion_strength
        self.online_degradations = online_degradations
        self.requested_metadata = list(metadata) if metadata else None
        # per-image HR loss masks: a folder of masks named as the HR images,
        # or one file name resolved beside each HR image
        self.mask_base = mask_data
        self.custom_mask_name = custom_mask_name
        self._rng = np.random.default_rng(seed)
        # entropy patch selection runs on this device; resolved at first use
        self.device = device

        base_dir = hr_dir if (online_degradations or lr_dir is None) else lr_dir
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
            if isinstance(blacklist, str):
                blacklist = read_blacklist(blacklist)
            banned = set(os.path.basename(b) for b in blacklist)
            files = [f for f in files if os.path.basename(f) not in banned]

        self.lr_files = files
        self.lr_base = base_dir
        self.hr_dir = hr_dir
        self.metadata_keys: List[str] = []
        self.metadata_map: Dict[str, np.ndarray] = {}
        if metadata_file is not None:
            self.metadata_map, self.metadata_keys = read_augmentation_list(
                metadata_file, [os.path.basename(f) for f in files],
                normalize=metadata_normalize,
                ignore_degradation_location=ignore_degradation_location,
                qpi_selection=qpi_selection)
            # QPI filtering may drop images
            self.lr_files = [f for f in files if os.path.basename(f) in self.metadata_map]
        elif attributes_loc is not None:
            self.metadata_map = {os.path.basename(f): np.array([], np.float32)
                                 for f in self.lr_files}
        if attributes_loc is not None:
            # CelebA attributes: their keys come before the degradation keys
            self.metadata_map, attr_keys = read_celeba_attributes(
                attributes_loc, self.metadata_map, selected_metadata=data_attributes,
                attribute_amplification=attribute_amplification)
            self.metadata_keys = [f"celeba-{k.lower()}" for k in attr_keys] + self.metadata_keys

    def __len__(self) -> int:
        return len(self.lr_files)

    # -- helpers -----------------------------------------------------------

    def _metadata(self, tag: str) -> np.ndarray:
        """The image's full metadata row (empty without a CSV); a handler
        selects its columns (``select_metadata``)."""
        meta = self.metadata_map.get(tag)
        return meta if meta is not None else np.array([], np.float32)

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

    def _load_mask(self, hr_path: str, th: int, tw: int) -> np.ndarray:
        """The HR image's loss mask as float32 HWC in [0, 1], centre-cropped
        to the aligned HR size th x tw with PIL crop semantics: a mask
        smaller than that comes back centred in a zero field. A missing
        mask raises, since a half-masked set would give ragged batches."""
        if self.custom_mask_name:
            path = os.path.join(os.path.dirname(hr_path), self.custom_mask_name)
        else:
            path = os.path.join(self.mask_base, os.path.basename(hr_path))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"loss mask for {hr_path!r} not found at {path!r} (mask_data/"
                "custom_mask_name is configured, so every HR image needs a mask)")
        mask = _decode(path)
        if mask.shape[0] != th or mask.shape[1] != tw:
            t, l_ = (mask.shape[0] - th) // 2, (mask.shape[1] - tw) // 2
            out = np.zeros((th, tw) + mask.shape[2:], mask.dtype)
            src = mask[max(t, 0):max(t, 0) + min(th, mask.shape[0]),
                       max(l_, 0):max(l_, 0) + min(tw, mask.shape[1])]
            out[max(-t, 0):max(-t, 0) + src.shape[0],
                max(-l_, 0):max(-l_, 0) + src.shape[1]] = src
            mask = out
        return mask.astype(np.float32) / 255.0

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

    def _colour_distort(self, *imgs: np.ndarray) -> List[np.ndarray]:
        """SimCLR colour distortion with one set of draws for every image
        passed together, so that an LR/HR pair stays photometrically
        aligned; the draws come from a seed drawn from the dataset's rng."""
        seed = int(self._rng.integers(2 ** 31))
        draws = colour_distortion_draws(torch.Generator().manual_seed(seed), 1,
                                        self.colour_distortion_strength)
        return [apply_colour_distortion(torch.from_numpy(np.ascontiguousarray(im))[None],
                                        *draws)[0].numpy() for im in imgs]

    def _hr_patch(self, hr: np.ndarray) -> np.ndarray:
        """An HR-only item's patch: a uniform random crop of crop * scale
        (undersized images reflect-padded up to it), converted, augmented,
        colour-distorted if asked."""
        if self.crop is not None:
            cs = self.crop * self.scale
            if hr.shape[0] < cs or hr.shape[1] < cs:
                # every patch of a batch has one shape
                ph, pw = max(0, cs - hr.shape[0]), max(0, cs - hr.shape[1])
                hr = np.pad(hr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
            top = int(self._rng.integers(0, max(1, hr.shape[0] - cs + 1)))
            left = int(self._rng.integers(0, max(1, hr.shape[1] - cs + 1)))
            hr = hr[top:top + cs, left:left + cs]
        hr_f = self._colorspace_convert(hr)
        if self.augmentations:
            hr_f, = self._augment(hr_f)
            if self.use_random_colour_distort:
                hr_f, = self._colour_distort(hr_f)
        return hr_f.astype(np.float32)

    def _select_patch(self, img: np.ndarray, crop_size: int, idx: int,
                      tag: Optional[str] = None, crop_index: int = 0,
                      total: int = 1) -> Tuple[int, int]:
        """Patch corner: the image's corners from a patch CSV file, then by
        patch_type: predefined list / entropy / random. ``img`` is the LR
        image before conversion (uint8 RGB)."""
        if self.patch_file is not None and tag in self.patch_file:
            locs = self.patch_file[tag]
            return tuple(locs[crop_index % len(locs)])
        if self.patch_type == "predefined" and self.predefined_patch_locations:
            return tuple(self.predefined_patch_locations[
                (idx + crop_index) % len(self.predefined_patch_locations)])
        # the converted LR has 3 channels unless it is YCbCr's Y, the JAX
        # package's condition for an entropy patch
        if self.patch_type == "entropy" and self.colorspace != "ycbcr":
            from rumpy_tpu_torch.ops.entropy import entropy_patch_positions
            # multi-crop calls this once per crop_index with identical
            # (img, crop_size, total): compute the position list once per
            # item and reuse it across the item's later crops only (an item
            # of the same index in another epoch computes it again, so each
            # item's first crop is one entropy launch). Key and value live
            # in ONE attribute (atomic tuple read): a concurrent prefetch
            # thread can at worst force a recompute, never hand this image
            # another image's coordinates.
            cache_key = (idx, crop_size, max(total, 1))
            cached = getattr(self, "_entropy_cache", None)
            if crop_index > 0 and cached is not None and cached[0] == cache_key:
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

    def _lap(self, part: str, since: float) -> float:
        """Adds the ms since ``since`` to ``part_ms[part]`` while timing;
        returns the time now."""
        now = time.perf_counter()
        if self.part_ms is not None:
            self.part_ms[part] = self.part_ms.get(part, 0.0) + (now - since) * 1e3
        return now

    # -- main accessor -----------------------------------------------------

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        t = time.perf_counter()
        lr_path = self.lr_files[idx]
        tag = os.path.basename(lr_path)
        lr = _decode(lr_path)
        if self.online_degradations:
            # HR-only: the listed file is the HR image
            t = self._lap("decode", t)
            if self.crop is not None and self.crop_count > 1:
                hr_out = np.stack([self._hr_patch(lr) for _ in range(self.crop_count)])
            else:
                hr_out = self._hr_patch(lr)
            self._lap("crop_augment", t)
            return {"hr": hr_out, "tag": tag, "metadata": np.array([], np.float32),
                    "metadata_keys": []}
        hr_path = self._hr_path(lr_path)
        out: Dict[str, Any] = {"tag": tag}
        hr = _decode(hr_path) if hr_path else None

        mask = None
        if hr is not None:
            # HR centre-crop alignment to LR*scale
            th, tw = lr.shape[0] * self.scale, lr.shape[1] * self.scale
            oh = (hr.shape[0] - th) // 2
            ow = (hr.shape[1] - tw) // 2
            hr = hr[oh:oh + th, ow:ow + tw]
            if self.mask_base is not None or self.custom_mask_name:
                mask = self._load_mask(hr_path, th, tw)
        t = self._lap("decode", t)

        # LR pixels per HR pixel in a crop: 1 once the LR is upsampled
        eff_scale = self.scale
        if self.input == "interp":
            lr = pil_resize(lr, (lr.shape[0] * self.scale, lr.shape[1] * self.scale)).numpy()
            eff_scale = 1
        # Both images are converted after the crop: the conversion is per
        # pixel, so a crop of the converted image has the same bits, and the
        # whole HR image is never converted. Random colour distortion is the
        # exception: it distorts whole images before cropping, the JAX
        # package's order, so then both are converted and distorted first.
        convert = self._colorspace_convert
        if self.augmentations and self.use_random_colour_distort:
            whole = [convert(lr)] + ([convert(hr)] if hr is not None else [])
            distorted = self._colour_distort(*whole)
            lr, hr = distorted[0], (distorted[1] if hr is not None else None)
            convert = np.asarray
        if self.crop is not None and self.crop_count > 1:
            # Multi-crop mode (contrastive training): stack crop_count
            # patches of the LR image on a leading axis.
            cs = self.crop
            crops = []
            for ci in range(self.crop_count):
                top, left = self._select_patch(lr, cs, idx, tag=tag,
                                               crop_index=ci,
                                               total=self.crop_count)
                t = self._lap("select", t)
                patch = convert(lr[top:top + cs, left:left + cs])
                hr_patch = None
                if ci == 0 and hr is not None:
                    # HR aligned with the first (query) crop
                    hs = cs * eff_scale
                    hr_patch = convert(
                        hr[top * eff_scale:top * eff_scale + hs,
                           left * eff_scale:left * eff_scale + hs])
                t = self._lap("convert", t)
                if hr_patch is not None:
                    # geometric augmentation must hit LR and HR with the
                    # SAME draws
                    if self.augmentations:
                        patch, hr_patch = self._augment(patch, hr_patch)
                    out["hr"] = hr_patch.astype(np.float32)
                elif self.augmentations:
                    patch, = self._augment(patch)
                crops.append(patch)
                t = self._lap("crop_augment", t)
            out["lr"] = np.stack(crops).astype(np.float32)
            out["metadata"] = self._metadata(tag)
            out["metadata_keys"] = self.metadata_keys
            return out

        if self.crop is not None:
            cs = self.crop
            top, left = self._select_patch(lr, cs, idx, tag=tag)
            t = self._lap("select", t)
            lr = lr[top:top + cs, left:left + cs]
            if hr is not None:
                hs = cs * eff_scale
                hr = hr[top * eff_scale:top * eff_scale + hs,
                        left * eff_scale:left * eff_scale + hs]
                if mask is not None:
                    mask = mask[top * eff_scale:top * eff_scale + hs,
                                left * eff_scale:left * eff_scale + hs]
            t = self._lap("crop_augment", t)
        lr_f = convert(lr)
        hr_f = convert(hr) if hr is not None else None
        t = self._lap("convert", t)

        if self.augmentations:
            if hr_f is not None and mask is not None:
                lr_f, hr_f, mask = self._augment(lr_f, hr_f, mask)
            elif hr_f is not None:
                lr_f, hr_f = self._augment(lr_f, hr_f)
            else:
                lr_f, = self._augment(lr_f)

        out["lr"] = lr_f.astype(np.float32)
        if hr_f is not None:
            out["hr"] = hr_f.astype(np.float32)
        if mask is not None:
            out["mask"] = mask.astype(np.float32)
        out["metadata"] = self._metadata(tag)
        out["metadata_keys"] = self.metadata_keys
        self._lap("crop_augment", t)
        return out


class VideoSequenceImages(SuperResImages):
    """VSR dataset: the sorted listing's windows of ``num_frames``
    consecutive frames, their LR images concatenated on the channel axis;
    the item's HR target (and tag, metadata and mask) is one frame,
    ``hr_selection`` ("center" or an index into the window).
    ``use_masks`` reads ``uvtex_mask.png`` beside the HR frames as the loss
    mask unless the set names its own ``custom_mask_name``."""

    def __init__(self, num_frames: int = 5, hr_selection="center",
                 use_masks: bool = False, **kwargs):
        if use_masks:
            kwargs.setdefault("mask_data", kwargs.get("hr_dir"))
            kwargs.setdefault("custom_mask_name", "uvtex_mask.png")
        super().__init__(**kwargs)
        self.num_frames = num_frames
        self.hr_selection = (num_frames // 2 if hr_selection == "center"
                             else int(hr_selection))
        self._starts = list(range(0, len(self.lr_files) - num_frames + 1))
        self._window_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        start = self._starts[idx]
        # Every frame of a window shares one crop and one augmentation
        # draw: the rng is reseeded with one seed drawn from the ongoing
        # stream before each frame. The whole window runs under a lock, so
        # that a loader thread fetching another window cannot swap the rng
        # mid-window; the stream is restored afterwards.
        with self._window_lock:
            epoch_rng = self._rng
            window_seed = int(epoch_rng.integers(0, 2 ** 31))
            frames = []
            try:
                for i in range(self.num_frames):
                    self._rng = np.random.default_rng(window_seed)
                    item = super().__getitem__(start + i)
                    frames.append(item["lr"])
                    if i == self.hr_selection:
                        target = item
            finally:
                self._rng = epoch_rng
        out = {"lr": np.concatenate(frames, axis=-1), "tag": target["tag"],
               "metadata": target["metadata"], "metadata_keys": target["metadata_keys"]}
        for k in ("hr", "mask"):
            if k in target:
                out[k] = target[k]
        return out
