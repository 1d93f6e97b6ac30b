"""Batch assembly + background prefetch, and config-driven loader setup.

Port of ``rumpy_tpu/data/loader.py``: a thread pool decodes and crops items
ahead of the training loop, so the host pipeline overlaps device steps.
Batches are numpy dicts; the trainer moves them to the device. Shuffle
order comes from numpy ``default_rng(seed)``, as in the JAX package, so
both give the same batches. ``CelebaSplitSampler`` orders an epoch by
one CelebA attribute: its positives, then its negatives.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

def default_collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) and vals[0].dtype != object:
            # Stack only if shapes agree (full-image eval keeps lists).
            shapes = {v.shape for v in vals}
            out[k] = np.stack(vals) if len(shapes) == 1 else vals
        else:
            out[k] = vals
    return out


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[ds][idx - self._offsets[ds]]


class CelebaSplitSampler:
    """Attribute-positive-first sampling order: every epoch yields all
    indices whose selected CelebA attribute is 1 (shuffled), then those
    where it is 0 (shuffled). A ``ConcatDataset``'s sets are indexed with
    their offsets. Exactly one of a set's metadata keys must contain the
    attribute's name."""

    def __init__(self, data_source, selected_attribute: str = "gender", seed: int = 0):
        self.attribute = selected_attribute
        self._rng = np.random.default_rng(seed)
        datasets = (data_source.datasets if isinstance(data_source, ConcatDataset)
                    else [data_source])
        self.positive_indices: List[int] = []
        self.negative_indices: List[int] = []
        offset = 0
        for ds in datasets:
            pos, neg, n = self._index_with_attribute(ds)
            self.positive_indices += [p + offset for p in pos]
            self.negative_indices += [p + offset for p in neg]
            offset += n
        self.length = offset

    def _index_with_attribute(self, dataset):
        keys = list(getattr(dataset, "metadata_keys", []))
        hits = [i for i, k in enumerate(keys) if self.attribute in k]
        if len(hits) != 1:
            raise ValueError(f"Attribute {self.attribute!r} matched {len(hits)} "
                             f"metadata keys {keys}; need exactly one")
        col = hits[0]
        if hasattr(dataset, "metadata"):
            meta = np.asarray(dataset.metadata, np.float32)
        else:  # SuperResImages: a name -> vector map, in listing order
            meta = np.stack([dataset.metadata_map[os.path.basename(f)]
                             for f in dataset.lr_files]).astype(np.float32)
        pos = np.nonzero(meta[:, col] == 1)[0].tolist()
        neg = np.nonzero(meta[:, col] == 0)[0].tolist()
        return pos, neg, meta.shape[0]

    def __iter__(self):
        pos = self._rng.permutation(self.positive_indices)
        neg = self._rng.permutation(self.negative_indices)
        return iter(np.concatenate([pos, neg]).astype(np.int64).tolist())

    def __len__(self) -> int:
        return self.length


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0, collate=default_collate,
                 sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.collate = collate
        self.sampler = sampler
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        # size from the sampler when present — it may yield fewer (or
        # differently-ordered) indices than the dataset holds
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[np.ndarray]:
        if self.sampler is not None:
            idx = np.fromiter(iter(self.sampler), dtype=np.int64)
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(idx)
        n = len(idx)
        n_b = (n // self.batch_size if self.drop_last
               else (n + self.batch_size - 1) // self.batch_size)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_b)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def load_batch(b):
                return self.collate([self.dataset[int(i)] for i in b])
            pending = []
            it = iter(batches)
            for _ in range(self.prefetch):
                try:
                    pending.append(pool.submit(load_batch, next(it)))
                except StopIteration:
                    break
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(load_batch, next(it)))
                except StopIteration:
                    pass
                yield fut.result()


def sisr_data_setup(data_cfg, scale: int = 4, batch_size: int = 8,
                    eval_batch_size: int = 1, dataloader_threads: int = 4,
                    input: str = "unmodified", colorspace: str = "rgb",
                    crop: Optional[int] = None, crop_count: int = 1,
                    augmentations: bool = False,
                    metadata: Optional[Sequence[str]] = None, seed: int = 0,
                    sampler_attributes: Optional[Dict[str, Any]] = None,
                    device=None):
    """Build train/val loaders from the config's
    [data.training_sets.data_N] / [data.eval_sets.data_N] tables. Returns
    (train_loader, eval_loader); either may be None. ``device`` is where
    the datasets compute entropy patch positions."""
    from rumpy_tpu_torch.data.datasets import SuperResImages, VideoSequenceImages

    # data-level options: per-dataset blacklist/attribute dicts keyed by
    # dataset name, segmentation-mask extraction, VSR frame bundling,
    # last-batch policy
    blacklists = data_cfg.get("blacklists") or {}
    attributes = data_cfg.get("attributes") or {}
    extract_masks = bool(data_cfg.get("extract_masks"))
    multi_frame_config = data_cfg.get("multi_frame_config")
    drop_last_cfg = data_cfg.get("drop_last_training_batch")

    def build(sets_cfg, is_train):
        if not sets_cfg:
            return None
        datasets = []
        # the config files' per-dataset key vocabulary, translated to
        # this data layer's names
        aliases = {"lr": "lr_dir", "hr": "hr_dir", "name": "dataset",
                   "degradation_metadata": "metadata_file",
                   "qpi_values": "metadata_file",
                   "random_crop": "crop",
                   "random_augment": "augmentations",
                   "random_augments": "augmentations",
                   "request_crops": "crop_count",
                   "patch_selection_type": "patch_type",
                   "degradation_metadata_file": "metadata_file"}
        for name in sorted(sets_cfg.keys()):
            ds_cfg = dict(sets_cfg[name])
            for old, new in aliases.items():
                if old in ds_cfg:
                    v = ds_cfg.pop(old)
                    if v is not None and new not in ds_cfg:
                        ds_cfg[new] = v
            cutoff = ds_cfg.pop("cutoff", None)
            if cutoff is not None and "custom_split" not in ds_cfg:
                ds_cfg["custom_split"] = (list(cutoff)
                                          if isinstance(cutoff, (list, tuple))
                                          else (0, int(cutoff)))
            # named datasets default to the split their table sits in
            if ds_cfg.get("dataset") is not None:
                ds_cfg.setdefault("split", "train" if is_train else "eval")
            ds_cfg.setdefault("scale", scale)
            ds_cfg.setdefault("input", input)
            # eval sets stay RGB: the interface's net_run_and_process owns
            # the YCbCr conversion + Cb/Cr reassembly for Y-channel models
            ds_cfg.setdefault("colorspace",
                              colorspace if is_train else "rgb")
            if is_train:
                ds_cfg.setdefault("crop", crop)
                ds_cfg.setdefault("crop_count", crop_count)
                ds_cfg.setdefault("augmentations", augmentations)
            if metadata is not None:
                ds_cfg.setdefault("metadata", metadata)
            ds_cfg.setdefault("seed", seed)
            ds_cfg.setdefault("device", device)
            ds_cfg.pop("name", None)
            ds_name = ds_cfg.get("dataset")
            if ds_name in blacklists:
                ds_cfg.setdefault("blacklist", blacklists[ds_name])
            if ds_name in attributes:
                ds_cfg.setdefault("data_attributes", attributes[ds_name])
            if extract_masks and ds_cfg.get("hr_dir"):
                ds_cfg.setdefault("mask_data", os.path.join(
                    ds_cfg["hr_dir"], "segmentation_patterns"))
            if multi_frame_config is not None:
                datasets.append(VideoSequenceImages(
                    **dict(multi_frame_config), **ds_cfg))
            else:
                datasets.append(SuperResImages(**ds_cfg))
        ds = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
        sampler = None
        if is_train and sampler_attributes is not None:
            attrs = dict(sampler_attributes)
            if attrs.pop("name", "").lower() != "celebasplitsampler":
                raise RuntimeError("Selected data sampler not recognized.")
            sampler = CelebaSplitSampler(ds, seed=seed, **attrs)
        return DataLoader(
            ds, batch_size=batch_size if is_train else eval_batch_size,
            # drop_last defaults to True for training, as in the JAX
            # package (overridable via drop_last_training_batch)
            shuffle=is_train and sampler is None,
            drop_last=is_train and (True if drop_last_cfg is None
                                    else bool(drop_last_cfg)),
            num_workers=dataloader_threads, seed=seed, sampler=sampler)

    train = build(data_cfg.get("training_sets"), True)
    evalu = build(data_cfg.get("eval_sets"), False)
    return train, evalu
