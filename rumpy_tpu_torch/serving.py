"""Batched SR serving: shape bucketing and micro-batching on one card.

Port of ``rumpy_tpu/serving.py`` without the mesh (serving across cards
comes with ``torch.distributed``):

- requests of arbitrary sizes are reflect-padded into a small set of shape
  buckets, so the card sees a few input shapes in steady state;
- same-bucket requests are micro-batched up to ``max_batch``;
- outputs are cropped back to each request's true size.

The predictor wraps any handler's ``run_eval`` (metadata-conditioned models
pass their vectors alongside).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _bucket(size: int, multiple: int) -> int:
    return int(math.ceil(size / multiple) * multiple)


def plan_batches(sizes: Sequence[Tuple[int, int]], pad_multiple: int,
                 max_batch: int) -> List[Tuple[List[int], Tuple[int, int]]]:
    """The forwards ``BatchedPredictor.predict`` runs for requests of these
    (h, w) sizes, in order: (request indices, (bucket h, bucket w)) each.
    Requests are sorted by bucket so same-bucket ones are consecutive, then
    cut into micro-batches of at most ``max_batch``."""
    def key(i):
        return (_bucket(sizes[i][0], pad_multiple),
                _bucket(sizes[i][1], pad_multiple))

    batches: List[Tuple[List[int], Tuple[int, int]]] = []
    for i in sorted(range(len(sizes)), key=key):
        if (batches and batches[-1][1] == key(i)
                and len(batches[-1][0]) < max_batch):
            batches[-1][0].append(i)
        else:
            batches.append(([i], key(i)))
    return batches


class BatchedPredictor:
    """Micro-batching, shape-bucketing inference wrapper.

    :param handler: a model handler (``run_eval(state, batch)``); it runs on
        its own device, ``"cuda"`` unless it was built for the CPU.
    :param state: its TrainState.
    :param pad_multiple: spatial bucket granularity.
    :param max_batch: micro-batch cap per forward.
    """

    def __init__(self, handler, state, pad_multiple: int = 32,
                 max_batch: int = 8):
        self.handler = handler
        self.state = state
        self.pad_multiple = pad_multiple
        self.max_batch = max_batch
        self.scale = getattr(handler, "scale", 1)
        self._lock = threading.Lock()

    def predict(self, images: Sequence[np.ndarray],
                metadata: Optional[Sequence[np.ndarray]] = None
                ) -> List[np.ndarray]:
        """SR a list of HWC float images (various sizes). Returns a list
        of HWC float32 outputs at ``scale`` x the input size."""
        results: List[Optional[np.ndarray]] = [None] * len(images)
        for group, key in plan_batches([im.shape[:2] for im in images],
                                       self.pad_multiple, self.max_batch):
            outs = self._run_bucket(
                [images[j] for j in group],
                [metadata[j] for j in group] if metadata else None, *key)
            for j, out in zip(group, outs):
                results[j] = out
        return results  # type: ignore[return-value]

    def _run_bucket(self, imgs: List[np.ndarray],
                    metas: Optional[List[np.ndarray]],
                    bh: int, bw: int) -> List[np.ndarray]:
        c = imgs[0].shape[-1]
        x = np.zeros((len(imgs), bh, bw, c), np.float32)
        for k, im in enumerate(imgs):
            h, w = im.shape[:2]
            x[k] = np.pad(im.astype(np.float32),
                          ((0, bh - h), (0, bw - w), (0, 0)), mode="reflect")
        batch: Dict[str, Any] = {"lr": x}
        if metas is not None:
            batch["metadata"] = np.stack([np.asarray(mm, np.float32).ravel()
                                          for mm in metas])
        with self._lock:
            sr = self.handler.run_eval(self.state, batch).float().cpu().numpy()
        s = self.scale
        return [sr[k, :im.shape[0] * s, :im.shape[1] * s]
                for k, im in enumerate(imgs)]
