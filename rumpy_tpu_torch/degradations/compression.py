"""Compression degradation ops.

Port of ``rumpy_tpu/degradations/compression.py``, device paths:

* ``JPEGCompress``: the DCT codec of ``ops/jpeg.py``, per-example quality
  (fixed, or uniform over ``compression_range``); metadata ``quality``,
  normalized by the range.
* ``JMCompress``: the H.264-intra approximation of ``ops/jpeg.py``, which
  needs no binary; metadata ``qpi``.
* ``RandomCompress``: JM or JPEG per image with probability 1/2, with the
  dual zero-filled columns ``jm_qpi`` / ``jpeg_quality``.

The host paths (PIL's libjpeg, the JM binary, ffmpeg's libx264, the
native H.264 intra codec) come with the tools slice and raise.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from rumpy_tpu_torch.degradations.base import DegradationOp, normalize, per_view
from rumpy_tpu_torch.ops import jpeg as jpeg_ops
from rumpy_tpu_torch.registry import register_tool


class _Codec(DegradationOp):
    """Fixed or per-example random level in ``compression_range``."""

    def _levels(self, generator, b: int, fixed) -> torch.Tensor:
        dev = generator.device
        if self.random_compression:
            lo, hi = self.compression_range
            return torch.randint(lo, hi + 1, (b,), generator=generator,
                                 device=dev).to(torch.float32)
        return torch.full((b,), float(fixed), device=dev)

    def _norm(self, q):
        return normalize(q, *self.compression_range) if self.normalize_metadata else q


@register_tool("jpegcompress")
class JPEGCompress(_Codec):
    def __init__(self, quality=50, compression_range=(20, 80),
                 random_compression=False, normalize_metadata=True, seed=0):
        self.quality = quality
        self.compression_range = tuple(compression_range)
        self.random_compression = random_compression
        self.normalize_metadata = normalize_metadata

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_quality": self.compression_range[0],
                "max_quality": self.compression_range[1]}

    def batch_apply(self, generator, imgs, views: int = 1):
        quality = self._levels(generator, imgs.shape[0] // views, self.quality)
        return (jpeg_ops.jpeg_compress(imgs, per_view(quality, views)),
                {"quality": self._norm(quality)})


@register_tool("jmcompress")
class JMCompress(_Codec):
    def __init__(self, qpi=28, compression_range=(20, 40),
                 random_compression=False, verbose=False,
                 normalize_metadata=True, jm_bin=None, seed=0, **kwargs):
        if qpi > 51 or compression_range[1] > 51:
            raise RuntimeError("QPI cannot be larger than 51.")
        self.qpi = qpi
        self.compression_range = tuple(compression_range)
        self.random_compression = random_compression
        self.normalize_metadata = normalize_metadata

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_qpi": self.compression_range[0],
                "max_qpi": self.compression_range[1]}

    def batch_apply(self, generator, imgs, views: int = 1):
        qpi = self._levels(generator, imgs.shape[0] // views, self.qpi)
        return (jpeg_ops.h264_intra_compress(imgs, per_view(qpi, views)),
                {"qpi": self._norm(qpi)})


@register_tool("randomcompress")
class RandomCompress(DegradationOp):
    def __init__(self, jm_params=None, jpeg_params=None, seed=0):
        self.jm_class = JMCompress(**(jm_params or {}))
        self.jpeg_class = JPEGCompress(**(jpeg_params or {}))

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_jpeg_quality": self.jpeg_class.compression_range[0],
                "max_jpeg_quality": self.jpeg_class.compression_range[1],
                "min_qpi": self.jm_class.compression_range[0],
                "max_qpi": self.jm_class.compression_range[1]}

    def batch_apply(self, generator, imgs, views: int = 1):
        use_jm = torch.rand(imgs.shape[0] // views, generator=generator,
                            device=generator.device) < 0.5
        jm_out, jm_meta = self.jm_class.batch_apply(generator, imgs, views)
        jp_out, jp_meta = self.jpeg_class.batch_apply(generator, imgs, views)
        out = torch.where(per_view(use_jm, views)[:, None, None, None], jm_out, jp_out)
        zeros = torch.zeros_like(jm_meta["qpi"])
        return out, {"jm_qpi": torch.where(use_jm, jm_meta["qpi"], zeros),
                     "jpeg_quality": torch.where(use_jm, zeros, jp_meta["quality"])}


@register_tool("ffmpegcompress")
class FFMPEGCompress(JMCompress):
    """libx264 through ffmpeg on the host (not ported; its qp shift applies
    there only); its device path is ``JMCompress``'s, as in the JAX package."""

    def __init__(self, qpi=28, shift_encoder_qp=False, qp_shift_value=3, **kwargs):
        super().__init__(qpi=qpi, **kwargs)
