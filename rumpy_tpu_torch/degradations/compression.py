"""Compression degradation ops.

Port of ``rumpy_tpu/degradations/compression.py``:

* ``JPEGCompress``: device path the DCT codec of ``ops/jpeg.py`` with a
  per-example quality (fixed, or uniform over ``compression_range``); host
  path Pillow's libjpeg with ``subsampling=0`` (it needs PIL). Metadata
  ``quality``, normalized by the range.
* ``JMCompress``: device path the H.264-intra approximation of
  ``ops/jpeg.py``; host path the JM ``lencod`` binary where ``jm_bin`` (or
  ``RUMPY_TPU_JM_BIN``) names one, else the native H.264 intra codec of
  ``native/rumpy_native.cpp`` (``native.py``), whose build failure raises.
  Metadata ``qpi``.
* ``RandomCompress``: JM or JPEG per image with probability 1/2, with the
  dual zero-filled columns ``jm_qpi`` / ``jpeg_quality``.
* ``FFMPEGCompress``: host path ffmpeg's libx264 with the optional qp
  shift; without an ``ffmpeg`` binary, the H.264-intra approximation on the
  host device, as in the JAX package. Its device path is ``JMCompress``'s.

Host draws (quality, qpi, the coin) come from the op's ``host_rng``.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from rumpy_tpu_torch.degradations.base import (DegradationOp, from_float_array, normalize,
                                               per_view, to_float_array)
from rumpy_tpu_torch.ops import jpeg as jpeg_ops
from rumpy_tpu_torch.parallel.mesh import take_rows
from rumpy_tpu_torch.registry import register_tool


def _pil_image():
    """PIL's ``Image`` module, which the host codecs need."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this host path needs PIL (Pillow): libjpeg, the JM binary's "
                          "YCbCr planes and ffmpeg's image files go through it") from e
    return Image


def pil_jpeg_roundtrip(image, quality: int):
    """A PIL image through libjpeg at ``quality``, 4:4:4."""
    buffer = io.BytesIO()
    image.save(buffer, "JPEG", subsampling=0, quality=int(quality))
    buffer.seek(0)
    out = _pil_image().open(buffer)
    out.load()
    return out


def _as_pil(image, arr, was_pil):
    return image if was_pil else _pil_image().fromarray((arr * 255).astype(np.uint8))


def _h264_approximation(arr: np.ndarray, qp, was_pil: bool, device):
    """The device path's H.264-intra approximation on one float image."""
    x = torch.from_numpy(np.ascontiguousarray(arr))[None].to(device)
    out = jpeg_ops.h264_intra_compress(x, torch.full((1,), float(qp), device=device))
    return from_float_array(out[0].cpu().numpy(), was_pil)


class _Codec(DegradationOp):
    """Fixed or per-example random level in ``compression_range``."""

    def _levels(self, generator, b: int, fixed, rows=None) -> torch.Tensor:
        dev = generator.device
        if self.random_compression:
            lo, hi = self.compression_range
            return take_rows(torch.randint(lo, hi + 1, (b if rows is None else rows.total,),
                                           generator=generator, device=dev), rows
                             ).to(torch.float32)
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

    def __call__(self, image):
        if self.random_compression:
            quality = int(self.host_rng.randint(self.compression_range[0],
                                                self.compression_range[1] + 1))
        else:
            quality = self.quality
        arr, was_pil = to_float_array(image)
        out = pil_jpeg_roundtrip(_as_pil(image, arr, was_pil), quality)
        return (out if was_pil else np.asarray(out)), {"quality": self._norm(quality)}

    def batch_apply(self, generator, imgs, views: int = 1, rows=None):
        quality = self._levels(generator, imgs.shape[0] // views, self.quality, rows)
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
        self.verbose = verbose
        self.jm_bin = jm_bin or os.environ.get("RUMPY_TPU_JM_BIN")

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_qpi": self.compression_range[0],
                "max_qpi": self.compression_range[1]}

    def _pick_qpi(self) -> int:
        if self.random_compression:
            return int(self.host_rng.randint(self.compression_range[0],
                                              self.compression_range[1] + 1))
        return self.qpi

    def _jm_binary_compress(self, pil, qpi: int):
        """The JM ``lencod`` binary on 4:2:0 planes with pure-intra settings
        (NumberBFrames=0, IDRPeriod=1, IntraPeriod=1); an odd edge is cropped."""
        Image = _pil_image()
        with tempfile.TemporaryDirectory() as td:
            yuv = os.path.join(td, "in.yuv")
            rec = os.path.join(td, "rec.yuv")
            h264 = os.path.join(td, "out.h264")
            w, h = pil.size
            if h % 2 or w % 2:
                h -= h % 2
                w -= w % 2
                pil = pil.crop((0, 0, w, h))
            ycc = np.asarray(pil.convert("YCbCr"))
            with open(yuv, "wb") as f:
                f.write(ycc[..., 0].tobytes() + ycc[::2, ::2, 1].tobytes()
                        + ycc[::2, ::2, 2].tobytes())
            cmd = (f"{self.jm_bin}/lencod.exe -d {self.jm_bin}/encoder_baseline.cfg "
                   f"-p InputFile={yuv} -p OutputFile={h264} -p ReconFile={rec} "
                   f"-p NumberBFrames=0 -p IDRPeriod=1 -p IntraPeriod=1 "
                   f"-p QPISlice={qpi} -p SourceHeight={h} -p SourceWidth={w} "
                   f"-p FramesToBeEncoded=1")
            subprocess.run(cmd.split(), check=True, capture_output=not self.verbose)
            data = np.fromfile(rec, dtype=np.uint8)
            n, q = h * w, h * w // 4
            y2 = data[:n].reshape(h, w)
            cb2 = data[n:n + q].reshape(h // 2, w // 2)
            cr2 = data[n + q:n + 2 * q].reshape(h // 2, w // 2)
            cb2 = np.repeat(np.repeat(cb2, 2, 0), 2, 1)[:h, :w]
            cr2 = np.repeat(np.repeat(cr2, 2, 0), 2, 1)[:h, :w]
            return Image.fromarray(np.stack([y2, cb2, cr2], -1), "YCbCr").convert("RGB")

    def __call__(self, image):
        qpi = self._pick_qpi()
        arr, was_pil = to_float_array(image)
        if self.jm_bin:
            out = self._jm_binary_compress(_as_pil(image, arr, was_pil), qpi)
            return (out if was_pil else np.asarray(out)), {"qpi": self._norm(qpi)}
        from rumpy_tpu_torch.native import h264_intra
        u8 = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        h, w = u8.shape[:2]
        ev_h, ev_w = h - h % 2, w - w % 2
        u8 = u8.copy()
        u8[:ev_h, :ev_w] = h264_intra(u8[:ev_h, :ev_w], qpi)
        if was_pil:
            return _pil_image().fromarray(u8), {"qpi": self._norm(qpi)}
        return u8, {"qpi": self._norm(qpi)}

    def batch_apply(self, generator, imgs, views: int = 1, rows=None):
        qpi = self._levels(generator, imgs.shape[0] // views, self.qpi, rows)
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

    def bind_host(self, device, rng=None) -> None:
        super().bind_host(device, rng)
        self.jm_class.bind_host(device, rng)
        self.jpeg_class.bind_host(device, rng)

    def __call__(self, image):
        if self.host_rng.uniform() < 0.5:
            out, meta = self.jm_class(image)
            meta["jm_qpi"] = meta.pop("qpi")
        else:
            out, meta = self.jpeg_class(image)
            meta["jpeg_quality"] = meta.pop("quality")
        return out, {**{"jm_qpi": 0, "jpeg_quality": 0}, **meta}

    def batch_apply(self, generator, imgs, views: int = 1, rows=None):
        b = imgs.shape[0] // views
        use_jm = take_rows(torch.rand(b if rows is None else rows.total, generator=generator,
                                      device=generator.device), rows) < 0.5
        jm_out, jm_meta = self.jm_class.batch_apply(generator, imgs, views, rows)
        jp_out, jp_meta = self.jpeg_class.batch_apply(generator, imgs, views, rows)
        out = torch.where(per_view(use_jm, views)[:, None, None, None], jm_out, jp_out)
        zeros = torch.zeros_like(jm_meta["qpi"])
        return out, {"jm_qpi": torch.where(use_jm, jm_meta["qpi"], zeros),
                     "jpeg_quality": torch.where(use_jm, zeros, jp_meta["quality"])}


@register_tool("ffmpegcompress")
class FFMPEGCompress(JMCompress):
    """libx264 through ffmpeg on the host, with the optional encoder qp
    shift; the H.264-intra approximation on the host device without an
    ``ffmpeg`` binary. Its device path is ``JMCompress``'s."""

    def __init__(self, qpi=28, shift_encoder_qp=False, qp_shift_value=3, **kwargs):
        super().__init__(qpi=qpi, **kwargs)
        self.shift_encoder_qp = shift_encoder_qp
        self.qp_shift_value = qp_shift_value
        self.ffmpeg = shutil.which("ffmpeg")

    def __call__(self, image):
        qpi = self._pick_qpi()
        enc_qp = qpi + self.qp_shift_value if self.shift_encoder_qp else qpi
        arr, was_pil = to_float_array(image)
        if self.ffmpeg:
            out = self._ffmpeg_roundtrip(_as_pil(image, arr, was_pil), enc_qp)
            out = out if was_pil else np.asarray(out)
        else:
            out = _h264_approximation(arr, enc_qp, was_pil, self._host_device())
        return out, {"qpi": self._norm(qpi)}

    def _ffmpeg_roundtrip(self, pil, qp: int):
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "in.png")
            enc = os.path.join(td, "out.h264")
            dec = os.path.join(td, "dec.png")
            pil.save(src)
            subprocess.run([self.ffmpeg, "-y", "-loglevel", "error", "-i", src,
                            "-vcodec", "libx264", "-profile:v", "baseline",
                            "-qp", str(qp), "-pix_fmt", "yuv420p", enc], check=True)
            subprocess.run([self.ffmpeg, "-y", "-loglevel", "error", "-i", enc, dec],
                           check=True)
            out = _pil_image().open(dec)
            out.load()
            return out
