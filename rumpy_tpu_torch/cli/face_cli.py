"""Face-tool CLIs: ``find_faces`` and ``face_segment``.

Port of ``rumpy_tpu/cli/face_cli.py`` over ``argparse``, with the same
flags and ``--device``. Both need user-supplied weights (YOLO darknet
files; a BiSeNet checkpoint or its npz) and exit with the gating message
without them. They read image files through PIL or uint8 ``.npy`` arrays,
and write what they read: a ``.npy`` input gives ``.npy`` outputs.

    python -m rumpy_tpu_torch.cli.face_cli face_segment -i faces -o parsed \\
        --weights bisenet.npz
    python -m rumpy_tpu_torch.cli.face_cli find_faces -i photos -o crops \\
        --yolo_cfg face.cfg --yolo_weights face.weights
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from rumpy_tpu_torch.data.datasets import _decode as _read

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
_ARRAY_EXT = ".npy"


def _write(arr: np.ndarray, path: str) -> None:
    if path.lower().endswith(_ARRAY_EXT):
        np.save(path, arr)
    else:
        from PIL import Image
        Image.fromarray(arr).save(path)


def _inputs(input_dir: str, exts) -> list:
    return [n for n in sorted(os.listdir(input_dir)) if n.lower().endswith(exts)]


def _blend(a: np.ndarray, b: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """``PIL.Image.blend``: a + alpha * (b - a) in float32, truncated."""
    out = a.astype(np.float32) + np.float32(alpha) * (b.astype(np.float32) - a.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def find_faces(argv: Optional[Sequence[str]] = None) -> int:
    """Detect and crop faces from a folder of images."""
    p = argparse.ArgumentParser(prog="find_faces", description=find_faces.__doc__)
    p.add_argument("--input_dir", "-i", required=True)
    p.add_argument("--output_dir", "-o", required=True)
    p.add_argument("--yolo_cfg", default=None)
    p.add_argument("--yolo_weights", default=None)
    p.add_argument("--margin", default=0.2, type=float)
    args = p.parse_args(argv)
    from rumpy_tpu_torch.utils.face_tools import YoloFaceDetector, crop_faces
    try:
        det = YoloFaceDetector(args.yolo_cfg, args.yolo_weights)
    except NotImplementedError as e:
        sys.exit(f"Error: {e}")
    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for name in _inputs(args.input_dir, (".png", ".jpg", ".jpeg", _ARRAY_EXT)):
        img = _read(os.path.join(args.input_dir, name))
        stem, ext = os.path.splitext(name)
        out_ext = _ARRAY_EXT if ext.lower() == _ARRAY_EXT else ".png"
        for j, crop in enumerate(crop_faces(img, det, args.margin)):
            _write(np.ascontiguousarray(crop),
                   os.path.join(args.output_dir, f"{stem}_face{j}{out_ext}"))
            count += 1
    print(f"saved {count} face crops to {args.output_dir}")
    return count


def face_segment(argv: Optional[Sequence[str]] = None) -> int:
    """BiSeNet face parsing over a folder of aligned faces: a colourised
    parsing map an image, resized back to the image's size."""
    p = argparse.ArgumentParser(prog="face_segment", description=face_segment.__doc__)
    p.add_argument("--input_dir", "-i", required=True)
    p.add_argument("--output_dir", "-o", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--save_superimposed_images", action="store_true",
                   help="Additionally save inputs blended with the parsing map.")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without it).")
    args = p.parse_args(argv)
    from rumpy_tpu_torch.ops.resize import pil_resize
    from rumpy_tpu_torch.utils.face_segmentation import BiSeNetSegmenter, colorize_parsing
    try:
        seg = BiSeNetSegmenter(args.weights, device=args.device)
    except NotImplementedError as e:
        sys.exit(f"Error: {e}")
    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for name in _inputs(args.input_dir, _IMAGE_EXTS + (_ARRAY_EXT,)):
        img = _read(os.path.join(args.input_dir, name))
        parsing = seg.parse(img)
        vis = torch.from_numpy(colorize_parsing(parsing)).to(seg.device)
        vis = pil_resize(vis, img.shape[:2], filter="bilinear").cpu().numpy()
        _write(vis, os.path.join(args.output_dir, name))
        if args.save_superimposed_images:
            base, ext = os.path.splitext(name)
            _write(_blend(img, vis), os.path.join(args.output_dir, f"{base}_superimposed{ext}"))
        count += 1
    print(f"segmented {count} images into {args.output_dir}")
    return count


if __name__ == "__main__":
    commands = {"find_faces": find_faces, "face_segment": face_segment}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        sys.exit(f"usage: python -m rumpy_tpu_torch.cli.face_cli "
                 f"{{{','.join(commands)}}} [options]")
    commands[sys.argv[1]](sys.argv[2:])
