"""Image saving and comparison figures.

Port of ``rumpy_tpu/utils/visualization.py``: ``to_uint8_rgb`` and
``safe_image_save`` (an output as a uint8 PNG), ``interpret_sisr_images``
(a captioned collage of one image's outputs, ``EvalHub``'s gallery),
``compare_training_curves`` (one metric of several experiments' summary.csv
files) and ``crop_zoom_figure`` (each output with a crop box and the crop
zoomed below it). PIL and matplotlib are imported inside the functions that
use them, so the module imports where neither is installed; a function
whose library is missing raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import os

from typing import Dict, Optional

import numpy as np
import torch

from rumpy_tpu_torch.utils.color import ycbcr_to_rgb
from rumpy_tpu_torch.utils.stats import load_statistics


def to_uint8_rgb(img, colorspace: str = "rgb") -> np.ndarray:
    """(H, W, C) float [0, 1] (numpy or tensor; the first image of a batch)
    as uint8 RGB: YCbCr converted, one channel repeated, then clipped and
    scaled with truncation, not rounding, as the JAX package saves."""
    img = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if colorspace == "ycbcr" and img.shape[-1] == 3:
        img = ycbcr_to_rgb(torch.from_numpy(np.asarray(img, np.float32)),
                           im_type="jpg").numpy()
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def safe_image_save(img, out_dir: str, name: str, colorspace: str = "rgb") -> str:
    """Write ``img`` as ``out_dir/name`` (``.png`` added where missing)
    through PIL; raises ImportError naming PIL where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("saving images needs PIL (Pillow), which is not "
                          "installed") from e
    os.makedirs(out_dir, exist_ok=True)
    u8 = to_uint8_rgb(img, colorspace)
    path = os.path.join(out_dir, name if name.lower().endswith(".png") else name + ".png")
    Image.fromarray(u8).save(path)
    return path


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; an ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, plt, out_path: str) -> str:
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def interpret_sisr_images(images: Dict[str, object], out_path: str,
                          captions: Optional[Dict[str, str]] = None, ncols: int = 3) -> str:
    """A collage of one panel an image (``ncols`` a row), titled with its
    name and, below it, its caption, written to ``out_path``."""
    plt = pyplot()
    n = len(images)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows), squeeze=False)
    for i, (name, img) in enumerate(images.items()):
        ax = axes[i // ncols][i % ncols]
        ax.imshow(to_uint8_rgb(img))
        title = name
        if captions and name in captions:
            title += f"\n{captions[name]}"
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    return _save(fig, plt, out_path)


def compare_training_curves(experiment_dirs: Dict[str, str], out_path: str,
                            metric: str = "val-PSNR") -> str:
    """``metric`` against the summary.csv row of each experiment's log
    folder, one curve a label; a folder without the file or the column
    adds no curve."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, log_dir in experiment_dirs.items():
        stats = load_statistics(log_dir)
        if stats is None or metric not in stats:
            continue
        ax.plot(np.arange(len(stats[metric])), stats[metric], label=label)
    ax.set_xlabel("Epoch")
    ax.set_ylabel(metric)
    ax.grid(True)
    ax.legend()
    return _save(fig, plt, out_path)


def crop_zoom_figure(images: Dict[str, object], crop_box, out_path: str,
                     colorspace: str = "rgb") -> str:
    """Each image with the crop ``(top, left, height, width)`` outlined in
    red, and the crop zoomed (nearest neighbour) below it."""
    plt = pyplot()
    from matplotlib import patches

    top, left, ch, cw = crop_box
    n = len(images)
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 8), squeeze=False)
    for i, (name, img) in enumerate(images.items()):
        rgb = to_uint8_rgb(img, colorspace)
        ax = axes[0][i]
        ax.imshow(rgb)
        ax.add_patch(patches.Rectangle((left, top), cw, ch, linewidth=2,
                                       edgecolor="red", facecolor="none"))
        ax.set_title(name, fontsize=10)
        ax.axis("off")
        axz = axes[1][i]
        axz.imshow(rgb[top:top + ch, left:left + cw], interpolation="nearest")
        axz.axis("off")
    return _save(fig, plt, out_path)
