"""Framework-wide constants (the part of ``rumpy_tpu/config/constants.py``
this port uses so far)."""

# Dataset split conventions: index ranges into a sorted file listing.
dataset_splits = {
    "celeba": {"train": (0, 162770), "eval": (162770, 182637), "test": (182637, 202599)},
    "div2k": {"train": (0, 800), "eval": (800, 900)},
    "flickr2k": {"train": (0, 2650)},
}

# Direction in which each metric improves; used for best-epoch selection
# when resuming/curating checkpoints.
metric_best_val = {
    "val-PSNR": "max",
    "val-SSIM": "max",
    "val-LPIPS": "min",
    "val-loss": "min",
    "train-loss": "min",
}
