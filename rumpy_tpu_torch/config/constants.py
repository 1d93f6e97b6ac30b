"""Framework-wide constants (the part of ``rumpy_tpu/config/constants.py``
this port uses so far)."""

# Direction in which each metric improves; used for best-epoch selection
# when resuming/curating checkpoints.
metric_best_val = {
    "val-PSNR": "max",
    "val-SSIM": "max",
    "val-LPIPS": "min",
    "val-loss": "min",
    "train-loss": "min",
}
