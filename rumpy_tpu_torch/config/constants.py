"""Framework-wide constants (the part of ``rumpy_tpu/config/constants.py``
this port uses so far): dataset splits, metric directions and the
blur-kernel code table of the degradation metadata."""

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


class TwoWayDict(dict):
    """Bidirectional code table: name -> code and code -> name."""

    def __init__(self, mapping):
        super().__init__()
        for k, v in mapping.items():
            self[k] = v
            self[v] = k

    def __len__(self):
        return super().__len__() // 2


# Blur-kernel-family integer codes used in degradation metadata.
blur_kernel_codes = TwoWayDict({
    "iso": 0,
    "aniso": 1,
    "generalized_iso": 2,
    "generalized_aniso": 3,
    "plateau_iso": 4,
    "plateau_aniso": 5,
    "sinc": 6,
})
