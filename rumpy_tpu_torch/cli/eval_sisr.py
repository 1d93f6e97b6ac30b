"""eval_sisr CLI.

Port of ``rumpy_tpu/cli/eval_sisr.py`` over ``argparse``, with the same
flags and TOML schema: the config file is optional, flags override it.
Builds an ``EvalHub`` on the card (``--device cpu`` for the CPU), runs
``full_image_protocol``, writes ``individual_metrics.csv`` and
``average_metrics.csv`` into ``out_loc`` and prints the mean row.

    python -m rumpy_tpu_torch.cli.eval_sisr --model_loc Results \\
        --out_loc Results/eval --lr_dir lr --hr_dir hr -me rcan_x4 best

Config schema:
  [data]            lr_dir / hr_dir / scale ...
  [[models]]        experiment = "...", epoch = "best"|"last"|N, label = ...
                    (or models = [names] with a parallel load_epochs list)
  out_loc, model_loc, metrics = ["PSNR", "SSIM"], save_im, time_models ...

``--metadata_file`` (or ``metadata_file`` in ``[data]``) gives the images
their degradation metadata from a CSV (``on_site``: the LR folder's
``degradation_metadata.csv``). Options of later slices raise
``NotImplementedError``: ``--lpips_weights`` (ROADMAP queue 1 item 9),
``--gallery`` and the ``--fr_*`` face-recognition options (item 10).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from rumpy_tpu_torch.config.loader import load_config, merge_overrides

# option -> ROADMAP queue 1 item that ports it
_LATER = {"lpips_weights": "9", "gallery": "10",
          "fr_gallery": "10", "fr_extractor": "10", "fr_extractor_weights": "10"}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eval_sisr", description=__doc__.split("\n\n")[0])
    flag = argparse.BooleanOptionalAction
    p.add_argument("--config", "-c", default=None,
                   help="TOML eval config (optional; flags also fully specify a run).")
    p.add_argument("--out_loc", default=None)
    p.add_argument("--model_loc", default=None)
    p.add_argument("--scale", default=None, type=int)
    p.add_argument("--hr_dir", default=None, help="HR image directory.")
    p.add_argument("--lr_dir", default=None, help="LR image directory.")
    p.add_argument("--metadata_file", default=None,
                   help="Degradation-metadata CSV ('on_site' resolves to "
                        "<lr_dir>/degradation_metadata.csv).")
    p.add_argument("--dataset_name", default=None, help="Named dataset (its eval split).")
    p.add_argument("--data_split", default=None, help="Split name within --dataset_name.")
    p.add_argument("--group_select", action="append", type=int, default=None,
                   help="Keep only _qN group tags (repeatable).")
    p.add_argument("--qpi_selection", nargs=2, type=float, default=None,
                   help="Keep images whose QPI falls in this range.")
    p.add_argument("--ignore_degradation_location", action="store_true")
    p.add_argument("--recursive", action="store_true", help="Recurse into LR subdirectories.")
    p.add_argument("--model_and_epoch", "-me", nargs=2, action="append", default=[],
                   metavar=("EXPERIMENT", "EPOCH"),
                   help="Model experiment + epoch (best|last|N); repeatable.")
    p.add_argument("--metrics", "-m", action="append", default=[],
                   help="Metric to compute (PSNR, SSIM, face_PSNR, true_face_PSNR); "
                        "repeatable.")
    p.add_argument("--save_im", action=flag, default=None)
    p.add_argument("--gallery", action=flag, default=None,
                   help="Per-image comparison collages (not ported yet).")
    p.add_argument("--no_image_comparison", action="store_true", default=None)
    p.add_argument("--lanczos_upsample", action="store_true", default=None)
    p.add_argument("--time_models", action=flag, default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--fr_gallery", default=None)
    p.add_argument("--fr_extractor", default=None)
    p.add_argument("--fr_extractor_weights", default=None)
    p.add_argument("--pad_to_bucket", default=None, type=int,
                   help="Zero-pad model inputs up to the next multiple of N px "
                        "(output cropped back before the metrics).")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without it).")
    return p


def main(argv: Optional[Sequence[str]] = None):
    p = _parser()
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else {}
    cfg = merge_overrides(cfg, {k: getattr(args, k) for k in (
        "out_loc", "model_loc", "scale", "save_im", "gallery", "time_models",
        "no_image_comparison", "lanczos_upsample", "lpips_weights", "fr_gallery",
        "fr_extractor", "fr_extractor_weights", "pad_to_bucket")
        if getattr(args, k) is not None})

    data = dict(cfg.get("data") or {})
    for key, val in (("hr_dir", args.hr_dir), ("lr_dir", args.lr_dir),
                     ("metadata_file", args.metadata_file),
                     ("dataset", args.dataset_name), ("split", args.data_split),
                     ("qpi_selection", args.qpi_selection)):
        if val is not None:
            data[key] = val
    if args.group_select:
        data["group_select"] = list(args.group_select)
    if args.ignore_degradation_location:
        data["ignore_degradation_location"] = True
    if args.recursive:
        data["recursive_search"] = True
    for key, item in _LATER.items():
        if cfg.get(key):
            raise NotImplementedError(f"--{key} is not ported yet: it comes with "
                                      f"ROADMAP queue 1 item {item}")

    models = list(cfg.get("models") or [])
    # [[models]] tables, or plain experiment names with a load_epochs list
    if models and not isinstance(models[0], dict):
        epochs = list(cfg.get("load_epochs") or [])
        models = [{"experiment": name, "epoch": epochs[i] if i < len(epochs) else "best"}
                  for i, name in enumerate(models)]
    for name, epoch in args.model_and_epoch:
        models.append({"experiment": name,
                       "epoch": int(epoch) if epoch.isdigit() else epoch})
    if not models:
        p.error("No models specified: pass -me EXPERIMENT EPOCH or a config "
                "with a [[models]] table")
    if not cfg.get("model_loc") or not cfg.get("out_loc"):
        p.error("model_loc and out_loc are required")

    from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
    hub = EvalHub(
        models=[dict(m) for m in models],
        model_loc=cfg["model_loc"],
        data_cfg=data,
        out_loc=cfg["out_loc"],
        scale=cfg.get("scale") or 4,
        metrics=list(args.metrics) or list(cfg.get("metrics") or ["PSNR", "SSIM"]),
        save_im=bool(cfg.get("save_im")),
        lanczos_upsample=bool(cfg.get("lanczos_upsample")),
        time_models=bool(cfg.get("time_models")),
        no_image_comparison=bool(cfg.get("no_image_comparison")),
        pad_to_bucket=cfg.get("pad_to_bucket"),
        device=args.device)
    table = hub.full_image_protocol()
    print(table.mean_string())
    return table


if __name__ == "__main__":
    main()
