"""train_sisr CLI.

Port of ``rumpy_tpu/cli/train_sisr.py`` over ``argparse``: loads a TOML
config, merges CLI overrides, copies the config into the experiment dir
(versioned as ``config_from_epoch_N.toml`` on resume), and runs the
experiment on the card (``--device cpu`` for the CPU): SR training, or,
with ``data.task_type = "regression"``, a degradation predictor
(``training/regression_trainer.py``).

    python -m rumpy_tpu_torch.cli.train_sisr -p config.toml
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from rumpy_tpu_torch.config.loader import dump_toml, load_config, merge_overrides


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train_sisr", description=__doc__.split("\n\n")[0])
    p.add_argument("--parameters", "-p", required=True,
                   help="TOML config file for the experiment.")
    p.add_argument("--experiment", default=None, help="Experiment name override.")
    p.add_argument("--num_epochs", default=None, type=int)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--continue_from_epoch", default=None,
                   help="int | best | last: resume point.")
    p.add_argument("--experiment_save_loc", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without it).")
    return p


def main(argv: Optional[Sequence[str]] = None):
    args = _parser().parse_args(argv)
    if not os.path.isfile(args.parameters):
        raise FileNotFoundError(f"config file {args.parameters!r} does not exist")
    cfg = load_config(args.parameters)
    overrides = {"experiment": args.experiment,
                 "experiment_save_loc": args.experiment_save_loc}
    t_over = {"num_epochs": args.num_epochs, "batch_size": args.batch_size,
              "seed": args.seed}
    if args.continue_from_epoch is not None:
        try:
            t_over["continue_from_epoch"] = int(args.continue_from_epoch)
        except ValueError:
            t_over["continue_from_epoch"] = args.continue_from_epoch
    overrides["training"] = {k: v for k, v in t_over.items() if v is not None}
    cfg = merge_overrides(cfg, {k: v for k, v in overrides.items()
                                if v is not None and v != {}})

    task = (cfg.get("data") or {}).get("task_type") or "sisr"
    if task == "regression":
        from rumpy_tpu_torch.training.regression_trainer import (
            RegressionTrainingHandler as Handler)
    else:
        from rumpy_tpu_torch.training.trainer import TrainingHandler as Handler
    handler = Handler(cfg, device=args.device)

    # config copy into the experiment dir
    base = handler.model.base_folder
    if base and not cfg.get("no_directories"):
        resume = (cfg.get("training") or {}).get("continue_from_epoch")
        name = ("config.toml" if resume is None
                else f"config_from_epoch_{handler.model.model_epoch - 1}.toml")
        dump_toml(cfg, os.path.join(base, name))
        handler.model.save_metadata()

    return handler.run_experiment()


if __name__ == "__main__":
    main()
