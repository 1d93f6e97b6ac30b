"""image_manipulate CLI: offline degradation of a folder of images.

Port of ``rumpy_tpu/cli/image_manipulate.py`` over ``argparse``, with the
same flags and ``--device``: runs a TOML-configured degradation pipeline
over a folder (``degradations/pipeline.py::pipeline_prep_and_run``) and
writes the degraded images, ``degradation_metadata.csv``,
``degradation_hyperparameters.csv`` and ``degradation_config.toml``. The
ops' tensor work runs on the card unless ``--device cpu``. Without PIL it
reads and writes uint8 ``.npy`` images.

    python -m rumpy_tpu_torch.cli.image_manipulate -p chain.toml \\
        -s hr_dir -o lr_dir --seed 8 --multiples 2
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from rumpy_tpu_torch.config.loader import load_config
from rumpy_tpu_torch.degradations.pipeline import pipeline_prep_and_run


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image_manipulate",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--pipeline_config", "-p", required=True, help="TOML pipeline config.")
    p.add_argument("--source_dir", "-s", default=None)
    p.add_argument("--output_dir", "-o", default=None)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--multiples", default=None, type=int,
                   help="Degraded copies to generate per image (_qN suffixes).")
    p.add_argument("--recursive", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without it).")
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = _parser().parse_args(argv)
    cfg = load_config(args.pipeline_config).as_plain()
    kwargs = {}
    if args.source_dir:
        kwargs["source_dir"] = args.source_dir
    if args.output_dir:
        kwargs["output_dir"] = args.output_dir
    if args.seed is not None:
        kwargs["seed"] = args.seed
    if args.multiples is not None:
        kwargs["multiples"] = args.multiples
    out = pipeline_prep_and_run(cfg, recursive=args.recursive, device=args.device, **kwargs)
    print(f"degraded images written to {out}")
    return out


if __name__ == "__main__":
    main()
