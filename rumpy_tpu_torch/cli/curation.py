"""Model-curation CLIs: model_report, extract_best_model, clean_models and
images_to_video.

Port of ``rumpy_tpu/cli/curation.py`` over ``argparse`` and the ``csv``
module, with the same options: report every experiment of a results folder
and its best metric (``model_report.csv``, the columns and cells pandas
writes for the JAX package); export a deployable folder of an experiment's
config, best checkpoint and summary; prune checkpoints, keeping best-1,
best, best+1 and the last; stitch PNG frames into a video with ffmpeg.

    python -m rumpy_tpu_torch.cli.curation model_report -r Results
    python -m rumpy_tpu_torch.cli.curation extract_best_model -b Results/exp -o deploy
    python -m rumpy_tpu_torch.cli.curation clean_models -r Results --dry_run
    python -m rumpy_tpu_torch.cli.curation images_to_video -i frames -o out.mp4
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

from rumpy_tpu_torch.config.constants import metric_best_val
from rumpy_tpu_torch.utils.checkpoint import available_epochs, checkpoint_path, select_epoch
from rumpy_tpu_torch.utils.csv_text import csv_cells, write_rows


def _experiments(results_loc):
    for name in sorted(os.listdir(results_loc)):
        exp = os.path.join(results_loc, name)
        if os.path.isdir(os.path.join(exp, "saved_models")):
            yield name, exp


def _best_epoch(exp_dir, metric="val-PSNR"):
    models = os.path.join(exp_dir, "saved_models")
    summary = os.path.join(exp_dir, "result_outputs", "summary.csv")
    return select_epoch(models, "best", summary, metric)


def _numbers(cells: List[str]) -> list:
    """A CSV column as pandas reads it: integers where every cell is one,
    else floats, an empty cell NaN."""
    try:
        return [int(c) for c in cells]
    except ValueError:
        return [float(c) if c.strip() else math.nan for c in cells]


def _best_row(summary: str, metric: str):
    """(best value, its epoch) of ``metric`` in ``summary``: the first row
    of the column's max (min for a metric whose best is the least),
    missing values skipped, its ``epoch`` cell (else its row number);
    (None, None) without the column or a value."""
    with open(summary, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        columns = reader.fieldnames or []
    if metric not in columns:
        return None, None
    values = _numbers([r[metric] for r in rows])
    present = [i for i, v in enumerate(values) if not math.isnan(v)]
    if not present:
        return None, None
    pick = max if metric_best_val.get(metric, "max") == "max" else min
    idx = pick(present, key=lambda i: values[i])  # the first of equals
    epoch = int(_numbers([r["epoch"] for r in rows])[idx]) if "epoch" in columns else idx
    return values[idx], epoch


def model_report(results_loc: str, metric: str = "val-PSNR") -> List[dict]:
    """Every experiment of ``results_loc``: its checkpoints, last epoch,
    best epoch and best ``metric``; printed and written to
    ``results_loc/model_report.csv``. Returns the rows."""
    rows = []
    for name, exp in _experiments(results_loc):
        eps = available_epochs(os.path.join(exp, "saved_models"))
        summary = os.path.join(exp, "result_outputs", "summary.csv")
        best_val, best_ep = _best_row(summary, metric) if os.path.isfile(summary) else (None,
                                                                                         None)
        rows.append({"experiment": name, "checkpoints": len(eps),
                     "last_epoch": eps[-1] if eps else None,
                     "best_epoch": best_ep, f"best_{metric}": best_val})
    columns = list(rows[0]) if rows else []
    cells = [csv_cells([r[c] for r in rows]) for c in columns]
    table = [columns] + [[col[i] for col in cells] for i in range(len(rows))]
    widths = [max(len(t[j]) for t in table) for j in range(len(columns))]
    for line in table:
        print(" ".join(c.rjust(w) for c, w in zip(line, widths)))
    write_rows(os.path.join(results_loc, "model_report.csv"), table if rows else [[]])
    return rows


def extract_best_model(base_folder: str, output: str, metric: str = "val-PSNR") -> int:
    """The experiment's config.toml, best checkpoint and summary.csv copied
    into ``output`` as a deployable experiment folder. Returns the epoch."""
    best = _best_epoch(base_folder, metric)
    os.makedirs(os.path.join(output, "saved_models"), exist_ok=True)
    shutil.copy(checkpoint_path(os.path.join(base_folder, "saved_models"), best),
                checkpoint_path(os.path.join(output, "saved_models"), best))
    src = os.path.join(base_folder, "config.toml")
    if os.path.isfile(src):
        shutil.copy(src, os.path.join(output, "config.toml"))
    summary = os.path.join(base_folder, "result_outputs", "summary.csv")
    if os.path.isfile(summary):
        os.makedirs(os.path.join(output, "result_outputs"), exist_ok=True)
        shutil.copy(summary, os.path.join(output, "result_outputs", "summary.csv"))
    print(f"extracted epoch {best} -> {output}")
    return best


def clean_models(results_loc: str, metric: str = "val-PSNR", dry_run: bool = False) -> List[str]:
    """Every experiment's checkpoints but best-1, best, best+1 and the last
    removed (listed only, with ``dry_run``). An experiment whose best epoch
    cannot be read is skipped and keeps them all. Returns the paths."""
    paths = []
    for name, exp in _experiments(results_loc):
        models = os.path.join(exp, "saved_models")
        eps = available_epochs(models)
        if not eps:
            continue
        try:
            best = _best_epoch(exp, metric)
        except (FileNotFoundError, ValueError) as e:
            print(f"skipping {name}: {e}")
            continue
        keep = {best - 1, best, best + 1, eps[-1]}
        for e in eps:
            if e in keep:
                continue
            path = checkpoint_path(models, e)
            print(f"{'would remove' if dry_run else 'removing'} {path}")
            if not dry_run:
                os.remove(path)
            paths.append(path)
    return paths


def images_to_video(input_dir: str, output: str, fps: int = 25) -> str:
    """The folder's PNG frames, in name order, as an H.264 video (ffmpeg)."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError("ffmpeg not found on PATH")
    subprocess.run([ffmpeg, "-y", "-framerate", str(fps), "-pattern_type", "glob", "-i",
                    os.path.join(input_dir, "*.png"), "-c:v", "libx264", "-pix_fmt",
                    "yuv420p", output], check=True)
    print(f"wrote {output}")
    return output


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path '{path}' does not exist.")
    return path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="curation", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    c = sub.add_parser("model_report", help=model_report.__doc__.split("\n")[0])
    c.add_argument("--results_loc", "-r", required=True, type=_existing)
    c.add_argument("--metric", default="val-PSNR")
    c = sub.add_parser("extract_best_model", help="Export config + best checkpoint.")
    c.add_argument("--base_folder", "-b", required=True, type=_existing)
    c.add_argument("--output", "-o", required=True)
    c.add_argument("--metric", default="val-PSNR")
    c = sub.add_parser("clean_models", help="Prune checkpoints keeping best+-1 and last.")
    c.add_argument("--results_loc", "-r", required=True, type=_existing)
    c.add_argument("--metric", default="val-PSNR")
    c.add_argument("--dry_run", action=argparse.BooleanOptionalAction, default=False)
    c = sub.add_parser("images_to_video", help="Stitch PNG frames into a video (ffmpeg).")
    c.add_argument("--input_dir", "-i", required=True, type=_existing)
    c.add_argument("--output", "-o", required=True)
    c.add_argument("--fps", type=int, default=25)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``curation COMMAND [options]``; exits 1 with ``Error: ...`` where a
    command fails (ffmpeg missing, no best epoch)."""
    args = vars(_parser().parse_args(argv))
    command = globals()[args.pop("command")]
    try:
        command(**args)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
