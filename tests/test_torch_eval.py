"""The evaluation slice as a whole, on the CPU: a tiny RCAN x4 experiment
written by the JAX package's TrainingHandler (PNG LR/HR folders, flax
checkpoints, summary.csv with validation columns) evaluated by the JAX
EvalHub and eval_sisr and by the port's, and the port's trainer validation
against the JAX trainer's on the same weights.

Tolerances: model columns 1e-3 dB PSNR and 1e-5 SSIM (two float32
forwards whose sums run in different orders), bicubic 1e-5 dB and 1e-6
SSIM (the same Pillow-exact resize on both sides)."""

import csv
import io
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from rumpy_tpu.cli.eval_sisr import main as jax_eval_main
from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.evaluation.eval_hub import EvalHub as JaxEvalHub
from rumpy_tpu.interface import SISRInterface as JaxSISRInterface
from rumpy_tpu.training.trainer import TrainingHandler as JaxTrainingHandler
from rumpy_tpu.utils import checkpoint as jckpt
from rumpy_tpu_torch.cli import eval_sisr, train_sisr
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.evaluation.eval_hub import EvalHub, MetricTable
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.training.trainer import TrainingHandler
from rumpy_tpu_torch.utils import checkpoint as ckpt

MODEL_PSNR, MODEL_SSIM = 1e-3, 1e-5
BICUBIC_PSNR, BICUBIC_SSIM = 1e-5, 1e-6
SCALE = 4
# LR sides: three of one shape (a validation chunk of 2 and one of 1) and
# an odd one
LR_SHAPES = [(16, 20), (16, 20), (16, 20), (13, 17)]
RCAN = {"scale": SCALE, "n_feats": 16, "n_resgroups": 2, "n_resblocks": 2,
        "reduction": 4, "lr": 1e-3}
EXP = "rcan_jax"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_pairs")
    rng = np.random.default_rng(0)
    lr_dir, hr_dir = root / "lr", root / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k, (h, w) in enumerate(LR_SHAPES):
        yy, xx = np.mgrid[:h * SCALE, :w * SCALE]
        smooth = 128 + 60 * np.sin(xx / (6.0 + k)) * np.cos(yy / 5.0)
        hr = np.clip(smooth[..., None] + 20 * rng.standard_normal((h * SCALE, w * SCALE, 3)),
                     0, 255).astype(np.uint8)
        Image.fromarray(hr).save(hr_dir / f"im{k}.png")
        lr = Image.fromarray(hr).resize((w, h), Image.BICUBIC)
        lr.save(lr_dir / f"im{k}.png")
    return str(lr_dir), str(hr_dir)


def _config(data, save_loc, experiment=EXP, epochs=2):
    lr_dir, hr_dir = data
    return {
        "experiment": experiment,
        "experiment_save_loc": str(save_loc),
        "data": {"scale": SCALE, "crop": 8, "dataloader_threads": 1,
                 "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir}},
                 "eval_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir}}},
        "model": {"name": "rcan", "internal_params": dict(RCAN)},
        "training": {"num_epochs": epochs, "batch_size": 2, "seed": 0,
                     "eval_batch_size": 2},
    }


@pytest.fixture(scope="module")
def experiment(tmp_path_factory, data):
    """Two epochs of the JAX trainer: flax checkpoints 0 and 1, summary.csv
    with val-PSNR and val-SSIM. Returns (model_loc, the JAX handler)."""
    root = tmp_path_factory.mktemp("jax_exp")
    path = root / "train.toml"
    dump_toml(_config(data, root / "Results"), str(path))
    handler = JaxTrainingHandler(jax_load_config(str(path)), verbose=False)
    handler.model.save_metadata()
    stats = handler.run_experiment()
    assert all("val-PSNR" in row for row in stats.values())
    return str(root / "Results"), handler


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def assert_same_metrics(got_dir, want_dir, model, runtime=True):
    """The two directories' CSV files: the same header rows, images and
    column order, the values within the tolerances."""
    for name in ("individual_metrics.csv", "average_metrics.csv"):
        got, want = _read(os.path.join(got_dir, name)), _read(os.path.join(want_dir, name))
        head = 3 if name.startswith("individual") else 2  # model, metric (, image)
        assert got[:head] == want[:head], name
        assert [r[0] for r in got] == [r[0] for r in want], name  # image column
        assert len(got) == len(want) and all(len(r) == len(want[0]) for r in got)
        columns = list(zip(want[0][1:], want[1][1:]))
        assert ("bicubic", "runtime") in columns and (model, "PSNR") in columns
        assert ((model, "runtime") in columns) == runtime
        for g, w in zip(got[head:], want[head:]):
            for (m, metric), gv, wv in zip(columns, g[1:], w[1:]):
                if metric == "runtime":
                    assert float(gv) > 0 and float(wv) > 0
                    continue
                tol = {("bicubic", "PSNR"): BICUBIC_PSNR, ("bicubic", "SSIM"): BICUBIC_SSIM,
                       (model, "PSNR"): MODEL_PSNR, (model, "SSIM"): MODEL_SSIM}[(m, metric)]
                assert abs(float(gv) - float(wv)) <= tol, (name, w[0], m, metric, gv, wv)


def test_eval_hub_matches_jax(tmp_path, data, experiment):
    model_loc, _ = experiment
    lr_dir, hr_dir = data
    kwargs = dict(models=[{"experiment": EXP, "epoch": "best", "label": "rcan"}],
                  model_loc=model_loc, data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir},
                  scale=SCALE, metrics=["PSNR", "SSIM"])
    JaxEvalHub(out_loc=str(tmp_path / "jax"), **kwargs).full_image_protocol()
    table = EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kwargs).full_image_protocol()
    assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), "rcan", runtime=False)
    assert table.images == [f"im{k}.png" for k in range(len(LR_SHAPES))]
    assert all(math.isfinite(v) for row in table.values for v in row)


def test_eval_sisr_cli_matches_jax(tmp_path, data, experiment):
    model_loc, _ = experiment
    lr_dir, hr_dir = data
    flags = ["--model_loc", model_loc, "--scale", str(SCALE), "--lr_dir", lr_dir,
             "--hr_dir", hr_dir, "-me", EXP, "last", "-m", "PSNR", "-m", "SSIM",
             "--time_models", "--save_im"]
    r = CliRunner().invoke(jax_eval_main, flags + ["--out_loc", str(tmp_path / "jax")])
    assert r.exit_code == 0, r.output + repr(r.exception)
    eval_sisr.main(flags + ["--out_loc", str(tmp_path / "port"), "--device", "cpu"])
    assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), EXP)
    for k in range(len(LR_SHAPES)):  # the same PNG names, one per model
        assert os.path.isfile(tmp_path / "port" / EXP / f"im{k}.png")
        got = np.asarray(Image.open(tmp_path / "port" / "bicubic" / f"im{k}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / "bicubic" / f"im{k}.png"))
        assert got.shape == want.shape and np.abs(got.astype(int) - want).max() <= 1


def test_eval_sisr_config_file_and_model_lists(tmp_path, data, experiment):
    """The TOML schema's plain name list with a load_epochs list; the
    config's own metrics; lanczos and bucket padding."""
    model_loc, _ = experiment
    lr_dir, hr_dir = data
    cfg = {"model_loc": model_loc, "out_loc": str(tmp_path / "out"), "scale": SCALE,
           "metrics": ["SSIM"], "lanczos_upsample": True, "pad_to_bucket": 8,
           "data": {"lr_dir": lr_dir, "hr_dir": hr_dir},
           "models": [EXP], "load_epochs": [0]}
    dump_toml(cfg, str(tmp_path / "eval.toml"))
    table = eval_sisr.main(["-c", str(tmp_path / "eval.toml"), "--device", "cpu"])
    assert table.columns == [("bicubic", "SSIM"), ("bicubic", "runtime"),
                             ("lanczos", "SSIM"), ("lanczos", "runtime"), (EXP, "SSIM")]
    hub = JaxEvalHub(models=[{"experiment": EXP, "epoch": 0}], model_loc=model_loc,
                     data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir},
                     out_loc=str(tmp_path / "jax"), scale=SCALE, metrics=["SSIM"],
                     lanczos_upsample=True, pad_to_bucket=8)
    want = hub.full_image_protocol()
    for i, image in enumerate(table.images):
        for j, (m, metric) in enumerate(table.columns):
            if metric != "runtime":
                tol = MODEL_SSIM if m == EXP else BICUBIC_SSIM
                assert abs(table.values[i][j] - want.loc[image, (m, metric)]) <= tol
    with pytest.raises(SystemExit):
        eval_sisr.main(["--model_loc", model_loc, "--out_loc", str(tmp_path)])


def test_csv_layout_is_pandas(tmp_path):
    """MetricTable writes what pandas writes for the JAX package's frames:
    sorted MultiIndex columns, floats as repr, NaN empty, a mean row."""
    rows = {"b.png": {"zeta>PSNR": 31.200000762939453, "bicubic>runtime": 2.5e-07,
                      "bicubic>PSNR": 100.0, "alpha>SSIM": 0.1 + 0.2},
            "a,1.png": {"bicubic>runtime": 0.125, "bicubic>PSNR": 1e-05,
                        "zeta>PSNR": float("nan"), "alpha>SSIM": 1 / 3,
                        "alpha>runtime": 3.0}}
    df = pd.DataFrame.from_dict(rows, orient="index")
    df.index.rename("image", inplace=True)
    df.columns = pd.MultiIndex.from_tuples([tuple(c.split(">", 1)) for c in df.columns],
                                           names=["model", "metric"])
    df = df.sort_index(axis=1)
    table = MetricTable(rows)
    for rows_of, index_name, frame in (
            (list(zip(table.images, table.values)), "image", df),
            ([("mean", table.mean())], None, df.mean(axis=0).to_frame("mean").T)):
        want = io.StringIO()
        frame.to_csv(want)
        path = str(tmp_path / "layout.csv")
        table.write_csv(path, rows_of, index_name)
        with open(path) as f:
            assert f.read() == want.getvalue()


def test_trainer_validation_matches_jax(tmp_path, data, experiment):
    """The port's TrainingHandler.eval on the JAX run's final weights
    against the JAX trainer's eval: eval_batch_size 2 splits the shape
    bucket of three into chunks of 2 and 1."""
    model_loc, jax_handler = experiment
    cfg = _config(data, model_loc, experiment="port_val")
    cfg["no_directories"] = True
    dump_toml(cfg, str(tmp_path / "c.toml"))
    cfg = load_config(str(tmp_path / "c.toml"))
    port = TrainingHandler(cfg, verbose=False, device="cpu")
    state, epoch = port.model.model.load_model(
        os.path.join(model_loc, EXP, "saved_models"), "last", skip_optimizer_load=True)
    assert epoch == 1
    port.model.state = state
    got, want = port.eval(0), jax_handler.eval(0)
    assert sorted(got) == sorted(want) == ["val-PSNR", "val-SSIM"]
    assert abs(got["val-PSNR"] - want["val-PSNR"]) <= MODEL_PSNR
    assert abs(got["val-SSIM"] - want["val-SSIM"]) <= MODEL_SSIM


def test_best_epoch_matches_jax(tmp_path, experiment):
    model_loc, _ = experiment
    save_dir = os.path.join(model_loc, EXP, "saved_models")
    summary = os.path.join(model_loc, EXP, "result_outputs", "summary.csv")
    assert ckpt.select_epoch(save_dir, "best", summary) == \
        jckpt.select_epoch(save_dir, "best", summary)
    # a summary with a rerun epoch and the best value on an earlier row
    edited = tmp_path / "summary.csv"
    edited.write_text("epoch,train-loss,val-PSNR,val-SSIM\n0,0.5,20.0,0.5\n"
                      "1,0.4,22.5,0.6\n1,0.3,21.0,0.7\n")
    for metric in ("val-PSNR", "val-SSIM", "train-loss"):
        assert ckpt.select_epoch(save_dir, "best", str(edited), metric=metric) == \
            jckpt.select_epoch(save_dir, "best", str(edited), metric=metric)
    iface = SISRInterface(model_loc=model_loc, experiment=EXP, mode="eval",
                          load_epoch="best", device="cpu")
    assert iface.model_epoch - 1 == jckpt.select_epoch(save_dir, "best", summary)


def test_jax_experiment_serves_in_the_port(data, experiment):
    """The JAX experiment's config.toml and flax checkpoint through the
    port's SISRInterface: the same step, and the same SR image."""
    model_loc, _ = experiment
    lr = np.asarray(Image.open(os.path.join(data[0], "im3.png")), np.float32) / 255.0
    jax_iface = JaxSISRInterface(model_loc=model_loc, experiment=EXP, mode="eval",
                                 load_epoch="last", no_directories=True)
    port = SISRInterface(model_loc=model_loc, experiment=EXP, mode="eval",
                         load_epoch="last", no_directories=True, device="cpu")
    assert port.state.step == int(np.asarray(jax_iface.state.step)) > 0
    want = jax_iface.net_run_and_process(lr)[0]
    got = port.net_run_and_process(lr)[0]
    assert got.shape == want.shape == (1, 13 * SCALE, 17 * SCALE, 3)
    assert np.abs(got - want).max() <= 1e-4


def test_port_training_writes_validation(tmp_path, data):
    """cli.train_sisr with eval sets: val-PSNR and val-SSIM in summary.csv
    every eval_frequency epochs, a sample image, and 'best' selected by
    them, as the JAX package selects."""
    cfg = _config(data, tmp_path / "Results", experiment="port_exp", epochs=3)
    cfg["training"]["eval_frequency"] = 2
    dump_toml(cfg, str(tmp_path / "train.toml"))
    stats = train_sisr.main(["-p", str(tmp_path / "train.toml"), "--device", "cpu"])
    assert [("val-PSNR" in stats[e], "val-SSIM" in stats[e]) for e in sorted(stats)] == \
        [(True, True), (False, False), (True, True)]
    logs = tmp_path / "Results" / "port_exp" / "result_outputs"
    with open(logs / "summary.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert all(math.isfinite(float(r["val-PSNR"])) for r in rows)
    assert float(rows[1]["val-PSNR"]) == 0.0  # zero-filled where not evaluated
    assert (logs / "samples" / "epoch_0_sample.png").is_file()
    save_dir = str(tmp_path / "Results" / "port_exp" / "saved_models")
    best = ckpt.select_epoch(save_dir, "best", str(logs / "summary.csv"))
    assert best == jckpt.select_epoch(save_dir, "best", str(logs / "summary.csv"))
    assert best == max((0, 2), key=lambda e: stats[e]["val-PSNR"])


@pytest.mark.parametrize("option", [
    "gallery", "fr_gallery", "FR_rank", "LPIPS", "metadata_file",
    "cli_metadata_file", "cli_lpips_weights", "cli_gallery", "cli_fr_gallery",
    "cli_fr_extractor_weights", "resume_jax_optimizer"])
def test_options_of_later_slices_raise(tmp_path, data, experiment, option):
    """Each option of a later slice raises. The metadata options, ported
    since, score as the JAX package does instead: ``metadata_file`` =
    "on_site" (the LR folder has no CSV) through EvalHub, and a CSV given
    by ``--metadata_file`` through eval_sisr (RCAN takes none of its
    columns, so it is read and not used)."""
    model_loc, _ = experiment
    lr_dir, hr_dir = data
    if option == "metadata_file":
        kwargs = dict(models=[{"experiment": EXP, "epoch": "last"}], model_loc=model_loc,
                      data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir, "metadata_file": "on_site"},
                      scale=SCALE, metrics=["PSNR", "SSIM"])
        JaxEvalHub(out_loc=str(tmp_path / "jax"), **kwargs).full_image_protocol()
        EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kwargs).full_image_protocol()
        assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), EXP, runtime=False)
        return
    if option == "cli_metadata_file":
        csv_path = tmp_path / "m.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image", "0-realesrganblur-sigma_x", "0-realesrganblur-kernel_type"])
            for k in range(len(LR_SHAPES)):
                w.writerow([f"im{k}.png", 0.5 + k, k % 2])
        flags = ["--model_loc", model_loc, "--scale", str(SCALE), "--lr_dir", lr_dir,
                 "--hr_dir", hr_dir, "-me", EXP, "last", "--metadata_file", str(csv_path)]
        r = CliRunner().invoke(jax_eval_main, flags + ["--out_loc", str(tmp_path / "jax")])
        assert r.exit_code == 0, r.output + repr(r.exception)
        eval_sisr.main(flags + ["--out_loc", str(tmp_path / "port"), "--device", "cpu"])
        assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), EXP, runtime=False)
        return
    base = dict(models=[{"experiment": EXP, "epoch": "last"}], model_loc=model_loc,
                data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir}, out_loc=str(tmp_path),
                scale=SCALE, device="cpu")
    flags = ["--model_loc", model_loc, "--out_loc", str(tmp_path), "--lr_dir", lr_dir,
             "--hr_dir", hr_dir, "-me", EXP, "last", "--device", "cpu"]
    cases = {
        "gallery": lambda: EvalHub(gallery=True, **base),
        "fr_gallery": lambda: EvalHub(fr_gallery=str(tmp_path), **base),
        "FR_rank": lambda: EvalHub(metrics=["PSNR", "FR_rank"], **base),
        "LPIPS": lambda: EvalHub(metrics=["PSNR", "LPIPS"], **base),
        "cli_lpips_weights": lambda: eval_sisr.main(flags + ["--lpips_weights", "w.npz"]),
        "cli_gallery": lambda: eval_sisr.main(flags + ["--gallery"]),
        "cli_fr_gallery": lambda: eval_sisr.main(flags + ["--fr_gallery", "g"]),
        "cli_fr_extractor_weights": lambda: eval_sisr.main(
            flags + ["--fr_extractor_weights", "w"]),
        "resume_jax_optimizer": lambda: SISRInterface(
            model_loc=model_loc, experiment=EXP, mode="train", load_epoch="last",
            no_directories=True, device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="item|later slice|not ported yet"):
        cases[option]()


def test_eval_entry_points_raise_without_cuda(monkeypatch, tmp_path, data, experiment):
    model_loc, _ = experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EvalHub(models=[{"experiment": EXP, "epoch": "last"}], model_loc=model_loc,
                data_cfg={"lr_dir": data[0], "hr_dir": data[1]}, out_loc=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_sisr.main(["--model_loc", model_loc, "--out_loc", str(tmp_path),
                        "--lr_dir", data[0], "--hr_dir", data[1], "-me", EXP, "last"])
