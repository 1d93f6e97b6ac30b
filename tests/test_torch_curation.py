"""The port's curation CLIs (``rumpy_tpu_torch/cli/curation.py``) on the CPU
against the JAX package's click commands (``rumpy_tpu/cli/curation.py``).

Each side gets its own copy of one results folder in the layout
``tests/test_cli_e2e.py::test_curation_clis`` trains: an experiment of six
checkpoints with a summary.csv, one whose summary lacks the metric (its
best is by the loss), one without a summary (its best epoch cannot be
read), one with no checkpoint, and one with a missing value whose best row
has no checkpoint (the nearest one is taken). ``model_report.csv`` is the same
text; ``extract_best_model`` writes the same files and bytes;
``clean_models`` lists (``--dry_run``) and removes the same checkpoints and
skips the same experiment; ``images_to_video`` without ffmpeg fails with
the same message.
"""

import filecmp
import os
import shutil

import pytest
from click.testing import CliRunner

from rumpy_tpu.cli import curation as jcur
from rumpy_tpu_torch.cli import curation as tcur
from rumpy_tpu_torch.utils.checkpoint import available_epochs, checkpoint_path
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

EXPERIMENTS = {
    # name: (checkpoint epochs, summary.csv text or None)
    "cur_exp": (range(6), "epoch,train-loss,val-PSNR\n" + "".join(
        f"{e},{0.5 - e * 0.01},{v}\n" for e, v in enumerate([20.1, 21.5, 23.25, 22.0, 23.25,
                                                              21.0]))),
    "loss_only": (range(3), "epoch,train-loss\n0,0.5\n1,0.4\n2,0.45\n"),
    "no_summary": (range(2), None),
    "empty": ((), None),
    "late_best": (range(1, 4), "epoch,val-PSNR\n1,18.0\n2,19.0\n3,\n4,19.5\n"),
}


def _results(root):
    """The results folder: checkpoints (their epoch as bytes), config.toml
    and summary.csv."""
    for name, (epochs, summary) in EXPERIMENTS.items():
        exp = os.path.join(root, name)
        os.makedirs(os.path.join(exp, "saved_models"))
        os.makedirs(os.path.join(exp, "result_outputs"))
        for e in epochs:
            with open(checkpoint_path(os.path.join(exp, "saved_models"), e), "wb") as f:
                f.write(f"weights of epoch {e}".encode())
        with open(os.path.join(exp, "config.toml"), "w") as f:
            f.write(f'[model]\nname = "{name}"\n')
        if summary is not None:
            with open(os.path.join(exp, "result_outputs", "summary.csv"), "w") as f:
                f.write(summary)
    return str(root)


@pytest.fixture
def folders(tmp_path):
    return {k: _results(tmp_path / k) for k in ("jax", "port")}


def _jax(command, args):
    r = CliRunner().invoke(command, args)
    return r.exit_code, r.output


@pytest.mark.parametrize("metric", ["val-PSNR", "train-loss"])
def test_model_report_matches_jax(folders, capsys, metric):
    """The report's CSV text, its best epochs and values (a max, or a min
    for the loss; the first of equal values; a missing value skipped)."""
    code, out = _jax(jcur.model_report, ["-r", folders["jax"], "--metric", metric])
    assert code == 0, out
    assert tcur.main(["model_report", "-r", folders["port"], "--metric", metric]) == 0
    printed = capsys.readouterr().out
    with open(os.path.join(folders["jax"], "model_report.csv")) as f:
        want = f.read()
    with open(os.path.join(folders["port"], "model_report.csv")) as f:
        got = f.read()
    assert got == want
    assert all(name in printed and name in out for name in EXPERIMENTS)
    if metric == "val-PSNR":
        # a column with an empty cell is a float column, as pandas writes it
        assert "cur_exp,6,5.0,2.0,23.25\n" in got and "late_best,3,3.0,4.0,19.5\n" in got


def test_extract_best_model_matches_jax(folders, tmp_path, capsys):
    """The deployable folder: config.toml, the best checkpoint alone and
    summary.csv, byte for byte as the JAX command writes them."""
    out = {k: str(tmp_path / f"deploy_{k}") for k in folders}
    code, text = _jax(jcur.extract_best_model, ["-b", os.path.join(folders["jax"], "cur_exp"),
                                                "-o", out["jax"]])
    assert code == 0, text
    assert tcur.main(["extract_best_model", "-b", os.path.join(folders["port"], "cur_exp"),
                      "-o", out["port"]]) == 0
    assert capsys.readouterr().out.strip() == text.strip().replace(out["jax"], out["port"])
    cmp = filecmp.dircmp(out["jax"], out["port"])
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files)
    assert available_epochs(os.path.join(out["port"], "saved_models")) == [2]
    for sub in ("saved_models", "result_outputs"):
        sub_cmp = filecmp.dircmp(os.path.join(out["jax"], sub), os.path.join(out["port"], sub))
        assert not (sub_cmp.left_only or sub_cmp.right_only or sub_cmp.diff_files)
        assert not filecmp.cmpfiles(os.path.join(out["jax"], sub), os.path.join(
            out["port"], sub), os.listdir(os.path.join(out["jax"], sub)), shallow=False)[1]


@pytest.mark.parametrize("dry_run", [True, False])
def test_clean_models_matches_jax(folders, capsys, dry_run):
    """Kept: best-1, best, best+1 and the last of each experiment (the best
    by another known metric where the summary lacks val-PSNR, a missing
    value skipped, snapped to a checkpoint); the experiment without a
    summary skipped, with the JAX message; ``--dry_run`` lists and removes
    nothing."""
    flag = ["--dry_run"] if dry_run else []
    code, text = _jax(jcur.clean_models, ["-r", folders["jax"]] + flag)
    assert code == 0, text
    assert tcur.main(["clean_models", "-r", folders["port"]] + flag) == 0
    got = capsys.readouterr().out
    assert got == text.replace(folders["jax"], folders["port"])
    assert "skipping no_summary" in got and "skipping" not in got.replace(
        "skipping no_summary", "")
    for name, (epochs, _) in EXPERIMENTS.items():
        kept = available_epochs(os.path.join(folders["port"], name, "saved_models"))
        assert kept == available_epochs(os.path.join(folders["jax"], name, "saved_models"))
        if dry_run:
            assert kept == list(epochs)
    if not dry_run:
        assert available_epochs(os.path.join(folders["port"], "cur_exp", "saved_models")) == [
            1, 2, 3, 5]


def test_images_to_video_without_ffmpeg_fails_as_jax(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    code, text = _jax(jcur.images_to_video, ["-i", str(tmp_path), "-o", str(tmp_path / "v.mp4")])
    assert code == 1 and "ffmpeg not found on PATH" in text
    assert tcur.main(["images_to_video", "-i", str(tmp_path), "-o",
                      str(tmp_path / "v.mp4")]) == 1
    assert capsys.readouterr().err.strip() == "Error: ffmpeg not found on PATH"
    with pytest.raises(SystemExit):
        tcur.main(["model_report", "-r", str(tmp_path / "absent")])
