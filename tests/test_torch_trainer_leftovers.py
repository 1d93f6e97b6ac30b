"""The trainer's leftovers in the port, on the CPU, against the JAX package:
a JAX-written experiment continued by the port's ``cli/train_sisr`` (its
optax state carried over), ``profile_steps`` on ``torch.profiler``, the Aim
gate (with a stand-in ``aim`` module: the package is not installed) and
``plot_stats``.

Tolerances: an epoch's mean train loss within 1e-4 of JAX's, as the
two-epoch run of ``test_torch_trainer.py``; the resumed epoch's parameters
within 2e-6 + 1e-3 of the lr of JAX's (float32 gradients of two frameworks
differ in their last bits, and Adam scales a move to about the lr).
"""

import csv
import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.ops import entropy as jentropy
from rumpy_tpu.ops.pallas.entropy_kernel import local_entropy_pallas
from rumpy_tpu.training.trainer import TrainingHandler as JaxTrainingHandler
from rumpy_tpu.utils import stats as jstats
from rumpy_tpu_torch.cli import train_sisr
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.training.trainer import STEP_SPAN, TrainingHandler
from rumpy_tpu_torch.utils import flax_msgpack
from rumpy_tpu_torch.utils import stats as tstats
from rumpy_tpu_torch.utils.checkpoint import load_checkpoint
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

LR = 1e-3
EXP = "rcan_resume"


def _pallas_best(gray, region=10, levels=64):
    return local_entropy_pallas(jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8),
                                region=region, levels=levels, interpret=True)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    lr_dir, hr_dir = root / "lr", root / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k in range(4):
        yy, xx = np.mgrid[:48, :64]
        amp = 70.0 * (0.5 + 0.5 * np.sin(xx / 9.0 + k)) * (0.5 + 0.5 * np.cos(yy / 7.0))
        hr = np.clip(128 + amp[..., None] * rng.standard_normal((48, 64, 3)),
                     0, 255).astype(np.uint8)
        Image.fromarray(hr[::2, ::2].copy()).save(lr_dir / f"im{k}.png")
        Image.fromarray(hr).save(hr_dir / f"im{k}.png")
    return str(lr_dir), str(hr_dir)


def _config(path, dataset, save_loc, batch_size=2, **training):
    """A tiny RCAN x2 on entropy-selected patches, Adam with the lr halved
    from the third step: the resumed epoch's first update needs the
    schedule's position as well as the moments."""
    lr_dir, hr_dir = dataset
    dump_toml({
        "experiment": EXP, "experiment_save_loc": str(save_loc),
        "data": {"scale": 2, "crop": 8, "augmentations": True, "dataloader_threads": 1,
                 "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir,
                                              "patch_selection_type": "entropy"}}},
        "model": {"name": "rcan", "internal_params": {
            "scale": 2, "n_feats": 16, "n_resgroups": 1, "n_resblocks": 2, "reduction": 4,
            "lr": LR, "scheduler": "multi_step_lr",
            "scheduler_params": {"milestones": [2], "gamma": 0.5}}},
        "training": {"num_epochs": 1, "batch_size": batch_size, "seed": 1, **training},
    }, str(path))
    return str(path)


def _summary(logs_dir):
    with open(os.path.join(logs_dir, "summary.csv"), newline="") as f:
        return list(csv.DictReader(f))


class _AimRun:
    """A stand-in for ``aim.Run`` that records what a trainer does with it."""

    calls = []

    def __init__(self, **kwargs):
        self.calls.append(("Run", kwargs))

    def __setitem__(self, key, value):
        self.calls.append(("set", key, sorted(value)))

    def track(self, value, name, epoch):
        self.calls.append(("track", name, int(epoch), float(value)))


def _aim_calls(run):
    """The calls ``run()`` makes of the stand-in."""
    _AimRun.calls = []
    run()
    return _AimRun.calls


def _close_tracks(got, want):
    assert [c[:3] for c in got] == [c[:3] for c in want]
    for g, w in zip(got, want):
        if g[0] == "track" and g[1] != "compute_efficiency":
            assert abs(g[3] - w[3]) < 1e-4, (g, w)


def test_the_port_continues_a_jax_written_run(monkeypatch, tmp_path, dataset):
    """The JAX trainer runs epoch 0 and saves (a flax-msgpack checkpoint with
    its optax state); the port's ``cli/train_sisr`` continues that
    experiment for epoch 1, and so does the JAX trainer on its own copy.
    The epoch-1 losses of summary.csv agree, and so do the parameters of
    both epoch-1 checkpoints. Both runs track to Aim (a stand-in module)
    the same way: the Run, the config's keys, epoch 0 replayed from
    summary.csv on the resume, then epoch 1's columns."""
    monkeypatch.setattr(jentropy, "local_entropy_best", _pallas_best)
    monkeypatch.setitem(sys.modules, "aim", types.SimpleNamespace(Run=_AimRun))
    cfg = _config(tmp_path / "c.toml", dataset, tmp_path / "jax", logging="aim")
    first = _aim_calls(lambda: JaxTrainingHandler(jax_load_config(cfg), use_mesh=False,
                                                  verbose=False).run_experiment())
    shutil.copytree(tmp_path / "jax", tmp_path / "port")

    def resumed(package):
        if package == "jax":
            c = jax_load_config(cfg)
            c["training"]["continue_from_epoch"] = "last"
            JaxTrainingHandler(c, use_mesh=False, verbose=False).run_experiment()
        else:
            train_sisr.main(["-p", cfg, "--device", "cpu", "--continue_from_epoch", "last",
                             "--experiment_save_loc", str(tmp_path / "port")])

    jax_calls, port_calls = (_aim_calls(lambda p=p: resumed(p)) for p in ("jax", "port"))
    want = _summary(tmp_path / "jax" / EXP / "result_outputs")
    got = _summary(tmp_path / "port" / EXP / "result_outputs")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == ["0", "1"]
    # the JAX run's row, kept (pandas' CSV parser rounds the last digit of some
    # values when the JAX trainer rewrites its copy on the resume)
    assert got[0].keys() == want[0].keys()
    np.testing.assert_allclose([float(got[0][k]) for k in got[0]],
                               [float(want[0][k]) for k in got[0]], rtol=1e-12, atol=0)
    assert abs(float(got[1]["train-loss"]) - float(want[1]["train-loss"])) < 1e-4

    jax_ckpt = tmp_path / "jax" / EXP / "saved_models" / "train_model_1"
    with open(jax_ckpt, "rb") as f:
        jax_params = flax_msgpack.msgpack_restore(f.read())["arrays"]["network"]
    from rumpy_tpu_torch.registry import get_model
    module = get_model("rcan")(device="cpu", scale=2, n_feats=16, n_resgroups=1,
                               n_resblocks=2, reduction=4).module
    port = load_checkpoint(str(tmp_path / "port" / EXP / "saved_models" / "train_model_1"))
    assert int(port["step"]) == int(np.asarray(jax.tree_util.tree_leaves(
        flax_msgpack.msgpack_restore(jax_ckpt.read_bytes())["arrays"]["step"])[0])) == 4
    got_params = jax_tree_from_state_dict(port["network"], module)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, atol=2e-6 + 1e-3 * LR, rtol=0),
        got_params, jax.tree_util.tree_map(np.asarray, jax_params))

    # Aim: the same calls in both packages
    assert first[0] == ("Run", {"experiment": EXP, "system_tracking_interval": 60})
    assert first[1] == ("set", "hparams", ["data", "experiment", "experiment_save_loc",
                                          "model", "training"])
    assert [c[1:3] for c in first[2:]] == [("train-loss", 0), ("compute_efficiency", 0)]
    assert port_calls[:2] == jax_calls[:2] == [first[0], ("set", "hparams", first[1][2])]
    assert [c[1:3] for c in jax_calls[2:]] == [
        ("epoch", 0), ("train-loss", 0), ("compute_efficiency", 0),
        ("train-loss", 1), ("compute_efficiency", 1)]
    _close_tracks(port_calls, jax_calls)
    assert os.path.isfile(tmp_path / "port" / EXP / "result_outputs" / "loss_plots.pdf")


def test_without_aim_both_trainers_say_so_and_train_on(monkeypatch, tmp_path, dataset, capsys):
    monkeypatch.setitem(sys.modules, "aim", None)  # import aim raises ImportError
    cfg = _config(tmp_path / "c.toml", dataset, tmp_path / "out", logging="aim")
    JaxTrainingHandler(jax_load_config(cfg), use_mesh=False, verbose=False)
    jax_out = capsys.readouterr().out
    h = TrainingHandler(load_config(cfg), verbose=False, device="cpu")
    port_out = capsys.readouterr().out
    message = "aim not installed; experiment tracking disabled\n"
    assert message in jax_out and message in port_out and h.tracker is None
    assert list(h.run_experiment()) == [0]


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == STEP_SPAN and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


# profile_steps, epochs, no_directories -> step spans in the trace (None: no trace)
PROFILE_CASES = {"two steps, later epochs add none": (2, 2, False, 2),
                 "the epoch ends first": (9, 1, False, 4),
                 "no directories": (2, 1, True, None)}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_profile_steps_traces_the_first_steps(case, tmp_path, dataset):
    """The first N steps of the first epoch (4 steps of batch 1 an epoch)
    go into one Chrome trace under result_outputs/profile, one span a step;
    a later epoch adds none, and without directories nothing is written."""
    steps, epochs, no_dirs, spans = PROFILE_CASES[case]
    cfg = load_config(_config(tmp_path / "c.toml", dataset, tmp_path / "out", batch_size=1,
                              profile_steps=steps, num_epochs=epochs))
    cfg["no_directories"] = no_dirs
    h = TrainingHandler(cfg, verbose=False, device="cpu")
    assert list(h.run_experiment()) == list(range(epochs))
    profile = os.path.join(str(tmp_path / "out" / EXP / "result_outputs"), "profile")
    if spans is None:
        assert not os.path.exists(profile)
        return
    assert os.listdir(profile) == ["train_steps.json"]
    assert len(_spans(os.path.join(profile, "train_steps.json"))) == spans


def test_plot_stats_draws_what_jax_draws(monkeypatch, tmp_path):
    """One summary.csv through both packages' plot_stats: the same subplot
    titles and the same series (within 1e-12: pandas' CSV parser rounds the
    last digit of some values), and a PDF each."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    rows = [{"epoch": e, "train-loss": 0.5 / (e + 1), "compute_efficiency": 90.0 + e,
             "val-PSNR": 20.0 + e} for e in range(3)]
    for row in rows:
        tstats.save_statistics(str(tmp_path), row)
    drawn = []
    close = plt.close

    def record(fig):
        drawn.append([(ax.get_title(), ax.lines[0].get_xydata().tolist())
                      for ax in fig.axes if ax.lines])
        close(fig)

    monkeypatch.setattr(plt, "close", record)
    want = jstats.plot_stats(str(tmp_path), filename="jax.pdf")
    got = tstats.plot_stats(str(tmp_path), filename="port.pdf")
    assert os.path.isfile(want) and os.path.isfile(got)
    assert [t for t, _ in drawn[1]] == [t for t, _ in drawn[0]] == [
        "train-loss", "compute_efficiency", "val-PSNR"]
    for (_, got_xy), (_, want_xy) in zip(drawn[1], drawn[0]):
        np.testing.assert_allclose(got_xy, want_xy, rtol=1e-12, atol=0)
