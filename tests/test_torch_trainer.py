"""The training slice as a whole: a TOML config with entropy-selected
patches, trained for two epochs on the CPU through TrainingHandler in both
packages from the same initial weights; then resume, branching and the CLI
of the port."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.ops import entropy as jentropy
from rumpy_tpu.ops.pallas.entropy_kernel import local_entropy_pallas
from rumpy_tpu.training.trainer import TrainingHandler as JaxTrainingHandler
from rumpy_tpu_torch.cli import train_sisr
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.ops.cuda import local_entropy as entropy_ops
from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab_ops
from rumpy_tpu_torch.training.trainer import TrainingHandler
from rumpy_tpu_torch.utils import stats as tstats
from rumpy_tpu_torch.utils.weights import state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)


def _pallas_best(gray, region=10, levels=64):
    return local_entropy_pallas(
        jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8),
        region=region, levels=levels, interpret=True)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_pairs")
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


def _write_config(path, dataset, save_loc, **training):
    lr_dir, hr_dir = dataset
    dump_toml({
        "experiment": "rcan_entropy",
        "experiment_save_loc": str(save_loc),
        "data": {"scale": 2, "crop": 8, "augmentations": True,
                 "dataloader_threads": 1,
                 "training_sets": {"data_1": {
                     "lr_dir": lr_dir, "hr_dir": hr_dir,
                     "patch_selection_type": "entropy"}}},
        "model": {"name": "rcan", "internal_params": {
            "scale": 2, "n_feats": 16, "n_resgroups": 2, "n_resblocks": 2,
            "reduction": 4, "lr": 1e-3, "scheduler": "multi_step_lr",
            "scheduler_params": {"milestones": [2], "gamma": 0.5}}},
        "training": {"num_epochs": 2, "batch_size": 2, "seed": 1, **training},
    }, str(path))
    return str(path)


def _summary(handler):
    with open(os.path.join(handler.model.logs_dir, "summary.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    return list(rows[0]), rows


def test_two_epochs_match_jax(monkeypatch, tmp_path, dataset):
    monkeypatch.setattr(jentropy, "local_entropy_best", _pallas_best)
    jh = JaxTrainingHandler(
        jax_load_config(_write_config(tmp_path / "j.toml", dataset, tmp_path / "jax")),
        use_mesh=False, verbose=False)
    th = TrainingHandler(
        load_config(_write_config(tmp_path / "t.toml", dataset, tmp_path / "torch")),
        verbose=False, device="cpu")
    handler = th.model.model
    handler.module.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jh.model.state.params), handler.module))
    th.model.state = handler._own_state()

    before = (rcab_ops.launches, rcab_ops.backward_launches, entropy_ops.launches)
    jstats, tstats_ = jh.run_experiment(), th.run_experiment()
    # on CPU tensors the wrappers run their plain versions: no launch counted
    assert (rcab_ops.launches, rcab_ops.backward_launches,
            entropy_ops.launches) == before

    jcols, jrows = _summary(jh)
    tcols, trows = _summary(th)
    assert tcols == jcols == ["epoch", "train-loss", "compute_efficiency"]
    assert [int(float(r["epoch"])) for r in trows] == [0, 1]
    for jr, tr in zip(jrows, trows):
        assert abs(float(jr["train-loss"]) - float(tr["train-loss"])) < 1e-4
        assert 0.0 < float(tr["compute_efficiency"]) <= 100.0
    assert abs(tstats_[1]["train-loss"] - jstats[1]["train-loss"]) < 1e-4
    assert th.model.state.step == 4  # 4 items, batch 2, 2 epochs

    base = th.model.base_folder
    for name in ("config.toml", "saved_models/train_model_0",
                 "saved_models/train_model_1", "result_outputs/model_structure.txt"):
        assert os.path.isfile(os.path.join(base, name)), name
    # the trained checkpoint serves
    iface = SISRInterface(model_loc=str(tmp_path / "torch"), experiment="rcan_entropy",
                          mode="eval", load_epoch="last", device="cpu")
    assert iface.model_epoch == 2 and iface.state.step == 4
    rgb, _, _, _ = iface.net_run_and_process(np.random.default_rng(0).random(
        (9, 7, 3), dtype=np.float32))
    assert rgb.shape == (1, 18, 14, 3) and np.isfinite(rgb).all()


def test_resume_branches_and_truncates_the_orphan_row(tmp_path, dataset):
    cfg_path = _write_config(tmp_path / "c.toml", dataset, tmp_path / "out")
    first = TrainingHandler(load_config(cfg_path), verbose=False, device="cpu")
    first.run_experiment()
    logs = first.model.logs_dir
    assert tstats.load_statistics(logs)["epoch"] == [0.0, 1.0]

    cfg = load_config(cfg_path)
    cfg["training"]["continue_from_epoch"] = 0
    cfg["training"]["num_epochs"] = 1
    second = TrainingHandler(cfg, verbose=False, device="cpu")
    # resuming from a non-final epoch forks a branch and drops the rows
    # past the resume point from its copy of the summary
    assert second.model.base_folder.endswith("branch_epoch_0")
    assert second.model.model_epoch == 1 and second.model.state.step == 2
    assert tstats.load_statistics(second.model.logs_dir)["epoch"] == [0.0]
    second.run_experiment()
    assert tstats.load_statistics(second.model.logs_dir)["epoch"] == [0.0, 1.0]
    assert os.path.isfile(os.path.join(second.model.model_save_dir, "train_model_1"))
    assert tstats.load_statistics(logs)["epoch"] == [0.0, 1.0]  # untouched

    # resuming from the last epoch does not branch, but still drops an
    # orphan row (a crash between the row's write and the checkpoint's)
    tstats.save_statistics(logs, {"epoch": 2, "train-loss": 9.0,
                                  "compute_efficiency": 1.0})
    cfg["training"]["continue_from_epoch"] = "last"
    third = TrainingHandler(cfg, verbose=False, device="cpu")
    assert third.model.base_folder == first.model.base_folder
    assert tstats.load_statistics(logs)["epoch"] == [0.0, 1.0]
    third.run_experiment()
    assert tstats.load_statistics(logs)["epoch"] == [0.0, 1.0, 2.0]


def test_cli_main_trains_and_resumes(tmp_path, dataset):
    cfg_path = _write_config(tmp_path / "c.toml", dataset, tmp_path / "out")
    stats = train_sisr.main(["-p", cfg_path, "--device", "cpu", "--num_epochs", "1",
                             "--experiment", "from_cli", "--batch_size", "4"])
    assert list(stats) == [0] and np.isfinite(stats[0]["train-loss"])
    base = tmp_path / "out" / "from_cli"
    saved = load_config(str(base / "config.toml"))
    assert saved["model"]["name"] == "rcan"
    assert (base / "saved_models" / "train_model_0").is_file()
    stats = train_sisr.main(["-p", cfg_path, "--device", "cpu", "--num_epochs", "1",
                             "--experiment", "from_cli", "--batch_size", "4",
                             "--continue_from_epoch", "last"])
    assert list(stats) == [1]
    assert (base / "config_from_epoch_0.toml").is_file()
    with pytest.raises(FileNotFoundError):
        train_sisr.main(["-p", str(tmp_path / "missing.toml")])


def test_early_stopping_cleanup_and_epoch_cutoff(tmp_path, dataset):
    cfg = load_config(_write_config(
        tmp_path / "c.toml", dataset, tmp_path / "out", early_stopping_patience=1,
        early_stopping_metric="train-loss", cleanup_metric="train-loss",
        aggressive_cleanup=True, epoch_cutoff=6))
    cfg["model"]["internal_params"]["lr"] = 0.0  # no learning: a plateau
    cfg["data"]["training_sets"]["data_1"]["patch_selection_type"] = "predefined"
    cfg["data"]["training_sets"]["data_1"]["predefined_patch_locations"] = [[0, 0]]
    cfg["data"]["training_sets"]["data_1"]["cutoff"] = 1  # one image, one step
    cfg["data"]["augmentations"] = False
    cfg["training"]["batch_size"] = 1
    h = TrainingHandler(cfg, verbose=False, device="cpu")
    stats = h.run_experiment()
    assert list(stats) == [0, 1]  # stopped at the first epoch without a gain
    assert stats[0]["train-loss"] == stats[1]["train-loss"]
    assert len(os.listdir(h.model.model_save_dir)) == 2

    # without early stopping the run ends at the absolute epoch_cutoff and
    # the cleanup keeps best-1, best, best+1 and the last checkpoint
    cfg["training"]["early_stopping_patience"] = None
    cfg["experiment"] = "to_cutoff"
    h = TrainingHandler(cfg, verbose=False, device="cpu")
    assert list(h.run_experiment()) == [0, 1, 2, 3, 4, 5]
    assert sorted(os.listdir(h.model.model_save_dir)) == [
        "train_model_0", "train_model_1", "train_model_5"]


def test_options_of_later_slices_raise(tmp_path, dataset, monkeypatch):
    base = load_config(_write_config(tmp_path / "c.toml", dataset, tmp_path / "out"))
    # LPIPS, ported since, raises without lpips_weights as the JAX trainer does
    for table, key, value, message in (
            ("training", "metrics", ["PSNR", "LPIPS"], "weights"),):
        cfg = load_config(str(tmp_path / "c.toml"))
        cfg[table][key] = value
        with pytest.raises(NotImplementedError, match=message):
            TrainingHandler(cfg, verbose=False, device="cpu")
    # profile_steps and Aim, which raised until their slice, build the
    # trainer (test_torch_trainer_leftovers.py holds them against JAX)
    for key, value in (("profile_steps", 2), ("logging", "aim")):
        cfg = load_config(str(tmp_path / "c.toml"))
        cfg["training"][key] = value
        TrainingHandler(cfg, verbose=False, device="cpu")
    # srmdgaussianblur, which raised until its slice, builds the trainer's
    # online chain and degrades as the JAX package's does (its default
    # kernel is fixed: isotropic, sigma 2.6)
    from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
    chain = {"pipeline": [["srmdgaussianblur", "b"]], "deg_configs": {"b": {}}}
    cfg = load_config(str(tmp_path / "c.toml"))
    cfg["data"]["online_degradations"] = chain
    h = TrainingHandler(cfg, verbose=False, device="cpu")
    hr = np.random.default_rng(5).random((2, 30, 26, 3)).astype(np.float32)
    got = h.model.model.input_fn(torch.Generator(), {"hr": torch.from_numpy(hr)})["lr"]
    want, _ = JaxPipeline(chain["pipeline"], deg_configs=chain["deg_configs"]).degrade_batch(
        jax.random.PRNGKey(0), jnp.asarray(hr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # task_type = "regression" goes to the regression trainer, as in the JAX
    # package's CLI
    base["data"]["task_type"] = "regression"
    dump_toml(base, str(tmp_path / "r.toml"))
    from rumpy_tpu_torch.training import regression_trainer
    routed = []

    class Routed(Exception):
        pass

    def handler(cfg, **kw):
        routed.append((cfg["data"]["task_type"], kw))
        raise Routed

    monkeypatch.setattr(regression_trainer, "RegressionTrainingHandler", handler)
    with pytest.raises(Routed):
        train_sisr.main(["-p", str(tmp_path / "r.toml"), "--device", "cpu"])
    assert routed == [("regression", {"device": "cpu"})]
    # without eval sets, eval returns nothing, as in the JAX package
    h = TrainingHandler(load_config(str(tmp_path / "c.toml")), verbose=False,
                        device="cpu")
    assert h.eval(0) == {}


def test_trainer_defaults_to_the_card(monkeypatch, tmp_path, dataset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(_write_config(tmp_path / "c.toml", dataset, tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainingHandler(cfg, verbose=False)


def test_statistics_backfill_and_truncate(tmp_path):
    logs = str(tmp_path)
    tstats.save_statistics(logs, {"epoch": 0, "train-loss": 0.5})
    tstats.save_statistics(logs, {"epoch": 1, "train-loss": 0.25, "val-PSNR": 30.0})
    tstats.save_statistics(logs, {"epoch": 2, "val-PSNR": 31.0})
    got = tstats.load_statistics(logs)
    assert got == {"epoch": [0.0, 1.0, 2.0], "train-loss": [0.5, 0.25, 0.0],
                   "val-PSNR": [0.0, 30.0, 31.0]}
    tstats.truncate_statistics(logs, 1)
    assert tstats.load_statistics(logs)["epoch"] == [0.0, 1.0]
    assert tstats.load_statistics(str(tmp_path / "absent")) is None
