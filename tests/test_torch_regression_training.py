"""Degradation-predictor training in the port on the CPU: the metadata
CSV reader against the JAX package's (the CSV that its
``pipeline_prep_and_run`` writes, and one with QPI and list columns), the
cases of tests/test_regression_training.py run on the port, and
examples/train_supmoco_predictor.toml at a test size through the port's
``cli.train_sisr``: a checkpoint that resumes bit for bit, loads into
``contrastiveblindqrcan`` as its encoder, and loads into the JAX package's
state through the bridge, giving the same embeddings there (within 1e-4 of
the largest, the encoder tests' tolerance)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.data.metadata import read_augmentation_list as jax_read
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.data.metadata import read_augmentation_list, select_metadata
from rumpy_tpu_torch.training.regression_trainer import RegressionTrainingHandler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def degraded_dataset(tmp_path_factory):
    """Blur + noise + compression degraded images and their metadata CSV,
    written by the JAX package's offline pipeline."""
    tmp = tmp_path_factory.mktemp("regdata")
    hr_dir = tmp / "hr"
    os.makedirs(hr_dir)
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray((rng.random((48, 48, 3)) * 255).astype(np.uint8)
                        ).save(hr_dir / f"im{i}.png")
    from rumpy_tpu.degradations.pipeline import pipeline_prep_and_run
    out = str(tmp / "lr")
    pipeline_prep_and_run({
        "pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                     ["realesrgannoise", "n"], ["randomcompress", "c"]],
        "deg_configs": {
            "b": {"kernel_range": ["iso", "aniso"], "kernel_size": 9,
                  "request_kernel_metadata": True},
            "d": {"scale": 2},
            "n": {"gaussian_noise_sigma_range": (1, 30), "gray_noise_probability": 0.4},
            "c": {"jm_params": {"random_compression": True},
                  "jpeg_params": {"random_compression": True}}},
        "seed": 1, "source_dir": str(hr_dir), "output_dir": out})
    return out


def _crafted_csv(path):
    """QPI (pinned range), a list column, a boolean column and an empty cell."""
    rows = [("a.png", 24, json.dumps([0.1, 0.5]), "True", 3.0),
            ("b.png", 38, json.dumps([0.7, 0.2]), "False", ""),
            ("c.png", 30, json.dumps([0.3, 0.9]), "True", 5.0)]
    with open(path, "w") as fh:
        fh.write("image,QPI,1-blur-kernel,2-flag,3-noise-level\n")
        for r in rows:
            fh.write(",".join(f'"{v}"' if isinstance(v, str) and "," in v else str(v)
                              for v in r) + "\n")
    return [r[0] for r in rows]


OPTIONS = [dict(), dict(normalize=False), dict(normalize=["QPI"]),
           dict(ignore_degradation_location=True), dict(attribute_skip=["2-flag"]),
           dict(qpi_selection=[25, 35]), dict(force_qpi_range=False)]


@pytest.mark.parametrize("opts", OPTIONS, ids=[",".join(o) or "default" for o in OPTIONS])
def test_read_augmentation_list_matches_jax(degraded_dataset, tmp_path, opts):
    csv_path = os.path.join(degraded_dataset, "degradation_metadata.csv")
    names = sorted(f for f in os.listdir(degraded_dataset) if f.endswith(".png"))
    for path, files in ((csv_path, names),
                        (str(tmp_path / "c.csv"), _crafted_csv(tmp_path / "c.csv"))):
        if "attribute_skip" in opts and path == csv_path:
            opts = dict(attribute_skip=["1-downsample-scale"])
        got, keys = read_augmentation_list(path, files, **opts)
        want, want_keys = jax_read(path, files, **opts)
        assert keys == want_keys
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], want[name])
    sel = select_metadata(np.arange(5, dtype=np.float32), keys[:5] if len(keys) >= 5 else keys,
                          ["kernel"])
    assert sel.dtype == np.float32


def _config(tmp_path, lr_dir, model_name, internal):
    return {
        "experiment": f"{model_name}_exp",
        "experiment_save_loc": str(tmp_path / "Results"),
        "data": {"task_type": "regression", "scale": 2, "crop": 16,
                 "dataloader_threads": 1,
                 "training_sets": {"data_1": {
                     "lr_dir": lr_dir,
                     "metadata_file": os.path.join(lr_dir, "degradation_metadata.csv")}},
                 "eval_sets": {"data_1": {
                     "lr_dir": lr_dir, "crop": 16,
                     "metadata_file": os.path.join(lr_dir, "degradation_metadata.csv")}}},
        "model": {"name": model_name, "internal_params": internal},
        "training": {"num_epochs": 1, "batch_size": 2, "seed": 0},
    }


def _handler(cfg, tmp_path, name="c.toml"):
    dump_toml(cfg, str(tmp_path / name))
    return RegressionTrainingHandler(load_config(str(tmp_path / name)), verbose=False,
                                     device="cpu")


def test_supmoco_regression_training(tmp_path, degraded_dataset):
    h = _handler(_config(tmp_path, degraded_dataset, "supmoco",
                         {"K": 8, "positives_per_class": 2, "dim": 64}), tmp_path)
    assert h._num_classes > 0
    stats = h.run_experiment()
    assert np.isfinite(stats[0]["train-loss"])
    exp = tmp_path / "Results" / "supmoco_exp"
    assert (exp / "saved_models" / "train_model_0").is_file()
    data = np.load(exp / "result_outputs" / "encodings_epoch_0.npz")
    assert data["embeddings"].shape == (6, 256) and data["labels"].shape == (6,)
    with open(exp / "result_outputs" / "encodings_epoch_0.csv") as fh:
        header = fh.readline().strip().split(",")
    assert header[0] == "0" and header[-1] == "label" and len(header) == 257


def test_weakcon_regression_training(tmp_path, degraded_dataset):
    h = _handler(_config(tmp_path, degraded_dataset, "weakcon",
                         {"K": 8, "positives_per_class": 1, "dim": 64}), tmp_path)
    # the side-queue takes the width of the CSV's degradation vectors
    assert tuple(h.model.model.module.queue_vectors.shape) == (8, 6)
    stats = h.run_experiment()
    assert np.isfinite(stats[0]["train-loss"])


def test_supmoco_online_degradation_training(tmp_path):
    """HR-only training set: each batch's views are degraded on the device
    in one pass, an image's views with one set of draws; the labelling
    keys come from degrading a dummy batch."""
    hr_dir = tmp_path / "hr"
    os.makedirs(hr_dir)
    rng = np.random.default_rng(3)
    for i in range(4):
        np.save(hr_dir / f"im{i}.npy", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    cfg = {"experiment": "supmoco_online", "experiment_save_loc": str(tmp_path / "Results"),
           "data": {"task_type": "regression", "scale": 2, "crop": 16,
                    "dataloader_threads": 1,
                    "online_degradations": {
                        "pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                                     ["realesrgannoise", "n"]],
                        "deg_configs": {"b": {"kernel_range": ["iso", "aniso"],
                                              "kernel_size": 9},
                                        "d": {"scale": 2},
                                        "n": {"gaussian_noise_sigma_range": [1, 30]}}},
                    "training_sets": {"data_1": {"hr_dir": str(hr_dir)}}},
           "model": {"name": "supmoco", "internal_params":
                     {"K": 8, "positives_per_class": 2, "dim": 64}},
           "training": {"num_epochs": 1, "batch_size": 2, "seed": 0}}
    h = _handler(cfg, tmp_path)
    assert h._num_classes > 0
    stats = h.run_experiment()
    assert np.isfinite(stats[0]["train-loss"])
    assert int(h.model.state.params["queue_ptr"]) == 4  # two steps of two
    assert (h.model.state.params["queue_labels"][:4] >= 0).all()


def test_cli_routes_regression(tmp_path, degraded_dataset):
    from rumpy_tpu_torch.cli.train_sisr import main
    dump_toml(_config(tmp_path, degraded_dataset, "moco", {"K": 8, "dim": 32}),
              str(tmp_path / "cfg.toml"))
    stats = main(["--parameters", str(tmp_path / "cfg.toml"), "--device", "cpu"])
    assert np.isfinite(stats[0]["train-loss"])
    assert (tmp_path / "Results" / "moco_exp" / "config.toml").is_file()


def test_positives_default_derived_from_handler(tmp_path, degraded_dataset):
    """A config without positives_per_class takes crop_count from the
    handler's own default along its MRO (SupMoCo: 4; WeakCon inherits it)."""
    h = _handler(_config(tmp_path, degraded_dataset, "supmoco", {"K": 8, "dim": 32}),
                 tmp_path)
    assert h._positives == 4
    assert np.isfinite(h.run_experiment()[0]["train-loss"])
    cfg_w = _config(tmp_path, degraded_dataset, "weakcon", {"K": 8, "dim": 32})
    cfg_w["experiment"] = "weakcon_positives"
    h_w = _handler(cfg_w, tmp_path, "w.toml")
    assert h_w._positives == 4
    assert np.isfinite(h_w.run_experiment()[0]["train-loss"])
    cfg_x = _config(tmp_path, degraded_dataset, "supmoco", {"K": 8, "dim": 32})
    cfg_x["data"]["crop_count"] = 3
    cfg_x["model"]["internal_params"]["positives_per_class"] = 4
    with pytest.raises(ValueError, match="conflicts with"):
        _handler(cfg_x, tmp_path, "x.toml")


def test_warm_start_unknown_name_fails_loud(tmp_path, degraded_dataset):
    cfg = _config(tmp_path, degraded_dataset, "moco", {"K": 8, "dim": 32})
    cfg["training"]["warm_start"] = "no_such_packaged_net"
    with pytest.raises(RuntimeError, match="not available"):
        _handler(cfg, tmp_path)


def test_warm_start_from_packaged_keeps_this_runs_label_queue(tmp_path, degraded_dataset):
    """Warm start from supmoco_fullchain_d256 by name: the encoders and the
    queue come from it (same dim and K), the label queue stays this run's."""
    from rumpy_tpu_torch.utils import checkpoint as ckpt
    cfg = _config(tmp_path, degraded_dataset, "supmoco",
                  {"K": 8192, "dim": 256, "positives_per_class": 1})
    cfg["training"]["warm_start"] = "supmoco_fullchain_d256"
    h = _handler(cfg, tmp_path)
    raw = ckpt.load_checkpoint(ckpt.checkpoint_path(
        ckpt.resolve_packaged("supmoco_fullchain_d256"), 29))
    params = h.model.state.params
    np.testing.assert_array_equal(params["encoder.convs.0.weight"].numpy(),
                                  raw["network"]["TConv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(params["queue"].numpy(), raw["extra"]["queue"])
    assert int(params["queue_ptr"]) == int(raw["extra"]["queue_ptr"])
    assert (params["queue_labels"] == -1).all()


# -- the example config, end to end ------------------------------------------------

@pytest.fixture(scope="module")
def predictor_run(tmp_path_factory):
    """examples/train_supmoco_predictor.toml at a test size, through the
    port's CLI on the CPU: HR .npy files, its chain, 2 epochs."""
    from rumpy_tpu_torch.cli import train_sisr
    tmp = tmp_path_factory.mktemp("predictor")
    cfg = load_config(os.path.join(ROOT, "examples", "train_supmoco_predictor.toml")).as_plain()
    hr_dir = tmp / "hr"
    os.makedirs(hr_dir)
    rng = np.random.default_rng(11)
    for i in range(4):
        np.save(hr_dir / f"h{i}.npy", rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
    cfg["experiment_save_loc"] = str(tmp / "Results")
    cfg["data"].update(crop=8, dataloader_threads=1)
    # the example's crop_count = 2 gives one positive, where SupMoCo's
    # default takes 4 (both packages fail at the first step's reshape):
    # without it the trainer takes the handler's 4, 5 crops an image
    del cfg["data"]["crop_count"]
    cfg["data"]["online_degradations"]["deg_configs"]["b"]["kernel_size"] = 9
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["training"].update(num_epochs=2, batch_size=2)
    path = tmp / "predictor.toml"
    dump_toml(cfg, str(path))
    stats = train_sisr.main(["-p", str(path), "--device", "cpu"])
    return cfg, path, stats, tmp / "Results" / cfg["experiment"] / "saved_models"


def test_example_predictor_trains_and_resumes_bit_for_bit(predictor_run):
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.utils import checkpoint as ckpt
    cfg, _, stats, saved = predictor_run
    assert sorted(stats) == [0, 1] and all(np.isfinite(s["train-loss"]) for s in stats.values())
    raw = torch.load(ckpt.checkpoint_path(str(saved), 1), weights_only=True)
    assert raw["network"]["queue"].shape == (8192, 256)
    assert int(raw["network"]["queue_ptr"]) == 8  # 2 epochs x 2 steps x 2 images
    resumed = SISRInterface(model_loc=str(saved.parent.parent),
                            experiment=cfg["experiment"], mode="train", load_epoch=1,
                            new_params=cfg["model"], device="cpu", scale=4)
    for k, v in raw["network"].items():
        assert torch.equal(resumed.state.params[k], v), k
    assert torch.equal(resumed.model.rng.get_state(), raw["rng"])
    # the next step from the checkpoint, twice: the same bits
    rng = np.random.default_rng(12)
    batch = {"image_query": rng.random((2, 8, 8, 3)).astype(np.float32),
             "image_key": rng.random((8, 8, 8, 3)).astype(np.float32),
             "labels": np.array([1, 2])}
    handler = resumed.model
    handler.register_classes(12)
    _, first = handler.train_batch(resumed.state, batch)
    after = {k: v.clone() for k, v in resumed.state.params.items()}
    again = SISRInterface(model_loc=str(saved.parent.parent),
                          experiment=cfg["experiment"], mode="train", load_epoch=1,
                          new_params=cfg["model"], device="cpu", scale=4)
    again.model.register_classes(12)
    _, second = again.model.train_batch(again.state, batch)
    assert torch.equal(first["train-loss"], second["train-loss"])
    for k, v in again.state.params.items():
        assert torch.equal(after[k], v), k


def test_example_predictor_loads_as_bobw_encoder(predictor_run):
    from rumpy_tpu_torch.registry import get_model
    _, _, _, saved = predictor_run
    raw = torch.load(os.path.join(str(saved), "train_model_1"), weights_only=True)
    th = get_model("contrastiveblindqrcan")(
        device="cpu", scale=4, n_feats=16, n_resgroups=1, n_resblocks=1,
        pre_trained_encoder_weights=str(saved))
    state = th.init_state()
    for k, v in raw["network"].items():
        if k.startswith("encoder."):
            assert torch.equal(state.params[k], v), k


def test_example_predictor_loads_into_jax_state(predictor_run):
    """The port's checkpoint through the bridge (``jax_trees``) into the
    JAX handler's state: the same embeddings there."""
    import jax.numpy as jnp
    from flax import serialization

    from rumpy_tpu.registry import get_model as jax_model
    from rumpy_tpu_torch.interface import SISRInterface
    cfg, _, _, saved = predictor_run
    iface = SISRInterface(model_loc=str(saved.parent.parent),
                          experiment=cfg["experiment"], mode="eval", load_epoch="last",
                          new_params=cfg["model"], device="cpu", scale=4)
    trees = iface.model.jax_trees(iface.state)
    jh = jax_model("supmoco")(**cfg["model"]["internal_params"])
    js = jh.init_state()
    js = js.replace(params=serialization.from_state_dict(js.params, trees["network"]),
                    extra=serialization.from_state_dict(js.extra, trees["extra"]))
    assert int(js.extra["queue_ptr"]) == 8
    x = np.random.default_rng(13).random((2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jh.run_embedding(js, jnp.asarray(x)))
    got = iface.model.run_embedding(iface.state, x).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    leaves = jax.tree_util.tree_leaves(js.extra["queue"])
    np.testing.assert_array_equal(np.asarray(leaves[0]),
                                  iface.state.params["queue"].numpy())
