"""The degradation slice as a whole on the CPU: a deterministic chain in
the train step of both packages from the same weights, TrainingHandler
with a [data.online_degradations] table, the HR-only, interp and
colour-distort datasets against the JAX package's on the same rng draws,
and the degradation generator across a checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.data import datasets as jdata
from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.data import datasets as tdata
from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.training.trainer import TrainingHandler
from rumpy_tpu_torch.utils.weights import state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

RCAN_KW = dict(scale=4, n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4)
# no random draws: a fixed iso sigma 2 blur, x4 downsample, JPEG quality 60
DETERMINISTIC = dict(
    pipeline=[["realesrganblur", "b"], ["downsample", "d"], ["jpegcompress", "j"]],
    deg_configs={"b": {"random_selection": False, "selected_kernel": "iso",
                       "sigma_x": 2.0, "request_kernel_metadata": True},
                 "d": {"scale": 4}, "j": {"quality": 60}})
BENCH_TABLE = {
    "pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                 ["realesrgannoise", "n"], ["jpegcompress", "j"]],
    "deg_configs": {"b": {"kernel_range": ["iso", "aniso"], "kernel_size": 21,
                          "request_kernel_metadata": True},
                    "d": {"scale": 4}, "n": {"gaussian_noise_sigma_range": [1, 30]},
                    "j": {"quality": 60, "random_compression": True}}}


def _input_fn(pipe):
    def fn(key_or_generator, batch):
        lr, meta = pipe.degrade_batch(key_or_generator, batch["hr"])
        return {"lr": lr, "hr": batch["hr"], "metadata": pipe.metadata_matrix(meta)[0]}
    return fn


def test_deterministic_chain_trains_one_step_like_jax():
    """The same weights through the bridge and the same HR batch: the
    metadata matrices equal, the step's loss within 1e-4 relative."""
    hr = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    jpipe, tpipe = JaxPipeline(**DETERMINISTIC), ImagePipeline(**DETERMINISTIC)
    jlr, jmeta = jpipe.degrade_batch(jax.random.PRNGKey(0), jnp.asarray(hr))
    tlr, tmeta = tpipe.degrade_batch(torch.Generator(), torch.from_numpy(hr))
    jmat, jkeys = jpipe.metadata_matrix(jmeta)
    tmat, tkeys = tpipe.metadata_matrix(tmeta)
    assert tkeys == jkeys and len(tkeys) == 10
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    assert tlr.shape == jlr.shape == (2, 8, 8, 3)
    assert float(np.abs(tlr.numpy() - np.asarray(jlr)).max()) <= 1.0 / 255 + 1e-6

    jh = jax_model("rcan")(**RCAN_KW, lr=1e-3)
    jh.set_input_pipeline(_input_fn(jpipe))
    js = jh.init_state()
    th = torch_model("rcan")(device="cpu", **RCAN_KW, lr=1e-3)
    th.init_state()
    th.module.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), th.module))
    th.set_input_pipeline(_input_fn(tpipe))
    ts = th._own_state()
    for _ in range(2):
        js, jl = jh.train_batch(js, {"hr": jnp.asarray(hr)})
        ts, tl = th.train_batch(ts, {"hr": hr})
        want, got = float(jl["train-loss"]), float(tl["train-loss"])
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert ts.step == 2


@pytest.fixture(scope="module")
def hr_images(tmp_path_factory):
    """Five HR images as PNG files and as .npy files, three of them smaller
    than a 40-pixel crop on one side, and their x2 decimations as LR."""
    root = tmp_path_factory.mktemp("hr_only")
    rng = np.random.default_rng(1)
    dirs = {k: root / k for k in ("png", "npy", "png_lr")}
    for d in dirs.values():
        os.makedirs(d)
    for k, (h, w) in enumerate([(48, 56), (36, 52), (44, 30), (64, 64), (41, 47)]):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(dirs["png"] / f"im{k}.png")
        np.save(dirs["npy"] / f"im{k}.npy", img)
        lr = img[:h - h % 2:2, :w - w % 2:2].copy()  # LR * 2 fits in the HR image
        Image.fromarray(lr).save(dirs["png_lr"] / f"im{k}.png")
    return {k: str(v) for k, v in dirs.items()}


def _items(ds, n=None):
    return [ds[i] for i in range(n or len(ds))]


@pytest.mark.parametrize("files", ["png", "npy"])
@pytest.mark.parametrize("crop_count", [1, 2])
def test_hr_only_crops_pad_and_match_jax(hr_images, files, crop_count):
    """Uniform crops of crop * scale, undersized images reflect-padded up
    to it, augmented: the JAX dataset's arrays on the same seed."""
    kw = dict(scale=4, crop=10, crop_count=crop_count, augmentations=True,
              online_degradations=True, seed=5)
    jds = jdata.SuperResImages(hr_dir=hr_images["png"], **kw)
    tds = tdata.SuperResImages(lr_dir=hr_images["png_lr"], hr_dir=hr_images[files],
                               device="cpu", **kw)
    assert len(tds) == len(jds) == 5
    for _ in range(2):  # two epochs of draws
        for a, b in zip(_items(jds), _items(tds)):
            shape = (crop_count, 40, 40, 3) if crop_count > 1 else (40, 40, 3)
            assert b["hr"].shape == shape and b["hr"].dtype == np.float32
            np.testing.assert_array_equal(a["hr"], b["hr"])
            assert "lr" not in b and b["metadata"].size == 0


def test_interp_dataset_matches_jax(hr_images):
    """The LR upsampled by pil_resize before the crop: the JAX arrays, up to
    one level on at most 0.1 % of the values (Pillow-exact against JAX's
    float32 products)."""
    kw = dict(scale=2, crop=12, augmentations=True, input="interp", seed=3)
    jds = jdata.SuperResImages(lr_dir=hr_images["png_lr"], hr_dir=hr_images["png"], **kw)
    tds = tdata.SuperResImages(lr_dir=hr_images["png_lr"], hr_dir=hr_images["png"],
                               device="cpu", **kw)
    for a, b in zip(_items(jds), _items(tds)):
        assert b["lr"].shape == b["hr"].shape == (12, 12, 3)
        np.testing.assert_array_equal(a["hr"], b["hr"])
        d = np.abs(a["lr"] - b["lr"]) * 255
        assert d.max() <= 1 + 1e-3 and np.mean(d > 0.5) <= 1e-3


def _jax_draws_for(monkeypatch):
    """Make the port's dataset use the JAX package's colour draws for the
    seed it drew (the JAX dataset keys jax.random with that seed)."""
    from test_torch_degradation_ops import _jax_colour_draws

    def draws(generator, n, strength):
        return _jax_colour_draws(jax.random.PRNGKey(generator.initial_seed()), n, strength)
    monkeypatch.setattr(tdata, "colour_distortion_draws", draws)


@pytest.mark.parametrize("online", [False, True])
def test_colour_distort_dataset_matches_jax(monkeypatch, hr_images, online):
    """One seed from the dataset's rng, the same draws for LR and HR, whole
    images distorted before the crop (HR-only: the patch after its
    augmentation): the JAX arrays within 1e-5."""
    _jax_draws_for(monkeypatch)
    kw = dict(scale=2, crop=8, augmentations=True, use_random_colour_distort=True,
              colour_distortion_strength=0.7, seed=4, online_degradations=online)
    jds = jdata.SuperResImages(lr_dir=hr_images["png_lr"], hr_dir=hr_images["png"], **kw)
    tds = tdata.SuperResImages(lr_dir=hr_images["png_lr"], hr_dir=hr_images["png"],
                               device="cpu", **kw)
    for a, b in zip(_items(jds), _items(tds)):
        assert set(a) == set(b)
        for k in ("lr", "hr"):
            if k in a:
                assert b[k].dtype == np.float32
                assert float(np.abs(a[k] - b[k]).max()) <= 1e-5
    with pytest.raises(ValueError, match="RGB"):
        tdata.SuperResImages(hr_dir=hr_images["png"], colorspace="ycbcr",
                             use_random_colour_distort=True, device="cpu")


def _config(path, hr_dir, save_loc, table, **data):
    dump_toml({
        "experiment": "rcan_online", "experiment_save_loc": str(save_loc),
        "data": {"scale": 4, "crop": 8, "augmentations": True, "dataloader_threads": 1,
                 "training_sets": {"data_1": {"hr_dir": hr_dir}},
                 "online_degradations": table, **data},
        "model": {"name": "rcan", "internal_params": dict(RCAN_KW, lr=1e-3)},
        "training": {"num_epochs": 1, "batch_size": 2, "seed": 1},
    }, str(path))
    return load_config(str(path))


def test_training_handler_runs_the_online_table(hr_images, tmp_path):
    """Two steps of batch 2 from HR-only .npy files through the bench
    chain; the requested metadata columns reach the batch; a bare
    boolean is refused."""
    cfg = _config(tmp_path / "c.toml", hr_images["npy"], tmp_path / "out", BENCH_TABLE,
                  metadata=["sigma_x", "quality"])
    h = TrainingHandler(cfg, verbose=False, device="cpu")
    assert h.online_pipeline is not None
    stats = h.run_experiment()
    assert h.model.state.step == 2 and np.isfinite(stats[0]["train-loss"])
    batch = h.model.model.input_fn(torch.Generator().manual_seed(0),
                                   {"hr": torch.rand(3, 32, 32, 3)})
    assert batch["lr"].shape == (3, 8, 8, 3) and batch["metadata"].shape == (3, 2)
    q = batch["metadata"][:, 1] * 60 + 20
    assert torch.allclose(q, q.round(), atol=1e-4)
    with pytest.raises(ValueError, match="bare boolean"):
        TrainingHandler(_config(tmp_path / "b.toml", hr_images["npy"], tmp_path / "b", True),
                        verbose=False, device="cpu")


def test_degradation_generator_survives_a_checkpoint(tmp_path):
    """A resumed run continues the stream: the loaded generator's next
    draws are the saved one's."""
    th = torch_model("rcan")(device="cpu", **RCAN_KW)
    th.set_input_pipeline(_input_fn(ImagePipeline(**{
        k: v for k, v in BENCH_TABLE.items()})))
    ts = th.init_state(seed=2)
    ts, _ = th.train_batch(ts, {"hr": np.random.default_rng(0).random(
        (2, 32, 32, 3), dtype=np.float32)})
    th.save_model(ts, str(tmp_path), epoch=0)
    want = torch.rand(8, generator=th.rng)
    other = torch_model("rcan")(device="cpu", **RCAN_KW)
    assert not torch.equal(torch.rand(8, generator=other.rng), want)
    other.load_model(str(tmp_path), "last")
    assert torch.equal(torch.rand(8, generator=other.rng), want)
    # a fresh state reseeds the stream
    th.init_state(seed=2)
    fresh = torch_model("rcan")(device="cpu", **RCAN_KW)
    fresh.init_state(seed=2)
    assert torch.equal(torch.rand(4, generator=th.rng), torch.rand(4, generator=fresh.rng))
