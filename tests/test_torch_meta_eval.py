"""The metadata-conditioned slice as a whole, on the CPU, against the JAX
package: examples/train_qrcan_meta_attention.toml at test width (QRCAN
``max_concat`` with q-layers on the chain's sigma_x, sigma_y and
kernel_type), an eval set and its degradation_metadata.csv written by the
JAX package's offline ``pipeline_prep_and_run`` with the example's chain,
a tiny experiment trained by the JAX TrainingHandler on it, scored by both
packages' EvalHub and eval_sisr; the metadata matrix a model trains on
against the one it is scored on, built both ways in both packages; one
train step of the example; and the example through the port's CLIs.

Tolerances: the metric CSVs as tests/test_torch_eval.py holds them (model
columns 1e-3 dB PSNR and 1e-5 SSIM, bicubic 1e-5 dB and 1e-6 SSIM). The
JAX package's float32 bicubic is one level off Pillow on 3 values of one
of these LR images (10 x 11; a known divergence, ROADMAP.md section 3,
where the port is Pillow-exact), so its EvalHub runs here with Pillow's
own resize for the bicubic reference, which the port's is held to; the
metadata matrices bit for bit (the same float32 values, the same
arithmetic); a train step under SGD at lr 1 (a parameter moves by its
gradient) within 1e-6 on the loss and each parameter after it within
1e-4 of its move plus two float32 ulps of a parameter below 1.
"""

import copy
import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from rumpy_tpu.cli.eval_sisr import main as jax_eval_main
from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.data.datasets import SuperResImages as JaxSuperResImages
from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
from rumpy_tpu.degradations.pipeline import pipeline_prep_and_run
from rumpy_tpu.evaluation import eval_hub as jax_eval_hub
from rumpy_tpu.evaluation.eval_hub import EvalHub as JaxEvalHub
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.training.trainer import TrainingHandler as JaxTrainingHandler
from rumpy_tpu_torch.cli import eval_sisr, train_sisr
from rumpy_tpu_torch.config.loader import dump_toml, load_config
from rumpy_tpu_torch.data.datasets import SuperResImages
from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.training.trainer import TrainingHandler
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from test_torch_eval import assert_same_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "train_qrcan_meta_attention.toml")
SCALE = 4
WIDTH = dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4, dtype="float32")
EXP = "qrcan_x4_bobw"  # the example's experiment name
HR_SIDES = [(48, 40), (48, 40), (48, 40), (40, 44), (52, 48)]


def _example(save_loc, hr_dir, eval_lr, eval_hr, epochs=1):
    """The example at test width: HR-only training set, the eval set with
    its CSV (``on_site``), 1 epoch, batch 2, crop 8."""
    cfg = load_config(EXAMPLE).as_plain()
    cfg["experiment_save_loc"] = str(save_loc)
    cfg["data"].update(crop=8, dataloader_threads=1)
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": str(eval_lr), "hr_dir": str(eval_hr),
                                           "metadata_file": "on_site"}}
    cfg["model"]["internal_params"].update(WIDTH)
    cfg["training"].update(num_epochs=epochs, batch_size=2, seed=0, eval_batch_size=2)
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """HR PNGs, and the eval set the JAX offline pipeline writes from them
    with the example's chain: LR PNGs and degradation_metadata.csv."""
    root = tmp_path_factory.mktemp("meta_data")
    rng = np.random.default_rng(0)
    hr_dir = root / "hr"
    os.makedirs(hr_dir)
    for k, (h, w) in enumerate(HR_SIDES):
        yy, xx = np.mgrid[:h, :w]
        smooth = 128 + 60 * np.sin(xx / (4.0 + k)) * np.cos(yy / 3.0)
        img = np.clip(smooth[..., None] + 25 * rng.standard_normal((h, w, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(hr_dir / f"im{k}.png")
    chain = load_config(EXAMPLE).as_plain()["data"]["online_degradations"]
    pipeline_prep_and_run(dict(chain), source_dir=str(hr_dir), output_dir=str(root / "lr"),
                          seed=3)
    return root, hr_dir, root / "lr"


@pytest.fixture(scope="module")
def experiment(tmp_path_factory, data):
    """One epoch of the JAX trainer on the example: a flax checkpoint,
    summary.csv with validation on the CSV eval set. Returns (model_loc,
    the JAX TrainingHandler, its config)."""
    root, hr_dir, lr_dir = data
    save = tmp_path_factory.mktemp("meta_exp")
    cfg = _example(save / "Results", hr_dir, lr_dir, hr_dir)
    dump_toml(cfg, str(save / "train.toml"))
    handler = JaxTrainingHandler(jax_load_config(str(save / "train.toml")), verbose=False)
    handler.model.save_metadata()
    stats = handler.run_experiment()
    assert np.isfinite(stats[0]["val-PSNR"])
    return str(save / "Results"), handler, cfg


@pytest.fixture
def pillow_bicubic(monkeypatch):
    """The JAX EvalHub's bicubic reference from Pillow itself."""
    filters = {"bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}

    def resize(img, size, filter="bicubic"):
        h, w = size
        return np.asarray(Image.fromarray(np.asarray(img)).resize((w, h), filters[filter]))

    monkeypatch.setattr(jax_eval_hub.resize_ops, "pil_resize", resize)


def test_eval_hub_scores_with_metadata_like_jax(tmp_path, data, experiment, pillow_bicubic):
    _, hr_dir, lr_dir = data
    model_loc, _, _ = experiment
    kwargs = dict(models=[{"experiment": EXP, "epoch": "last"}], model_loc=model_loc,
                  data_cfg={"lr_dir": str(lr_dir), "hr_dir": str(hr_dir),
                            "metadata_file": "on_site"},
                  scale=SCALE, metrics=["PSNR", "SSIM"], time_models=True)
    JaxEvalHub(out_loc=str(tmp_path / "jax"), **kwargs).full_image_protocol()
    table = EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kwargs).full_image_protocol()
    assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), EXP)
    assert table.images == [f"im{k}.png" for k in range(len(HR_SIDES))]


def test_eval_sisr_metadata_file_matches_jax(tmp_path, data, experiment, pillow_bicubic):
    _, hr_dir, lr_dir = data
    model_loc, _, _ = experiment
    flags = ["--model_loc", model_loc, "--scale", str(SCALE), "--lr_dir", str(lr_dir),
             "--hr_dir", str(hr_dir), "-me", EXP, "best", "-m", "PSNR", "-m", "SSIM",
             "--metadata_file", str(lr_dir / "degradation_metadata.csv")]
    r = CliRunner().invoke(jax_eval_main, flags + ["--out_loc", str(tmp_path / "jax")])
    assert r.exit_code == 0, r.output + repr(r.exception)
    eval_sisr.main(flags + ["--out_loc", str(tmp_path / "port"), "--device", "cpu"])
    assert_same_metrics(str(tmp_path / "port"), str(tmp_path / "jax"), EXP, runtime=False)


def test_a_model_whose_keys_the_set_lacks_is_dropped_in_both(tmp_path, data, experiment,
                                                             capsys):
    """An eval CSV without the kernel_type column: both packages drop the
    model, print why, and score bicubic alone."""
    _, hr_dir, lr_dir = data
    model_loc, _, _ = experiment
    lr2 = tmp_path / "lr"
    shutil.copytree(lr_dir, lr2)
    with open(lr_dir / "degradation_metadata.csv", newline="") as f:
        rows = list(csv.reader(f))
    keep = [i for i, c in enumerate(rows[0]) if not c.endswith("kernel_type")]
    with open(lr2 / "degradation_metadata.csv", "w", newline="") as f:
        csv.writer(f).writerows([[r[i] for i in keep] for r in rows])
    kwargs = dict(models=[{"experiment": EXP, "epoch": "last"}], model_loc=model_loc,
                  data_cfg={"lr_dir": str(lr2), "hr_dir": str(hr_dir),
                            "metadata_file": "on_site"}, scale=SCALE, metrics=["PSNR"])
    jhub = JaxEvalHub(out_loc=str(tmp_path / "jax"), **kwargs)
    want = capsys.readouterr().out
    hub = EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kwargs)
    got = capsys.readouterr().out
    assert not hub.models and not jhub.models
    assert got == want == f"dropping {EXP}: dataset lacks metadata ['kernel_type']\n"
    assert hub.full_image_protocol().columns == [("bicubic", "PSNR"), ("bicubic", "runtime")]


def _jax_chain_draws(n, seed):
    """The example chain's output and metadata on n HR crops, from the JAX
    package (its keys)."""
    chain = load_config(EXAMPLE).as_plain()["data"]["online_degradations"]
    pipe = JaxPipeline(chain["pipeline"], deg_configs=chain["deg_configs"], scale=SCALE)
    hr = np.random.default_rng(seed).random((n, 32, 32, 3)).astype(np.float32)
    lr, meta = pipe.degrade_batch(jax.random.PRNGKey(seed), jnp.asarray(hr))
    return hr, np.asarray(lr), {k: np.asarray(v) for k, v in meta.items()}


def test_train_and_eval_metadata_matrices(tmp_path, data, experiment):
    """The matrix a model trains on against the one it is scored on, for the
    same images and draws, each built by both packages' own code: the
    trainer's online input function (its chain's draws replaced by the
    JAX side's), and the eval set's CSV (the JAX offline layout: columns
    in step order) read by SuperResImages and narrowed by the handler.
    The two packages agree on each, bit for bit. Both differ from their
    training matrix in the same way, which the port keeps: the CSV path
    min-max normalises every column over the eval set, on top of the
    blur op's range normalisation of the sigmas. The columns come in the
    same (requested) order both ways here; the CSV path follows the CSV's
    order."""
    _, hr_dir, _ = data
    _, jtrainer, cfg = experiment
    n = 6
    hr, lr, meta = _jax_chain_draws(n, seed=11)

    # training: each package's trainer input function on the JAX draws
    jtrainer.online_pipeline.degrade_batch = lambda key, b: (jnp.asarray(lr), {
        k: jnp.asarray(v) for k, v in meta.items()})
    want_train = np.asarray(jtrainer.model.model.input_fn(jax.random.PRNGKey(0), {
        "hr": jnp.asarray(hr)})["metadata"])
    port_cfg = copy.deepcopy(cfg)
    port_cfg["experiment_save_loc"] = str(tmp_path / "port_results")
    port_cfg["no_directories"] = True
    ptrainer = TrainingHandler(port_cfg, device="cpu", verbose=False)
    ptrainer.online_pipeline.degrade_batch = lambda gen, b, views=1: (torch.from_numpy(lr), {
        k: torch.from_numpy(v) for k, v in meta.items()})
    got_train = ptrainer.model.model.input_fn(torch.Generator(), {
        "hr": torch.from_numpy(hr)})["metadata"].numpy()
    np.testing.assert_array_equal(got_train, want_train)
    assert want_train.shape == (n, 3)

    # evaluation: the same values through a CSV in the offline layout
    lr_dir = tmp_path / "eval_lr"
    os.makedirs(lr_dir)
    names = [f"e{k}.png" for k in range(n)]
    for name, img in zip(names, lr):
        Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(np.uint8)).save(lr_dir / name)
    with open(lr_dir / "degradation_metadata.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image"] + list(meta))
        for i, name in enumerate(names):
            w.writerow([name] + [float(v[i]) for v in meta.values()])
    mats = []
    for ds_cls, handler in ((JaxSuperResImages, jtrainer.model.model),
                            (SuperResImages, ptrainer.model.model)):
        ds = ds_cls(lr_dir=str(lr_dir), metadata_file="on_site", scale=SCALE,
                    **({"device": "cpu"} if ds_cls is SuperResImages else {}))
        rows = np.stack([ds[i]["metadata"] for i in range(len(ds))])
        mats.append(np.asarray(handler.select_metadata(rows, keys=ds.metadata_keys)))
    want_eval, got_eval = mats
    np.testing.assert_array_equal(got_eval, want_eval)

    # both differ from training by a min-max normalisation over the set
    lo, hi = want_train.min(0), want_train.max(0)
    np.testing.assert_allclose(want_eval, (want_train - lo) / (hi - lo), atol=1e-6, rtol=0)
    assert np.abs(want_eval - want_train)[:, :2].max() > 0.05  # the sigmas moved


def test_example_train_step_matches_jax():
    """One step of the example's model at test width (f32; SGD at lr 1 in
    place of its Adam, so that a parameter moves by its gradient) on one
    batch with metadata, from the same state."""
    internal = load_config(EXAMPLE).as_plain()["model"]["internal_params"]
    kw = dict(internal, **WIDTH, optimizer_type="sgd", lr=1.0)
    jh = jax_model("qrcan")(**kw)
    js = jh.init_state()
    th = torch_model("qrcan")(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js.params),
                                                  th.module))
    state = th._own_state()  # the module's own tensors, which the step updates
    assert th.num_metadata == jh.num_metadata == 3
    rng = np.random.default_rng(4)
    batch = {"lr": rng.random((2, 8, 8, 3)).astype(np.float32),
             "hr": rng.random((2, 32, 32, 3)).astype(np.float32),
             "metadata": rng.random((2, 3)).astype(np.float32)}
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, tl = th.train_batch(state, batch)
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)
    want_after = jax.tree_util.tree_map(np.asarray, js2.params)
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want_after)[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        assert np.abs(g - w).max() <= 1e-4 * move + 2.0 ** -22, jax.tree_util.keystr(path)


def test_example_trains_and_scores_through_the_port_clis(tmp_path, data):
    """The example through cli.train_sisr (validation on the CSV eval set)
    and cli.eval_sisr --metadata_file on its saved run."""
    _, hr_dir, lr_dir = data
    cfg = _example(tmp_path / "Results", hr_dir, lr_dir, hr_dir)
    dump_toml(cfg, str(tmp_path / "train.toml"))
    stats = train_sisr.main(["-p", str(tmp_path / "train.toml"), "--device", "cpu"])
    assert np.isfinite([stats[0]["train-loss"], stats[0]["val-PSNR"]]).all()
    out = tmp_path / "scores"
    eval_sisr.main(["--model_loc", str(tmp_path / "Results"), "--out_loc", str(out),
                    "--lr_dir", str(lr_dir), "--hr_dir", str(hr_dir), "--scale", str(SCALE),
                    "--metadata_file", "on_site", "-me", EXP, "last", "--device", "cpu"])
    with open(out / "individual_metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert (EXP, "PSNR") in list(zip(rows[0][1:], rows[1][1:]))
    assert len(rows) == 3 + len(HR_SIDES)
