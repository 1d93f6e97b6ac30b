"""LPIPS in the port, on the CPU, against the JAX package
(``rumpy_tpu/utils/lpips_jax.py``): at full AlexNet width on 64 x 64
images with a seeded npz, with the same npz in other file orders (the heads
are taken in file order by both), with explicit weights, without weights
(both raise), ``convert_torch_lpips`` on seeded torch checkpoints, the
``Metrics`` hub on RGB images over ``max_value``, and the slice as a whole:
a SwinIR and an SRCNN experiment written by the JAX package, scored by both
packages' ``eval_sisr`` with ``-m PSNR -m SSIM -m LPIPS`` (the port's with
``--device cpu``).

Tolerances: distances within 1e-5 of JAX's, relative (two float32 AlexNet
passes whose sums run in different orders); in the CSVs, the model columns
within 1e-3 dB PSNR, 1e-5 SSIM and 1e-5 LPIPS (two float32 forwards), the
bicubic columns within 1e-5 dB, 1e-6 SSIM and 1e-6 LPIPS (the same
Pillow-exact resize on both sides: the JAX EvalHub runs here with Pillow's
own resize, since the JAX package's float32 bicubic is one level off Pillow
on a few values of these LR images, as tests/test_torch_meta_eval.py
notes; SRCNN's input is that bicubic image).
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from rumpy_tpu.cli.eval_sisr import main as jax_eval_main
from rumpy_tpu.evaluation import eval_hub as jax_eval_hub
from rumpy_tpu.interface import SISRInterface as JaxSISRInterface
from rumpy_tpu.utils import lpips_jax
from rumpy_tpu.utils.metrics import Metrics as JaxMetrics
from rumpy_tpu_torch.cli import eval_sisr
from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
from rumpy_tpu_torch.utils import lpips
from rumpy_tpu_torch.utils.metrics import Metrics

REL = 1e-5
MODEL_TOL = {"PSNR": 1e-3, "SSIM": 1e-5, "LPIPS": 1e-5}
BICUBIC_TOL = {"PSNR": 1e-5, "SSIM": 1e-6, "LPIPS": 1e-6}
CHANNELS = [3, 64, 192, 384, 256, 256]


def _weights(seed):
    """AlexNet's convs (He-normal, so that the taps neither vanish nor
    explode) and positive heads, in the npz layout."""
    rng = np.random.default_rng(seed)
    convs, lins = {}, {}
    for i, (f, k, _, _) in enumerate(lpips.ALEX_CFG):
        fan_in = k * k * CHANNELS[i]
        convs[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, CHANNELS[i], f))
                                     * np.sqrt(2 / fan_in)).astype(np.float32)
        convs[f"Conv_{i}/bias"] = (0.05 * rng.standard_normal(f)).astype(np.float32)
        lins[f"lin{i}"] = (0.1 * rng.random((CHANNELS[i + 1], 1))).astype(np.float32)
    return convs, lins


ORDERS = {
    "convs_then_heads": lambda c, h: list(c) + list(h),
    "heads_first": lambda c, h: list(h) + list(c),
    "interleaved": lambda c, h: [k for pair in zip(list(c)[::2], list(c)[1::2], h) for k in pair],
    "lin4_before_lin3": lambda c, h: list(c) + ["lin0", "lin1", "lin2", "lin4", "lin3"],
}


def _npz(path, order="convs_then_heads", seed=0):
    convs, lins = _weights(seed)
    both = dict(convs, **lins)
    np.savez(path, **{k: both[k] for k in ORDERS[order](convs, lins)})
    return str(path)


def _images(seed, n=3, size=64):
    rng = np.random.default_rng(seed)
    a = rng.random((n, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("order", list(ORDERS))
def test_lpips_matches_jax(tmp_path, order):
    """Both packages take the heads in the npz's file order: every order
    that keeps lin0..lin4 in sequence gives the distances of the canonical
    file, and one that puts lin4 (256 channels) before lin3 (256) gives
    other distances, in both packages alike."""
    a, b = _images(1)
    path = _npz(tmp_path / "w.npz", order)
    want = np.asarray(lpips_jax.LPIPS(path)(jnp.asarray(a), jnp.asarray(b)))
    got = lpips.LPIPS(path, device="cpu")(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    canonical = np.asarray(lpips_jax.LPIPS(_npz(tmp_path / "c.npz"))(jnp.asarray(a),
                                                                     jnp.asarray(b)))
    same = np.allclose(want, canonical, rtol=REL, atol=0)
    assert same == (order != "lin4_before_lin3")
    assert (want > 0).all()


def test_distance_takes_explicit_weights(tmp_path):
    a, b = _images(2, n=2, size=48)
    jl, tl = lpips_jax.LPIPS(_npz(tmp_path / "w.npz")), lpips.LPIPS(_npz(tmp_path / "w.npz"),
                                                                     device="cpu")
    convs, lins = _weights(7)
    params = {}
    for key, v in convs.items():
        layer, leaf = key.split("/")
        params.setdefault(layer, {})[leaf] = v
    heads = [lins[f"lin{i}"] for i in range(5)]
    want = np.asarray(jl.distance(jnp.asarray(a), jnp.asarray(b), params=params,
                                  lins=[jnp.asarray(h) for h in heads]))
    got = tl.distance(a, b, params=params, lins=heads).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert not np.allclose(got, tl.distance(a, b).numpy(), rtol=1e-3)


def test_lpips_raises_without_weights(tmp_path):
    for make in (lpips_jax.LPIPS, lambda: lpips.LPIPS(device="cpu"),
                 lambda: Metrics(["PSNR", "LPIPS"]), lambda: JaxMetrics(["PSNR", "LPIPS"])):
        with pytest.raises(NotImplementedError, match="weights"):
            make()
    with pytest.raises(NotImplementedError, match="weights"):
        EvalHub(models=[], model_loc=str(tmp_path), data_cfg={"lr_dir": str(tmp_path),
                                                              "hr_dir": str(tmp_path)},
                out_loc=str(tmp_path / "out"), metrics=["PSNR", "LPIPS"], device="cpu")


def test_convert_torch_lpips_matches_jax(tmp_path):
    """Seeded checkpoints in the official layouts (torchvision AlexNet's
    ``features.<k>`` convs among its classifier's layers, LPIPS's
    ``lin<i>.model.1.weight``) give the same npz, in the same file order."""
    gen = torch.Generator().manual_seed(3)
    alex, at = {}, 0
    for i, (f, k, _, _) in enumerate(lpips.ALEX_CFG):
        alex[f"features.{at}.weight"] = torch.randn(f, CHANNELS[i], k, k, generator=gen)
        alex[f"features.{at}.bias"] = torch.randn(f, generator=gen)
        at += 3 if i < 2 else 2
    alex["classifier.1.weight"] = torch.randn(8, 4, generator=gen)
    alex["classifier.1.bias"] = torch.randn(8, generator=gen)
    heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
             for i, c in enumerate(CHANNELS[1:])}
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(heads, tmp_path / "lpips.pth")
    lpips_jax.convert_torch_lpips(str(tmp_path / "lpips.pth"), str(tmp_path / "alex.pth"),
                                  str(tmp_path / "jax.npz"))
    lpips.convert_torch_lpips(str(tmp_path / "lpips.pth"), str(tmp_path / "alex.pth"),
                              str(tmp_path / "port.npz"))
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == want.files and len(got.files) == 15
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])
    a, b = _images(4, n=1, size=40)
    np.testing.assert_allclose(
        lpips.LPIPS(str(tmp_path / "port.npz"), device="cpu")(a, b).numpy(),
        np.asarray(lpips_jax.LPIPS(str(tmp_path / "jax.npz"))(jnp.asarray(a), jnp.asarray(b))),
        rtol=REL, atol=0)


def test_metrics_score_lpips_on_rgb_over_max_value(tmp_path):
    """With ``rgb_a``/``rgb_ref`` LPIPS scores the RGB images, divided by
    ``max_value``, beside the Y-channel PSNR and SSIM."""
    path = _npz(tmp_path / "w.npz")
    a, b = _images(5, n=2, size=40)
    rgb_a, rgb_b = a * 255, b * 255
    y_a, y_b = rgb_a[..., :1], rgb_b[..., :1]
    want = JaxMetrics(["PSNR", "SSIM", "LPIPS"], lpips_weights=path).run_metrics(
        y_a, y_b, max_value=255.0, rgb_a=rgb_a, rgb_ref=rgb_b)
    got = Metrics(["PSNR", "SSIM", "LPIPS"], lpips_weights=path).run_metrics(
        torch.from_numpy(y_a), torch.from_numpy(y_b), max_value=255.0,
        rgb_a=torch.from_numpy(rgb_a), rgb_ref=torch.from_numpy(rgb_b))
    assert list(got) == list(want)
    np.testing.assert_allclose(got["LPIPS"], want["LPIPS"], rtol=REL, atol=0)
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], atol=1e-4, rtol=0)


# -- the slice as a whole -----------------------------------------------------------

SCALE = 2
LR_SHAPES = [(32, 36), (32, 36), (33, 41)]
MODELS = {"swinir_jax": {"name": "swinir", "internal_params": {
              "embed_dim": 16, "depths": [2], "num_heads": [2], "window_size": 8,
              "num_feat": 8}},
          "srcnn_jax": {"name": "srcnn", "internal_params": {
              "channel_pattern": [1, 16, 8, 1]}}}


@pytest.fixture(scope="module")
def jax_experiments(tmp_path_factory):
    """LR/HR PNG pairs, and a SwinIR x2 and an SRCNN x2 experiment written by
    the JAX package (config.toml and a checkpoint of its seeded init)."""
    root = tmp_path_factory.mktemp("slice16")
    rng = np.random.default_rng(11)
    lr_dir, hr_dir = root / "lr", root / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k, (h, w) in enumerate(LR_SHAPES):
        yy, xx = np.mgrid[:h * SCALE, :w * SCALE]
        smooth = 128 + 60 * np.sin(xx / (4.0 + k)) * np.cos(yy / 3.0)
        hr = np.clip(smooth[..., None] + 20 * rng.standard_normal((h * SCALE, w * SCALE, 3)),
                     0, 255).astype(np.uint8)
        Image.fromarray(hr).save(hr_dir / f"im{k}.png")
        Image.fromarray(hr).resize((w, h), Image.BICUBIC).save(lr_dir / f"im{k}.png")
    model_loc = root / "Results"
    for exp, params in MODELS.items():
        iface = JaxSISRInterface(model_loc=str(model_loc), experiment=exp, mode="train",
                                 new_params=params, scale=SCALE)
        iface.save_metadata()
        iface.save(minimal=True)
    return str(model_loc), str(lr_dir), str(hr_dir), _npz(root / "lpips.npz")


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture
def pillow_bicubic(monkeypatch):
    """The JAX EvalHub's bicubic reference from Pillow itself."""
    def resize(img, size, filter="bicubic"):
        h, w = size
        return np.asarray(Image.fromarray(np.asarray(img)).resize((w, h), Image.BICUBIC))

    monkeypatch.setattr(jax_eval_hub.resize_ops, "pil_resize", resize)


def test_eval_sisr_scores_lpips_as_jax(tmp_path, jax_experiments, pillow_bicubic):
    model_loc, lr_dir, hr_dir, weights = jax_experiments
    flags = ["--model_loc", model_loc, "--scale", str(SCALE), "--lr_dir", lr_dir,
             "--hr_dir", hr_dir, "--lpips_weights", weights, "-m", "PSNR", "-m", "SSIM",
             "-m", "LPIPS"]
    for exp in MODELS:
        flags += ["-me", exp, "last"]
    r = CliRunner().invoke(jax_eval_main, flags + ["--out_loc", str(tmp_path / "jax")])
    assert r.exit_code == 0, r.output + repr(r.exception)
    eval_sisr.main(flags + ["--out_loc", str(tmp_path / "port"), "--device", "cpu"])
    for name in ("individual_metrics.csv", "average_metrics.csv"):
        got, want = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        head = 3 if name.startswith("individual") else 2
        assert got[:head] == want[:head] and [r[0] for r in got] == [r[0] for r in want]
        columns = list(zip(want[0][1:], want[1][1:]))
        for model in ("bicubic",) + tuple(MODELS):
            assert (model, "LPIPS") in columns
        for g, w in zip(got[head:], want[head:]):
            for (model, metric), gv, wv in zip(columns, g[1:], w[1:]):
                if metric == "runtime":
                    assert float(gv) > 0 and float(wv) > 0
                    continue
                tol = (BICUBIC_TOL if model == "bicubic" else MODEL_TOL)[metric]
                assert abs(float(gv) - float(wv)) <= tol, (name, w[0], model, metric, gv, wv)


def test_images_under_31_pixels_give_nan_in_jax_and_raise_in_the_port(tmp_path):
    """AlexNet's second max pool needs 31 input pixels a side: below that
    flax's pool returns an empty map and the JAX distance is NaN (its mean
    over nothing), while torch's pool raises (ROADMAP.md section 3)."""
    path = _npz(tmp_path / "w.npz")
    a, b = _images(6, n=1, size=30)
    assert np.isnan(np.asarray(lpips_jax.LPIPS(path)(jnp.asarray(a), jnp.asarray(b)))).all()
    with pytest.raises(RuntimeError, match="too small"):
        lpips.LPIPS(path, device="cpu")(a, b)
    a, b = _images(6, n=1, size=31)
    assert np.isfinite(np.asarray(lpips_jax.LPIPS(path)(jnp.asarray(a), jnp.asarray(b)))).all()
    assert torch.isfinite(lpips.LPIPS(path, device="cpu")(a, b)).all()
