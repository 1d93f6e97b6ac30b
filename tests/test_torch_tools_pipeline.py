"""Offline degradation in the port (rumpy_tpu_torch.degradations host paths,
native.py and cli/image_manipulate.py) against the JAX package's, on the
CPU.

Tolerances: the numpy-drawn chain (JPEG, the native H.264 codec, the
compression coin) is bit-identical, its CSV files are the same text and its
config parses equal; with a downsample the crops and shapes are identical
and LR values within 1 level on <= 0.1 % of pixels (the JAX package's
float32 bicubic against the port's Pillow-exact one); the blur and noise
host calls, with the JAX side's draws injected, give uint8 images within 1
level on <= 0.5 % of pixels (float rounding before the truncating cast),
metadata within 1e-6 and PCA lists within 1e-5."""

import math
import os
import sys
import tomllib

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from rumpy_tpu.cli.image_manipulate import main as jax_manipulate_main
from rumpy_tpu.degradations import blur as jblur_ops
from rumpy_tpu.degradations import noise as jnoise_ops
from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
from rumpy_tpu.degradations.pipeline import pipeline_prep_and_run as jax_prep_and_run
from rumpy_tpu.degradations.resize_ops import Downsample as JaxDownsample
from rumpy_tpu.degradations.resize_ops import Upsample as JaxUpsample
from rumpy_tpu.native import h264_intra as jax_h264_intra
from rumpy_tpu_torch import native
from rumpy_tpu_torch.cli import image_manipulate
from rumpy_tpu_torch.config.loader import dump_toml
from rumpy_tpu_torch.degradations import base as tbase
from rumpy_tpu_torch.degradations.noise import NoiseDraws
from rumpy_tpu_torch.degradations.pipeline import ImagePipeline, pipeline_prep_and_run
from rumpy_tpu_torch.ops import noise as tnoise
from rumpy_tpu_torch.registry import get_tool
from rumpy_tpu_torch.utils.csv_text import write_table
from test_torch_degradation_ops import _jax_draws
from test_torch_pipeline import _jax_srmd_draws

SHAPES = [(40, 52), (37, 45), (48, 48)]
CODECS = {"pipeline": [["jpegcompress", "q"], ["jmcompress", "j"], ["randomcompress", "r"]],
          "deg_configs": {"q": {"random_compression": True},
                          "j": {"random_compression": True},
                          "r": {"jm_params": {"random_compression": True},
                                "jpeg_params": {"random_compression": True}}}}
DOWN = {"pipeline": [["downsample", "d"], ["jpegcompress", "q"], ["jmcompress", "j"]],
        "deg_configs": {"d": {"scale": 4}, "q": {"random_compression": True},
                        "j": {"random_compression": True}}}


def _u8(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _smooth(h, w, seed):
    """A photo-like image: smooth structure plus mild noise, uint8."""
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 70 * np.sin(xx / (5.0 + seed)) * np.cos(yy / 7.0)
    noise = 12 * np.random.default_rng(seed).standard_normal((h, w, 3))
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    src = tmp_path_factory.mktemp("tools_src")
    for i, (h, w) in enumerate(SHAPES):
        Image.fromarray(_smooth(h * 4, w * 4, i)).save(src / f"im{i}.png")
    return src


def _run_both(chain, src, root, seed=5, multiples=2):
    jax_prep_and_run(dict(chain), source_dir=str(src), output_dir=str(root / "jax"),
                     seed=seed, multiples=multiples)
    pipeline_prep_and_run(dict(chain), source_dir=str(src), output_dir=str(root / "port"),
                          seed=seed, multiples=multiples, device="cpu")
    return root / "jax", root / "port"


def _text(path):
    with open(path) as f:
        return f.read()


def _assert_same_tables(want_dir, got_dir):
    for name in ("degradation_metadata.csv", "degradation_hyperparameters.csv"):
        assert _text(got_dir / name) == _text(want_dir / name), name
    with open(want_dir / "degradation_config.toml", "rb") as f:
        want_cfg = tomllib.load(f)
    with open(got_dir / "degradation_config.toml", "rb") as f:
        assert tomllib.load(f) == want_cfg


def _images(d):
    return sorted(n for n in os.listdir(d) if n.endswith((".png", ".npy")))


def _load(path):
    return np.load(path) if str(path).endswith(".npy") else np.asarray(Image.open(path))


@pytest.mark.parametrize("seed", [5, 11])
def test_numpy_drawn_chain_is_bit_identical(tmp_path, sources, seed):
    """JPEG at a random quality, JM at a random qpi on the native codec,
    and the compression coin, through both packages' pipeline_prep_and_run
    with multiples=2: the same images, CSV text and config."""
    want_dir, got_dir = _run_both(CODECS, sources, tmp_path, seed=seed)
    assert _images(got_dir) == _images(want_dir) == [
        f"im{i}_q{m}.png" for i in range(3) for m in range(2)]
    for n in _images(want_dir):
        assert np.array_equal(_load(got_dir / n), _load(want_dir / n)), n
    _assert_same_tables(want_dir, got_dir)
    meta = pd.read_csv(got_dir / "degradation_metadata.csv")
    assert {"2-randomcompress-jm_qpi", "2-randomcompress-jpeg_quality"} <= set(meta.columns)


def test_downsample_chain_matches_jax(tmp_path, sources):
    """downsample x4 with jm (an even LR size for the 4:2:0 codec), then
    JPEG and JM: identical shapes, CSV text and config; LR values within 1
    level on <= 0.1 % of pixels (the resizes' rounding)."""
    want_dir, got_dir = _run_both(DOWN, sources, tmp_path)
    assert _images(got_dir) == _images(want_dir)
    for n in _images(want_dir):
        got, want = _load(got_dir / n), _load(want_dir / n)
        i = int(n[2])
        h, w = SHAPES[i]
        assert got.shape == want.shape == ((h // 2) * 2, (w // 2) * 2, 3), n
        diff = np.abs(got.astype(int) - want)
        assert (diff > 0).mean() <= 1e-3 and (diff.max() <= 1 or (diff > 0).mean() == 0), n
    _assert_same_tables(want_dir, got_dir)


@pytest.mark.parametrize("jm,random_scale", [(False, False), (True, False), (False, True)])
def test_downsample_host_call_matches_jax(jm, random_scale):
    """The centre crop (even with jm), the seeded random scale and Pillow's
    bicubic: shapes and metadata equal, values within 1 level."""
    img = _smooth(75, 101, 3)
    kw = dict(jm=jm, random_scale=random_scale, scale_range=(2, 5), seed=4)
    top, jop = get_tool("downsample")(**kw), JaxDownsample(**kw)
    top.bind_host("cpu")
    for _ in range(3):
        (got, gm), (want, wm) = top(img), jop(img)
        assert got.shape == np.asarray(want).shape and gm == wm
        assert np.abs(got.astype(int) - want).max() <= 1


def test_upsample_host_call_matches_jax():
    img = _smooth(13, 17, 1)
    top, jop = get_tool("upsample")(scale=3), JaxUpsample(scale=3)
    top.bind_host("cpu")
    (got, gm), (want, wm) = top(img), jop(img)
    assert gm == wm and got.shape == (39, 51, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("qp", [20, 28, 37, 51])
def test_native_codec_matches_jax(qp):
    """The port's build of native/rumpy_native.cpp and the JAX package's
    give the same H.264 intra round trip, bit for bit."""
    img = _u8(34, 46, qp)
    assert np.array_equal(native.h264_intra(img, qp), jax_h264_intra(img, qp))


@pytest.mark.parametrize("as_pil", [True, False])
def test_jm_binary_route_matches_jax(tmp_path, as_pil):
    """With a JM binary configured (a mock lencod.exe that copies its input
    planes to the recon file), both packages write the same 4:2:0 planes
    and read back the same image, an odd-sized one cropped to even sides."""
    from rumpy_tpu.degradations.compression import JMCompress as JaxJM
    from test_degradation_ops import _fake_jm_dir
    jm_bin = _fake_jm_dir(tmp_path)
    img = _smooth(25, 31, 6)
    image = Image.fromarray(img) if as_pil else img
    top = get_tool("jmcompress")(qpi=30, jm_bin=jm_bin)
    top.bind_host("cpu")
    (got, gm), (want, wm) = top(image), JaxJM(qpi=30, jm_bin=jm_bin)(image)
    assert gm == wm and isinstance(got, Image.Image) == as_pil
    assert np.asarray(got).shape == (24, 30, 3)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_native_build_failure_raises_naming_gpp(monkeypatch, tmp_path):
    """No g++: NativeUnavailable naming it, and no stand-in codec."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SO", str(tmp_path / "build" / "librumpy_native.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+"):
        native.h264_intra(_u8(8, 8, 0), 30)
    op = get_tool("jmcompress")(qpi=30)
    op.bind_host("cpu")
    with pytest.raises(native.NativeUnavailable):
        op(_u8(8, 8, 0))


def test_jpeg_host_path_needs_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    op = get_tool("jpegcompress")(quality=40)
    op.bind_host("cpu")
    with pytest.raises(ImportError, match="PIL"):
        op(_u8(8, 8, 0))


def test_ffmpeg_without_binary_takes_the_h264_approximation(monkeypatch):
    """No ffmpeg: the JAX package's route, the H.264-intra approximation of
    the device path at the shifted qp; within 1 level on <= 0.5 % of
    pixels."""
    from rumpy_tpu.degradations.compression import FFMPEGCompress as JaxFFMPEG
    img = _smooth(32, 40, 2)
    kw = dict(qpi=30, shift_encoder_qp=True)
    top, jop = get_tool("ffmpegcompress")(**kw), JaxFFMPEG(**kw)
    top.ffmpeg = jop.ffmpeg = None
    top.bind_host("cpu")
    (got, gm), (want, wm) = top(img), jop(img)
    assert gm == wm
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


BLURS = {
    "iso_aniso_kernel_meta": ("realesrganblur", dict(
        kernel_range=["iso", "aniso"], request_kernel_metadata=True)),
    "all_families_pca": ("realesrganblur", dict(
        kernel_range="all", request_kernel_metadata=True, request_pca_kernels=True,
        load_pca_matrix="standard", noise_range=(0.8, 1.2))),
    "full_kernels_13": ("realesrganblur", dict(
        kernel_range=["generalized_aniso", "plateau_iso"], request_full_kernels=True,
        kernel_size=13)),
    "srmd_random": ("srmdgaussianblur", dict(
        random=True, rate_iso=0.5, request_kernel_metadata=True, request_pca_kernels=True,
        load_pca_matrix="standard")),
    "srmd_fixed": ("srmdgaussianblur", dict(sig=1.7, request_kernel_metadata=True)),
    "bsrgan": ("bsrganblur", dict(request_kernel_metadata=True)),
}


def _close_u8(got, want, share=5e-3):
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


def _close_meta(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        tol = 1e-5 if isinstance(want[k], list) else 1e-6
        assert np.abs(np.subtract(got[k], want[k])).max() <= tol, k


@pytest.mark.parametrize("name", list(BLURS))
def test_blur_host_call_with_jax_draws_matches_jax(name):
    """Each blur family's host call on one image, the JAX op's draws (its
    key split once a call) injected into the port's."""
    tool, kw = BLURS[name]
    seed = 3
    jop = {"realesrganblur": jblur_ops.RealESRGANBlur,
           "srmdgaussianblur": jblur_ops.SRMDGaussianBlur,
           "bsrganblur": jblur_ops.BSRGANBlur}[tool](seed=seed, **kw)
    top = get_tool(tool)(seed=seed, **kw)
    top.bind_host("cpu")
    img = _smooth(30, 34, 4)
    key = jax.random.PRNGKey(seed)
    for _ in range(2 if name == "iso_aniso_kernel_meta" else 1):  # a second call's new key
        want, want_m = jop(img)
        key, sub = jax.random.split(key)
        if tool == "realesrganblur":
            draws = _jax_draws(sub, 1, jop.cfg)
        elif getattr(top, "random", False):
            draws = _jax_srmd_draws(sub, 1, top.sig_min, top.sig_max, top.rate_iso)
        else:
            draws = None
        got, got_m = top(img, draws=draws)
        assert got.dtype == np.uint8 and got.shape == want.shape
        _close_u8(got, want)
        _close_meta(got_m, want_m)


def _jax_noise_draws(op, key, img):
    """The draws of the JAX noise op's host call, its key splits written
    out (rumpy_tpu/degradations/noise.py:103-139, rumpy_tpu/ops/noise.py)."""
    k_type, k_apply = jax.random.split(key)
    k_sig, k_gray, k_noise = jax.random.split(k_apply, 3)
    gs = op.gaussian_noise_sigma_range
    ps = op.poisson_noise_scale_range
    gray_p = op.gray_noise_probability
    if not op.random_noise:
        g = float(op.specific.get("gaussian_noise_scale") or 0.0)
        p = float(op.specific.get("poisson_noise_scale") or 0.0)
        gs, ps, gray_p = (g, g), (p, p), 1.0 - op.gray_noise_probability
        use_gauss = np.full((1,), g > 0)
    else:
        use_gauss = np.asarray(jax.random.uniform(k_type, (1,)) < op.gaussian_poisson_ratio)
    t = lambda a: torch.from_numpy(np.array(a))
    sigma = jax.random.uniform(k_sig, (1,), minval=gs[0], maxval=gs[1])
    scale = jax.random.uniform(k_sig, (1,), minval=ps[0], maxval=ps[1])
    gray = (jax.random.uniform(k_gray, (1,)) < gray_p).astype(np.float32)
    field = jax.random.normal(k_noise, (1,) + img.shape, np.float32)
    x = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
    rounded, gray_img, vals_c, vals_g = (r.numpy() for r in tnoise.poisson_rates(x))
    # the Poisson path splits k_apply as the Gaussian one does: its scale,
    # gray flag and samples come from k_sig, k_gray and k_noise
    sample_c = jax.random.poisson(k_noise, rounded * vals_c)
    sample_g = jax.random.poisson(k_noise, gray_img * vals_g)
    return NoiseDraws(use_gauss=t(use_gauss), sigma=t(sigma), gaussian_gray=t(gray),
                      field=t(field), scale=t(scale), poisson_gray=t(gray),
                      sample_c=t(sample_c), sample_g=t(sample_g))


NOISES = {
    "random": dict(gaussian_noise_sigma_range=(1, 30), poisson_noise_scale_range=(0.05, 3)),
    "random_gray": dict(gaussian_noise_sigma_range=(1, 30), gray_noise_probability=1.0),
    "pca_noise": dict(gaussian_noise_sigma_range=(1, 30), request_noise_image_pca=True,
                      pca_patch_size=16),
    "fixed_gaussian": dict(random_noise_generation=False, gaussian_noise_scale=12.0),
    "fixed_poisson": dict(random_noise_generation=False, poisson_noise_scale=1.5,
                          gray_noise_probability=0.0),
}


@pytest.mark.parametrize("name", list(NOISES))
def test_noise_host_call_with_jax_draws_matches_jax(name, tmp_path):
    """The noise op's host call on one image with the JAX op's draws
    injected (two calls at seed 7 take both types); pca_noise from one
    saved basis (24 components of a 16 x 16 x 3 patch, zero-padded crop of
    a smaller image)."""
    kw = dict(NOISES[name])
    if kw.get("request_noise_image_pca"):
        basis = np.linalg.qr(np.random.default_rng(0).standard_normal((768, 24)))[0].T
        np.savez(tmp_path / "noise_pca.npz", matrix=basis.astype(np.float32))
        kw["load_pca_matrix"] = str(tmp_path / "noise_pca.npz")
    jop = jnoise_ops.RealESRGANNoise(seed=7, **kw)
    top = get_tool("realesrgannoise")(seed=7, **kw)
    top.bind_host("cpu")
    img = _smooth(14, 20, 5)  # under the 16-pixel patch on one side: a padded crop
    key = jax.random.PRNGKey(7)
    kinds = set()
    for _ in range(2 if name == "random" else 1):
        want, want_m = jop(img)
        key, sub = jax.random.split(key)
        draws = _jax_noise_draws(jop, sub, img)
        got, got_m = top(img, draws=draws)
        kinds.add(bool(draws.use_gauss[0]))
        _close_u8(got, want)
        _close_meta(got_m, want_m)
    if name == "random":
        assert kinds == {True, False}


def test_host_call_draws_from_its_own_seeded_generator():
    """Without injected draws the host call draws from the op's generator,
    seeded with its seed: the same seed gives the same image."""
    img = _smooth(20, 24, 1)
    outs = []
    for _ in range(2):
        op = get_tool("realesrganblur")(seed=9, kernel_range=["aniso"],
                                        request_kernel_metadata=True)
        op.bind_host("cpu")
        outs.append(op(img))
    assert np.array_equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


def test_in_memory_run_matches_jax():
    """run_pipeline on arrays: the same images and the same metadata
    vector and keys (sorted-key order) as the JAX package."""
    imgs = [_smooth(24, 28, 2), _smooth(20, 20, 3)]
    want = JaxPipeline(**CODECS, seed=3).run_pipeline(images=imgs, progress_bar_off=True)
    got = ImagePipeline(**CODECS, seed=3, device="cpu").run_pipeline(
        images=imgs, progress_bar_off=True)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]


def test_npy_images_give_the_png_run(tmp_path, sources):
    """uint8 .npy images in, .npy out (the route where PIL is absent): the
    same pixels as the PNG run, and the same metadata under .npy names."""
    npy_src = tmp_path / "npy_src"
    os.makedirs(npy_src)
    for n in sorted(os.listdir(sources)):
        np.save(npy_src / n.replace(".png", ".npy"), np.asarray(Image.open(sources / n)))
    png = pipeline_prep_and_run(dict(CODECS), source_dir=str(sources),
                                output_dir=str(tmp_path / "png"), seed=2, device="cpu")
    npy = pipeline_prep_and_run(dict(CODECS), source_dir=str(npy_src),
                                output_dir=str(tmp_path / "npy"), seed=2, device="cpu",
                                output_extension=".npy")
    names = _images(npy)
    assert names == [n.replace(".png", ".npy") for n in _images(png)]
    for n in names:
        assert np.array_equal(np.load(os.path.join(npy, n)),
                              _load(os.path.join(png, n.replace(".npy", ".png"))))
    assert _text(os.path.join(npy, "degradation_metadata.csv")) == _text(
        os.path.join(png, "degradation_metadata.csv")).replace(".png", ".npy")


def test_default_extension_is_npy_without_pil(monkeypatch):
    assert ImagePipeline(["jpegcompress"]).output_extension == ".png"
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert ImagePipeline(["jpegcompress"]).output_extension == ".npy"


COLUMNS = {
    "ints": [3, 4, 5],
    "floats": [0.1, 0.30000000000000004, 1e-05],
    "ints_and_floats": [0, 0.5, 2],
    "with_none": [1, None, 2.5],
    "lists": [[0.1, 0.2], [0.3, 0.4], [1e-07, 2.0]],
    "mixed": [20, "srmd", [0.6, 5], None],
    "tuples_and_strings": [(0.5, 8), "real_esrgan", 21],
    "numpy_floats": [np.float64(0.25), np.float64(1 / 3), np.float64(2.0)],
}


@pytest.mark.parametrize("name", list(COLUMNS))
def test_csv_cells_are_pandas_text(tmp_path, name):
    """A column of each kind the pipeline writes, through the port's writer
    and through pandas' to_csv: the same text."""
    values = COLUMNS[name]
    index = [f"im{i}" for i in range(len(values))]
    write_table(str(tmp_path / "port.csv"), "image", index, {"c": values})
    df = pd.DataFrame.from_dict({i: {"c": v} for i, v in zip(index, values)}, orient="index")
    df.index.rename("image", inplace=True)
    df.to_csv(tmp_path / "pandas.csv")
    assert _text(tmp_path / "port.csv") == _text(tmp_path / "pandas.csv")


def test_image_manipulate_cli_matches_jax(tmp_path, sources):
    """The port's argparse CLI and the JAX package's click CLI on one TOML
    config: the same files, images and CSV text."""
    cfg = tmp_path / "chain.toml"
    dump_toml(dict(CODECS), str(cfg))
    flags = ["-p", str(cfg), "-s", str(sources), "--seed", "8", "--multiples", "2"]
    r = CliRunner().invoke(jax_manipulate_main, flags + ["-o", str(tmp_path / "jax")])
    assert r.exit_code == 0, r.output + repr(r.exception)
    out = image_manipulate.main(flags + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert out == str(tmp_path / "port")
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for n in _images(want_dir):
        assert np.array_equal(_load(got_dir / n), _load(want_dir / n)), n
    _assert_same_tables(want_dir, got_dir)


def test_pca_matrix_is_saved_beside_the_outputs(tmp_path, sources):
    """A blur with PCA kernels writes its basis as the JAX package does."""
    chain = {"pipeline": [["realesrganblur", "b"]],
             "deg_configs": {"b": {"request_pca_kernels": True,
                                   "load_pca_matrix": "standard"}}}
    JaxPipeline(**chain).run_pipeline(image_files=[str(sources / "im0.png")],
                                      save_to_dir=str(tmp_path), progress_bar_off=True)
    want = np.load(tmp_path / "RealESRGANBlur_pca_matrix.npz")["matrix"]
    os.remove(tmp_path / "RealESRGANBlur_pca_matrix.npz")
    ImagePipeline(**chain, device="cpu").run_pipeline(
        image_files=[str(sources / "im0.png")], save_to_dir=str(tmp_path),
        progress_bar_off=True)
    assert np.array_equal(np.load(tmp_path / "RealESRGANBlur_pca_matrix.npz")["matrix"], want)


def test_pipeline_host_path_raises_without_cuda(monkeypatch, sources, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImagePipeline(**CODECS).run_pipeline(images=[_u8(8, 8, 0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbase.DegradationOp()._host_device()
    cfg = tmp_path / "chain.toml"
    dump_toml(dict(CODECS), str(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        image_manipulate.main(["-p", str(cfg), "-s", str(sources), "-o", str(tmp_path / "o")])


def test_float_array_round_trip_truncates():
    """from_float_array clips and truncates, as the JAX package's does."""
    from rumpy_tpu.degradations.base import from_float_array as jax_from
    x = np.array([[[-0.1, 0.0, 0.99999], [0.5, 0.50196, 1.3]]], np.float32)  # 0.50196 * 255 < 128
    assert np.array_equal(tbase.from_float_array(x, False), jax_from(x, False))
    assert tbase.from_float_array(x, False).tolist() == [[[0, 0, 254], [127, 127, 255]]]
    arr, was_pil = tbase.to_float_array(Image.fromarray(_u8(4, 4, 1)))
    assert was_pil and arr.dtype == np.float32 and math.isclose(float(arr.max()) * 255,
                                                                 float(_u8(4, 4, 1).max()),
                                                                 rel_tol=1e-6)
