"""The port's degradation pipeline (rumpy_tpu_torch.degradations) against
the JAX package's, on the CPU: metadata keys, shapes, the sampled values
in their configured and normalized ranges, the randomcompress columns,
the options that raise until a later slice, and the PCA options and
SRMD/BSRGAN blurs that raised until this one."""

import math

import jax
import numpy as np
import pytest
import torch

from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
from rumpy_tpu.degradations.pipeline import fused_degrade
from rumpy_tpu_torch.degradations import pipeline as tpipeline
from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
from rumpy_tpu_torch.registry import available_tools, get_tool

BENCH_CHAIN = dict(
    pipeline=[["realesrganblur", "b"], ["downsample", "d"],
              ["realesrgannoise", "n"], ["jpegcompress", "j"]],
    deg_configs={"b": {"kernel_range": ["iso", "aniso"], "kernel_size": 21,
                       "request_kernel_metadata": True},
                 "d": {"scale": 4},
                 "n": {"gaussian_noise_sigma_range": (1, 30)},
                 "j": {"quality": 60, "random_compression": True}})


def _example_chain():
    cfg = jax_load_config("examples/train_rcan_blind_x4.toml").as_plain()
    online = cfg["data"]["online_degradations"]
    return dict(pipeline=online["pipeline"], deg_configs=online["deg_configs"])


CHAINS = {"bench": lambda: BENCH_CHAIN, "example": _example_chain,
          "random_compress": lambda: dict(
              pipeline=[["realesrganblur", "b"], ["downsample", "d"],
                        ["randomcompress", "c"]],
              deg_configs={"b": {"request_full_kernels": True, "kernel_size": 7},
                           "d": {}, "c": {"jm_params": {"random_compression": True},
                                          "jpeg_params": {"random_compression": True}}})}


def _run(chain, batch=8, size=64, seed=0):
    pipe = ImagePipeline(**chain, scale=4)
    g = torch.Generator().manual_seed(seed)
    hr = torch.rand(batch, size, size, 3, generator=torch.Generator().manual_seed(seed + 1))
    lr, meta = pipe.degrade_batch(g, hr)
    mat, keys = pipe.metadata_matrix(meta)
    return pipe, lr, meta, mat, keys


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_metadata_keys_and_shapes_match_jax(name):
    chain = CHAINS[name]()
    want = fused_degrade(JaxPipeline(**chain, scale=4)).metadata_keys((2, 64, 64, 3))
    pipe, lr, meta, mat, keys = _run(chain)
    assert pipe.supports_fused()
    assert keys == want
    assert lr.shape == (8, 16, 16, 3) and lr.dtype == torch.float32
    assert mat.shape == (8, len(want)) and mat.dtype == torch.float32
    assert torch.isfinite(lr).all() and 0 <= float(lr.min()) and float(lr.max()) <= 1


def test_bench_chain_has_13_keys():
    keys = _run(BENCH_CHAIN)[4]
    assert len(keys) == 13
    assert keys[0] == "0-realesrganblur-beta_g" and keys[-1] == "3-jpegcompress-quality"


def test_example_chain_values_in_their_ranges():
    """64 examples through the example config's chain: every family drawn,
    normalized sigmas in [0, 1] (0 on sinc rows), raw betas and omega_c in
    their ranges, scale (4 - 2) / (8 - 2), noise scales normalized,
    quality an integer of 20..80 normalized."""
    _, _, meta, _, _ = _run(_example_chain(), batch=64, size=48, seed=3)
    m = {k.split("-", 2)[2]: v.numpy() for k, v in meta.items()}
    sinc = m["kernel_type"] == 6
    assert set(m["kernel_type"].astype(int)) == set(range(7))
    for k in ("sigma_x", "sigma_y"):
        assert (m[k][sinc] == 0).all() and (m[k] >= 0).all() and (m[k] <= 1).all()
    gen = m["beta_g"][m["beta_g"] != 0]
    assert gen.size and gen.min() >= 0.5 and gen.max() <= 8
    omega = m["omega_c"][sinc]
    assert omega.min() >= math.pi / 3 - 1e-6 and omega.max() <= math.pi + 1e-6
    assert np.allclose(m["scale"], 1 / 3) and (m["kernel_size"] == 21).all()
    g, p = m["gaussian_noise_scale"], m["poisson_noise_scale"]
    assert ((g == 0) | (p == 0)).all() and (g > 0).any() and (p > 0).any()
    assert g.max() <= 1 and p.max() <= 1 and set(np.unique(m["gray_noise"])) <= {0.0, 1.0}
    q = m["quality"] * 60 + 20
    assert np.allclose(q, np.round(q), atol=1e-4) and q.min() >= 20 and q.max() <= 80


def test_randomcompress_dual_columns():
    """jm_qpi or jpeg_quality per row, the other column 0; both kinds
    occur; the full kernels come out flattened."""
    _, lr, meta, mat, keys = _run(CHAINS["random_compress"](), batch=64, size=32)
    jm, jp = meta["2-randomcompress-jm_qpi"].numpy(), meta["2-randomcompress-jpeg_quality"].numpy()
    assert ((jm == 0) | (jp == 0)).all() and (jm > 0).any() and (jp > 0).any()
    assert jm.max() <= 1 and jp.max() <= 1
    assert meta["0-realesrganblur-unmodified_blur_kernel"].shape == (64, 49)
    assert keys.count("0-realesrganblur-unmodified_blur_kernel") == 49
    assert mat.shape == (64, 49 + 3)


def test_non_random_noise_keeps_the_inverted_gray_quirk():
    """Value-based selection: the Gaussian type when only its scale is set;
    gray noise with probability 1 - gray_noise_probability."""
    op = get_tool("realesrgannoise")(random_noise_generation=False, gaussian_noise_scale=10.0,
                                     gray_noise_probability=0.0)
    img = torch.full((16, 8, 8, 3), 0.5)  # far from the clip at 10 / 255 sigma
    out, meta = op.batch_apply(torch.Generator().manual_seed(1), img)
    assert (meta["gray_noise"] == 1).all() and (meta["poisson_noise_scale"] == 0).all()
    assert (meta["gaussian_noise_scale"] == 10).all()  # normalized by the (0, 1) range
    noise = out - img
    assert float(noise.abs().max()) > 0
    assert torch.equal(noise[..., 0], noise[..., 1]) and torch.equal(noise[..., 0], noise[..., 2])


def test_registry_lists_the_jax_tools():
    from rumpy_tpu.registry import available_tools as jax_tools
    assert sorted(available_tools()) == sorted(jax_tools())
    with pytest.raises(KeyError, match="Unknown degradation op"):
        get_tool("bogus")


def _jax_srmd_draws(key, batch, sig_min, sig_max, rate_iso):
    """The draws of the JAX package's sample_srmd_kernels, its key splits
    written out (rumpy_tpu/ops/blur_kernels.py:136-176)."""
    from rumpy_tpu_torch.ops.blur_kernels import SRMDDraws
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, lo=0.0, hi=1.0: torch.from_numpy(np.array(
        jax.random.uniform(k, (batch,), minval=lo, maxval=hi)))
    return SRMDDraws(is_iso=u(k1) < rate_iso, sigma=u(k2, sig_min, sig_max),
                     rotation=u(k3, -math.pi, math.pi), sigma_x=u(k4, sig_min, sig_max),
                     u_y=u(k5))


@pytest.mark.parametrize("option", ["pca_kernels", "noise_pca", "srmd", "bsrgan"])
def test_pca_options_raise_naming_their_slice(monkeypatch, option):
    """The PCA options and the SRMD/BSRGAN blurs raised until
    degradations/pca.py was ported; each now builds as the JAX package's
    does: the packaged kernel basis and its encoding, the noise basis's
    shape, and each blur's output and metadata from the same draws (the
    default srmdgaussianblur draws nothing)."""
    from rumpy_tpu.degradations import blur as jblur
    from rumpy_tpu.degradations import noise as jnoise
    from rumpy_tpu_torch.ops import blur_kernels as tbk
    imgs = np.random.default_rng(3).random((2, 24, 22, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    if option == "noise_pca":
        kw = dict(request_noise_image_pca=True, pca_batch_len=16, noise_image_pca_length=4,
                  pca_patch_size=8)
        got = get_tool("realesrgannoise")(**kw).pca_encoder.matrix
        want = jnoise.RealESRGANNoise(**kw).pca_encoder.matrix
        assert tuple(got.shape) == tuple(want.shape) == (4, 192)
        np.testing.assert_allclose(got.numpy() @ got.numpy().T, np.eye(4), atol=1e-5)
        return
    kw = dict(request_kernel_metadata=True, request_pca_kernels=True,
              load_pca_matrix="standard")
    name, jcls = {"pca_kernels": ("realesrganblur", jblur.RealESRGANBlur),
                  "srmd": ("srmdgaussianblur", jblur.SRMDGaussianBlur),
                  "bsrgan": ("bsrganblur", jblur.BSRGANBlur)}[option]
    top, jop = get_tool(name)(**kw), jcls(**kw)
    np.testing.assert_array_equal(top.pca_encoder.matrix.numpy(),
                                  np.asarray(jop.pca_encoder.matrix))
    assert top.get_hyperparams() == jop.get_hyperparams()
    want, want_m = jop.batch_apply(key, jax.numpy.asarray(imgs))
    if option == "bsrgan":  # random: the JAX side's draws
        monkeypatch.setattr(tbk, "draw_srmd_params", lambda g, b, lo, hi, r: _jax_srmd_draws(
            key, b, lo, hi, r))
    if option == "pca_kernels":  # random families: hold the encoding of its own kernels
        top.request_full_kernels = True
        _, got_m = top.batch_apply(torch.Generator(), torch.from_numpy(imgs))
        assert set(got_m) == set(want_m) | {"unmodified_blur_kernel"}
        enc = got_m["unmodified_blur_kernel"].numpy() @ np.asarray(jop.pca_encoder.matrix).T
        np.testing.assert_allclose(got_m["blur_kernel"].numpy(), enc, atol=1e-6, rtol=0)
        return
    got, got_m = top.batch_apply(torch.Generator(), torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert sorted(got_m) == sorted(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(v), atol=1e-6, rtol=0)


def test_random_scale_raises_on_the_device_path():
    op = get_tool("downsample")(random_scale=True)
    with pytest.raises(NotImplementedError, match="dynamic shapes"):
        op.batch_apply(torch.Generator(), torch.zeros(1, 8, 8, 3))
    up = get_tool("upsample")(scale=2)
    out, meta = up.batch_apply(torch.Generator(), torch.rand(2, 8, 8, 3))
    assert out.shape == (2, 16, 16, 3) and float(meta["scale"][0]) == 0.0
