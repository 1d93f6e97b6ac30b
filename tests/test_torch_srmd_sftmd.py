"""The metadata-map models and the PCA options in the port, on the CPU,
against the JAX package: PCA encoding from the packaged matrices (and a
reference-format ``.pth``), a kernel basis fit to the JAX side's kernels,
``srmdgaussianblur`` and ``bsrganblur`` with the JAX side's draws injected
(a torch generator cannot reproduce jax.random streams), the noise-image
PCA basis fit to the JAX side's noise fields, and SRMD, EDSRMD and SFTMD
(every SFT type) through their handlers, forward and gradient.

Tolerances: kernels and their metadata within 1e-6 (the same float32
formulas), blurred images within 1e-5, PCA encodings within 1e-6 of their
largest entry; a basis fit by SVD is defined up to the sign of each row,
so a fit row is held against +- the JAX row within 1e-4 (two LAPACK SVDs
of the same float32 matrix). Models: f32 outputs within 1e-5, gradients
within 1e-4 of each gradient's largest entry; bf16 outputs within 2**-6
of the largest output.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.degradations import pca as jpca
from rumpy_tpu.degradations.blur import BSRGANBlur as JaxBSRGANBlur
from rumpy_tpu.degradations.blur import SRMDGaussianBlur as JaxSRMDBlur
from rumpy_tpu.degradations.noise import RealESRGANNoise as JaxNoise
from rumpy_tpu.ops import blur_kernels as jbk
from rumpy_tpu.ops import noise as jnoise
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.degradations import pca as tpca
from rumpy_tpu_torch.degradations.blur import BSRGANBlur, RealESRGANBlur, SRMDGaussianBlur
from rumpy_tpu_torch.degradations.noise import RealESRGANNoise
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.ops import blur_kernels as tbk
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
SVD_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _assert_rows_up_to_sign(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert min(np.abs(g - w).max(), np.abs(g + w).max()) <= SVD_ATOL


# -- PCA ---------------------------------------------------------------------

@pytest.mark.parametrize("name,k", [("standard", 10), ("extended", 100)])
def test_packaged_pca_matrices_encode_as_jax(name, k):
    want_enc = jpca.read_pca_matrix(name)
    got_enc = tpca.read_pca_matrix(name)
    assert got_enc.components == k
    np.testing.assert_array_equal(got_enc.matrix.numpy(), np.asarray(want_enc.matrix))
    rng = np.random.default_rng(k)
    kernels = jbk.gaussian_kernels(21, jnp.asarray(rng.uniform(0.2, 4.0, 6), jnp.float32),
                                   jnp.asarray(rng.uniform(0.2, 4.0, 6), jnp.float32),
                                   jnp.asarray(rng.uniform(-3, 3, 6), jnp.float32))
    flat = np.asarray(kernels).reshape(6, -1)
    want = np.asarray(want_enc(jnp.asarray(flat)))
    got = got_enc(torch.from_numpy(flat)).numpy()
    assert got.shape == (6, k)
    assert _err(got, want) <= 1e-6 * np.abs(want).max()


def test_reference_pth_matrix_loads_transposed_in_both(tmp_path):
    """A reference-format (D, k) .pth matrix, and an .npz one."""
    mat = np.random.default_rng(0).standard_normal((441, 10)).astype(np.float32)
    torch.save(torch.from_numpy(mat), tmp_path / "m.pth")
    got = tpca.read_pca_matrix(str(tmp_path / "m.pth"))
    want = jpca.read_pca_matrix(str(tmp_path / "m.pth"))
    np.testing.assert_array_equal(got.matrix.numpy(), np.asarray(want.matrix))
    assert got.matrix.shape == (10, 441)
    jpca.PCAEncoder(mat.T).save(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(tpca.read_pca_matrix(str(tmp_path / "m.npz")).matrix.numpy(),
                                  mat.T)


def test_kernel_basis_fit_to_the_jax_kernels():
    """fit_kernel_pca's chunked draws written out on the JAX side, and the
    port's fit of those kernels against the JAX package's basis."""
    cfg = dict(kernel_size=21, sig=2.6, sig_min=0.2, sig_max=4.0, rate_iso=0.5, scaling=3.0)
    sample = lambda key, n: jbk.sample_srmd_kernels(key, n, random=True, **cfg)[0]
    want = jpca.fit_kernel_pca(sample, batch_len=600, k=10, seed=3, chunk=250)
    key, chunks, remaining = jax.random.PRNGKey(3), [], 600
    while remaining > 0:
        key, sub = jax.random.split(key)
        n = min(250, remaining)
        chunks.append(np.asarray(sample(sub, n)).reshape(n, -1))
        remaining -= n
    got = tpca.pca_from_samples(torch.from_numpy(np.concatenate(chunks)), k=10)
    _assert_rows_up_to_sign(got.matrix, want.matrix)
    # the port's own draws: an orthonormal (10, 441) basis
    own = tpca.fit_kernel_pca(lambda g, n: tbk.sample_srmd_kernels(g, n, random=True, **cfg)[0],
                              batch_len=600, k=10, seed=3, chunk=250)
    np.testing.assert_allclose(own.matrix.numpy() @ own.matrix.numpy().T, np.eye(10), atol=1e-5)


# -- SRMD / BSRGAN Gaussian blur --------------------------------------------------

def _jax_srmd_draws(key, batch, sig_min, sig_max, rate_iso):
    """The draws of the JAX package's sample_srmd_kernels, its key splits
    written out (rumpy_tpu/ops/blur_kernels.py:136-176)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, lo=0.0, hi=1.0: torch.from_numpy(np.array(
        jax.random.uniform(k, (batch,), minval=lo, maxval=hi)))
    return tbk.SRMDDraws(is_iso=u(k1) < rate_iso, sigma=u(k2, sig_min, sig_max),
                         rotation=u(k3, -math.pi, math.pi), sigma_x=u(k4, sig_min, sig_max),
                         u_y=u(k5))


@pytest.mark.parametrize("rate_iso", [1.0, 0.5, 0.0])
def test_srmd_kernels_from_the_jax_draws(rate_iso):
    key = jax.random.PRNGKey(int(rate_iso * 10))
    want_k, want_m = jbk.sample_srmd_kernels(key, 12, 21, 2.6, 0.2, 4.0, rate_iso, 3.0)
    got_k, got_m = tbk.srmd_kernels_from_draws(
        21, _jax_srmd_draws(key, 12, 0.2, 4.0, rate_iso), 0.2, 4.0, 3.0)
    assert _err(got_k, want_k) <= 1e-6
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert _err(got_m[k], want_m[k]) <= 1e-6, k
    # non-random: every kernel isotropic at sig
    want_k, want_m = jbk.sample_srmd_kernels(key, 3, 15, 1.7, random=False)
    got_k, got_m = tbk.sample_srmd_kernels(torch.Generator(), 3, 15, 1.7, random=False)
    assert _err(got_k, want_k) <= 1e-6 and _err(got_m["isotropic_sigma"], [1.7] * 3) <= 1e-7


SRMD_OPS = {
    "srmd_random": (JaxSRMDBlur, SRMDGaussianBlur,
                    dict(random=True, rate_iso=0.5, request_kernel_metadata=True,
                         request_full_kernels=True, request_pca_kernels=True,
                         load_pca_matrix="standard")),
    "srmd_iso_pca": (JaxSRMDBlur, SRMDGaussianBlur,
                     dict(random=True, request_kernel_metadata=True, request_pca_kernels=True,
                          load_pca_matrix="standard")),
    "srmd_fixed": (JaxSRMDBlur, SRMDGaussianBlur,
                   dict(random=False, sig=1.3, request_kernel_metadata=True)),
    "bsrgan": (JaxBSRGANBlur, BSRGANBlur, dict(request_kernel_metadata=True)),
}


@pytest.mark.parametrize("case", list(SRMD_OPS))
def test_srmd_blur_ops_match_jax(monkeypatch, case):
    """The op's blurred batch and metadata (kernel fields, full and PCA
    kernels), the JAX side's draws injected."""
    jcls, tcls, kw = SRMD_OPS[case]
    jop, top = jcls(**kw), tcls(**kw)
    assert top.get_hyperparams() == jop.get_hyperparams()
    imgs = np.random.default_rng(1).random((4, 24, 26, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, want_m = jop.batch_apply(key, jnp.asarray(imgs))
    monkeypatch.setattr(tbk, "draw_srmd_params", lambda g, b, lo, hi, r: _jax_srmd_draws(
        key, b, lo, hi, r))
    got, got_m = top.batch_apply(torch.Generator(), torch.from_numpy(imgs))
    assert _err(got, want) <= F32_ATOL
    assert sorted(got_m) == sorted(want_m)
    for k, v in want_m.items():
        tol = 1e-6 * max(np.abs(np.asarray(v)).max(), 1.0)
        assert _err(got_m[k], v) <= tol, k
    # the views of an image share its kernel
    got2, _ = top.batch_apply(torch.Generator(), torch.from_numpy(np.repeat(imgs, 2, 0)),
                              views=2)
    assert _err(got2[::2], got) == 0.0


def test_realesrgan_blur_pca_kernels_from_the_packaged_matrix():
    op = RealESRGANBlur(kernel_range=["iso", "aniso"], request_pca_kernels=True,
                        load_pca_matrix="standard", request_full_kernels=True)
    _, meta = op.batch_apply(torch.Generator().manual_seed(0), torch.rand(3, 30, 30, 3))
    want = jpca.read_pca_matrix("standard")(jnp.asarray(meta["unmodified_blur_kernel"].numpy()))
    assert _err(meta["blur_kernel"], want) <= 1e-6 * np.abs(np.asarray(want)).max()


# -- noise-image PCA ----------------------------------------------------------------

def test_noise_image_pca_fit_to_the_jax_noise_fields():
    kw = dict(request_noise_image_pca=True, pca_batch_len=24, noise_image_pca_length=5,
              pca_patch_size=8, gaussian_noise_sigma_range=(1, 30))
    jop = JaxNoise(**kw)
    _, kg, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    blank = jnp.zeros((12, 8, 8, 3), jnp.float32)
    fields = np.concatenate([
        np.asarray(jnoise.add_gaussian_noise(kg, blank, (1, 30), 0.4, return_noise=True)[2]),
        np.asarray(jnoise.add_poisson_noise(kp, blank, (0, 1.0), 0.4, return_noise=True)[2])])
    got = tpca.pca_from_samples(torch.from_numpy(fields), k=5)
    _assert_rows_up_to_sign(got.matrix, jop.pca_encoder.matrix)
    top = RealESRGANNoise(**kw)
    assert top.pca_encoder.matrix.shape == (5, 192)
    assert top.noise_samples(torch.Generator(), 24).shape == (24, 8, 8, 3)
    loaded = RealESRGANNoise(request_noise_image_pca=True, load_pca_matrix="standard")
    assert loaded.pca_encoder.components == 10


# -- SRMD, EDSRMD, SFTMD -----------------------------------------------------------

def _grads_match(tm, gp):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tm.named_parameters()}
    got = dict(jax.tree_util.tree_flatten_with_path(jax_tree_from_state_dict(grads, tm))[0])
    want = jax.tree_util.tree_flatten_with_path(_np(gp))[0]
    assert len(got) == len(want)
    for k, w in want:
        assert np.abs(got[k] - w).max() <= F32_GRAD_REL * max(np.abs(w).max(), 1e-6), \
            jax.tree_util.keystr(k)


MODEL_CASES = {
    "srmd": ("srmd", dict(nc=16, nb=4, metadata=["blur_kernel"])),
    "edsrmd": ("edsrmd", dict(num_features=16, num_blocks=2, metadata_bypass_len=4)),
    "sftmd-standard-q": ("sftmd", dict(num_features=16, num_blocks=2, q_injection=True)),
    "sftmd-concat": ("sftmd", dict(num_features=16, num_blocks=1, sft_type="concat")),
    "sftmd-weak": ("sftmd", dict(num_features=16, num_blocks=1, sft_type="weak",
                                 metadata_bypass_len=16)),  # maps times features: M = nf
    "sftmd-split": ("sftmd", dict(num_features=16, num_blocks=1, sft_type="split",
                                  split="21")),
    "sftmd-none-x4": ("sftmd", dict(num_features=16, num_blocks=1, sft_type="none", scale=4)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_metadata_map_models_match_jax(case):
    """Forward, and every parameter's gradient of an L1 loss."""
    name, kw = MODEL_CASES[case]
    kw = dict({"scale": 2}, **kw)
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th = torch_model(name)(device="cpu", **kw)
    assert th.num_metadata == jh.num_metadata
    rng = np.random.default_rng(len(case))
    params = jax.tree_util.tree_map(  # biases off zero, so that each reaches the output
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), _np(js.params))
    state = TrainState(step=0, params=state_dict_from_jax(params, th.module))
    s = kw["scale"]
    x = rng.random((2, 7, 6, 3)).astype(np.float32)
    hr = rng.random((2, 7 * s, 6 * s, 3)).astype(np.float32)
    meta = rng.random((2, jh.num_metadata)).astype(np.float32)
    batch = {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}
    want = np.asarray(jh.apply(params, batch)[0])
    gp = jax.grad(lambda p: jnp.mean(jnp.abs(jh.apply(p, batch)[0] - hr)))(params)
    sr, _, _ = th.apply(state.params, {"lr": x, "metadata": meta})
    assert sr.shape == want.shape == (2, 7 * s, 6 * s, 3)
    np.testing.assert_allclose(sr.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    (sr - torch.from_numpy(hr)).abs().mean().backward()
    _grads_match(th.module, gp)
    with pytest.raises(RuntimeError, match="Metadata needs to be specified"):
        th.run_eval(state, {"lr": x})


@pytest.mark.parametrize("case", ["srmd", "sftmd-standard-q"])
def test_metadata_map_models_bf16_match_jax(case):
    name, kw = MODEL_CASES[case]
    kw = dict(kw, scale=2, dtype="bf16")
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th = torch_model(name)(device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np(js.params), th.module))
    rng = np.random.default_rng(2)
    x = rng.random((1, 8, 9, 3)).astype(np.float32)
    meta = rng.random((1, jh.num_metadata)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}),
                      np.float32)
    got = th.run_eval(state, {"lr": x, "metadata": meta}).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
