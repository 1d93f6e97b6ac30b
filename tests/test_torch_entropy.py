"""The port's local entropy and entropy patch selection
(rumpy_tpu_torch.ops.entropy, ops.cuda.local_entropy) against the JAX
package's, on the CPU.

On the CPU the kernel's wrapper runs its plain PyTorch version, which keeps
the Pallas kernel's border rule (rows edge-replicated, columns truncated);
the CUDA kernel is held against that version on the card by chip_smoke.py.
The Pallas kernel runs in interpret mode, as tests/test_pallas_kernels.py
runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.ops import entropy as jentropy
from rumpy_tpu.ops.pallas.entropy_kernel import local_entropy_pallas
from rumpy_tpu_torch.ops import entropy as tentropy
from rumpy_tpu_torch.ops.cuda import local_entropy as tkernel
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)


def _pallas_best(gray, region=10, levels=64):
    """The JAX package's local_entropy_best as it runs on a TPU, with the
    kernel in interpret mode."""
    return local_entropy_pallas(
        jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8),
        region=region, levels=levels, interpret=True)


def _gray(seed, shape=(23, 37)):
    """Smooth ramps plus noise: windows with few and with many levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    img = 4.0 * yy + 3.0 * xx + rng.normal(0, 20, shape) * (xx > shape[1] // 2)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("levels", [8, 64, 256])
@pytest.mark.parametrize("region", [3, 9, 10])
def test_plain_entropy_matches_pallas_borders_included(region, levels):
    img = _gray(region * 1000 + levels)
    got = tkernel.local_entropy(torch.from_numpy(img), region, levels).numpy()
    want = np.asarray(local_entropy_pallas(jnp.asarray(img), region=region,
                                           levels=levels, interpret=True))
    assert got.shape == want.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the border rule is the mixed one: the both-axes truncation of the
    # one-hot path gives other values in the top rows
    if region > 3:
        onehot = tentropy.local_entropy(torch.from_numpy(img), region, levels).numpy()
        assert np.abs(onehot[0] - got[0]).max() > 1e-3
        half = region // 2
        np.testing.assert_allclose(onehot[half:-half], got[half:-half], atol=1e-5)


def test_plain_entropy_on_an_image_narrower_than_the_window():
    img = _gray(5, shape=(4, 6))
    got = tkernel.local_entropy(torch.from_numpy(img), 10, 64).numpy()
    want = np.asarray(local_entropy_pallas(jnp.asarray(img), region=10, levels=64,
                                           interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("region,levels", [(3, 256), (10, 64), (9, 8)])
def test_onehot_entropy_matches_jax(region, levels):
    img = _gray(7 + region)
    got = tentropy.local_entropy(torch.from_numpy(img), region, levels).numpy()
    want = np.asarray(jentropy.local_entropy(jnp.asarray(img), region=region,
                                             levels=levels))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    img = torch.from_numpy(_gray(1))
    with pytest.raises(TypeError, match="uint8"):
        tkernel.local_entropy(img.float())
    with pytest.raises(ValueError, match="region"):
        tkernel.local_entropy(img, region=16)
    with pytest.raises(ValueError, match="levels"):
        tkernel.local_entropy(img, levels=257)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        tkernel.local_entropy(img[None])


def _rgb(seed, shape=(64, 128)):
    """An 8-bit image as a dataset decodes it: float32 in [0, 1]. Texture
    strength varies over the image so that pooled entropies differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    amp = 60.0 * (0.5 + 0.5 * np.sin(xx / 17.0 + seed)) * (0.5 + 0.5 * np.cos(yy / 11.0))
    img = 128 + amp[..., None] * rng.standard_normal(shape + (3,))
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


def test_luma_quantisation_matches_jax():
    from rumpy_tpu.utils.color import rgb_to_ycbcr
    for seed in range(4):
        img = _rgb(seed)
        y = rgb_to_ycbcr(jnp.asarray(img), y_only=True, im_type="jpg")[..., 0]
        want = np.asarray(jnp.clip(jnp.round(y * 255.0), 0, 255))
        got = tentropy.luma_u8(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("selection", ["highest", "lowest"])
@pytest.mark.parametrize("patches", [1, 3])
def test_patch_positions_match_jax(monkeypatch, patches, selection):
    """Pooled map within 1e-3 and equal corners, against the JAX function
    with its entropy map coming from the Pallas kernel."""
    monkeypatch.setattr(jentropy, "local_entropy_best", _pallas_best)
    crop = 16
    for seed in range(3):
        img = _rgb(seed)
        pooled = tentropy.pooled_entropy(img, crop, device="cpu").numpy()
        ent = _pallas_best(jnp.asarray(tentropy.luma_u8(torch.from_numpy(img)).numpy()))
        want_pooled = np.asarray(jentropy._box_filter_same(ent, crop)[
            crop // 2: ent.shape[0] - (crop - 1) // 2,
            crop // 2: ent.shape[1] - (crop - 1) // 2])
        assert pooled.shape == want_pooled.shape == (64 - crop + 1, 128 - crop + 1)
        np.testing.assert_allclose(pooled, want_pooled, atol=1e-3)
        # the picks are only comparable where the best value is clear of
        # the runner-up outside its masked neighbourhood
        flat = np.sort(want_pooled.ravel())
        assert flat[-1] - flat[0] > 1.0
        want = jentropy.entropy_patch_positions(jnp.asarray(img), crop, patches,
                                                selection=selection)
        got = tentropy.entropy_patch_positions(img, crop, patches,
                                               selection=selection, device="cpu")
        assert got == want
        assert len(got[0]) == patches


def test_patch_positions_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentropy.entropy_patch_positions(_rgb(0), 16)
