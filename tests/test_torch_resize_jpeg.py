"""The port's resize and JPEG ops (rumpy_tpu_torch.ops.resize, ops.jpeg)
against the JAX package's and Pillow, on the CPU. JPEG parity is stated
as near ties: where two float codecs round a coefficient over its step (or
a reconstructed level) on different sides of a .5 boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.ops import jpeg as jjpeg
from rumpy_tpu.ops import resize as jresize
from rumpy_tpu.utils.color import rgb_to_ycbcr as jrgb_to_ycbcr
from rumpy_tpu.utils.color import ycbcr_to_rgb as jycbcr_to_rgb
from rumpy_tpu_torch.ops import jpeg as tjpeg
from rumpy_tpu_torch.ops import resize as tresize

PIL_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
               "lanczos": Image.LANCZOS, "box": Image.BOX, "hamming": Image.HAMMING}
# a near tie: within this of a .5 rounding boundary
TIE = 1e-3


@pytest.mark.parametrize("filter", sorted(PIL_FILTERS))
@pytest.mark.parametrize("quantized", [True, False])
def test_resize_matrix_is_bit_identical(filter, quantized):
    for n_in, n_out in ((192, 48), (45, 180), (37, 12), (13, 13)):
        want = jresize.resize_matrix(n_in, n_out, filter, quantized)
        got = tresize.resize_matrix(n_in, n_out, filter, quantized)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(tresize._unscaled_matrix(40, 10, filter),
                                  jresize._unscaled_matrix(40, 10, filter))


def _diff_share(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return float(np.mean(d == 0)), int(d.max())


@pytest.mark.parametrize("filter", ["bicubic", "bilinear", "lanczos", "box"])
@pytest.mark.parametrize("out_size", [(24, 30), (32, 40), (192, 240)])
def test_pil_resize_matches_jax_and_pillow(filter, out_size):
    """Identical to the JAX version on >= 99.9 % of pixels and +-1
    elsewhere; against Pillow the same bounds (tests/test_resize.py's),
    and in fact equal."""
    rng = np.random.default_rng(0)
    img = (rng.random((96, 120, 3)) * 255).astype(np.uint8)
    got = tresize.pil_resize(img, out_size, filter)
    assert got.dtype == torch.uint8 and got.shape == out_size + (3,)
    want = jresize.pil_resize(img, out_size, filter)
    pil = np.asarray(Image.fromarray(img).resize(out_size[::-1], resample=PIL_FILTERS[filter]))
    for ref in (want, pil):
        exact, worst = _diff_share(got, ref)
        assert exact >= 0.999 and worst <= 1, (exact, worst)
    # float64 products give Pillow's integer arithmetic bit for bit
    np.testing.assert_array_equal(got.numpy(), pil)
    batch = tresize.pil_resize(torch.from_numpy(np.stack([img, img[::-1]])), out_size, filter)
    assert torch.equal(batch[0], got)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("size", [(12, 16), (48, 64), (100, 90)])
def test_resize_float_matches_jax(antialias, size):
    img = np.random.default_rng(1).random((2, 48, 64, 3), dtype=np.float32)
    want = jresize.resize_float(img, size, "bicubic", antialias)
    got = tresize.resize_float(torch.from_numpy(img), size, "bicubic", antialias)
    assert got.dtype == torch.float32 and got.shape == (2,) + size + (3,)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5


def test_pil_resize_rejects_float():
    with pytest.raises(TypeError, match="resize_float"):
        tresize.pil_resize(np.zeros((4, 4, 3), np.float32), (2, 2))


def test_scaled_qtable_is_exact():
    q = np.arange(1, 101, dtype=np.float32)
    for base in (jjpeg.LUMA_QTABLE, jjpeg.CHROMA_QTABLE):
        want = jjpeg.scaled_qtable(base, jnp.asarray(q))
        got = tjpeg.scaled_qtable(torch.from_numpy(base), torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_codec_parts(img, qtabs):
    """The JAX codec's coefficient / step ratios (B, 3, n, m, 8, 8) and its
    reconstructed levels before the final rounding (B, H, W, 3)."""
    x, h, w = jjpeg._pad_to_blocks(jnp.asarray(img))
    ycc = jrgb_to_ycbcr(x * 255.0, max_val=255.0, im_type="jpg") - 128.0
    d = jnp.asarray(jjpeg._dct_matrix())
    ratios, planes = [], []
    for ch in range(3):
        coeff = jnp.einsum("ij,bnmjk,lk->bnmil", d, jjpeg._to_blocks(ycc[..., ch]), d,
                           precision=jax.lax.Precision.HIGHEST)
        ratios.append(coeff / qtabs[ch][:, None, None])
        planes.append(jjpeg._quantize_channel(ycc[..., ch], qtabs[ch]))
    rgb = jycbcr_to_rgb(jnp.stack(planes, axis=-1) + 128.0, max_val=255.0, im_type="jpg")
    return np.asarray(jnp.stack(ratios, axis=1)), np.asarray(rgb)[:, :h, :w]


def _near_tie(v):
    frac = np.abs(np.asarray(v, np.float64)) % 1.0
    return np.abs(frac - 0.5) < TIE


def _assert_differences_are_near_ties(got, want, ratios, rgb):
    """Both outputs are levels over 255 (the last bit of the division may
    differ). Every pixel whose levels differ lies in an 8x8 block with a
    JAX coefficient / step within TIE of a .5 boundary, or has a JAX level
    within TIE of one. Returns the share of pixels that differ."""
    got_l, want_l = np.round(got * 255.0), np.round(want * 255.0)
    assert np.abs(got * 255.0 - got_l).max() < 1e-3
    diff = np.abs(got_l - want_l).max(axis=-1) > 0
    block_tie = _near_tie(ratios).any(axis=(1, 4, 5))  # (B, n, m)
    for b, y, x in zip(*np.nonzero(diff)):
        assert block_tie[b, y // 8, x // 8] or _near_tie(rgb[b, y, x]).any(), (b, y, x)
    return float(diff.mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_compress_matches_jax_up_to_near_ties(seed):
    """A non-multiple-of-8 size (edge padding and the crop back)."""
    rng = np.random.default_rng(seed)
    img = rng.random((3, 37, 45, 3), dtype=np.float32)
    quality = np.array([20.0, 60.0, 93.0], np.float32)
    want = np.asarray(jjpeg.jpeg_compress(jnp.asarray(img), jnp.asarray(quality)))
    got = tjpeg.jpeg_compress(torch.from_numpy(img), torch.from_numpy(quality)).numpy()
    assert got.shape == img.shape and 0 <= got.min() and got.max() <= 1
    ql = jjpeg.scaled_qtable(jjpeg.LUMA_QTABLE, jnp.asarray(quality))
    qc = jjpeg.scaled_qtable(jjpeg.CHROMA_QTABLE, jnp.asarray(quality))
    ratios, rgb = _jax_codec_parts(img, (ql, qc, qc))
    share = _assert_differences_are_near_ties(got, want, ratios, rgb)
    assert share < 0.01
    my_ratios, my_levels = tjpeg.tie_terms(torch.from_numpy(img), torch.from_numpy(quality))
    assert my_ratios.shape == ratios.shape and np.abs(my_ratios.numpy() - ratios).max() < 1e-3
    assert my_levels.shape == rgb.shape and np.abs(my_levels.numpy() - rgb).max() < 1e-3


def test_h264_intra_compress_matches_jax_up_to_near_ties():
    img = np.random.default_rng(2).random((2, 21, 30, 3), dtype=np.float32)
    qpi = np.array([20.0, 41.0], np.float32)
    want = np.asarray(jjpeg.h264_intra_compress(jnp.asarray(img), jnp.asarray(qpi)))
    got = tjpeg.h264_intra_compress(torch.from_numpy(img), torch.from_numpy(qpi)).numpy()
    step = jjpeg.h264_qstep(jnp.asarray(qpi))[:, None, None]
    flat = jnp.ones((1, 8, 8), jnp.float32) * step
    ratios, rgb = _jax_codec_parts(img, (flat, flat, flat))
    assert _assert_differences_are_near_ties(got, want, ratios, rgb) < 0.01
    my_ratios, _ = tjpeg.tie_terms(torch.from_numpy(img), torch.from_numpy(qpi), "h264")
    assert np.abs(my_ratios.numpy() - ratios).max() < 1e-3
