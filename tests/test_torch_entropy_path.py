"""The entropy patch path of the port as it runs on the card, checked on the
CPU: the entropy kernel's arithmetic and walk
(rumpy_tpu_torch.ops.cuda.local_entropy), its fused grey-level front, the
window-sum kernel's plain version and pick (ops.cuda.window_sum), the
shared luma evaluation order of utils/color.py against the JAX package's,
and crop-first conversion in the dataset.

The CUDA kernels run only on the card, where chip_smoke.py holds them
against these plain versions; here numpy models of their arithmetic stand
in for them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.ops import entropy as jentropy
from rumpy_tpu.utils.color import rgb_to_ycbcr as jax_rgb_to_ycbcr
from rumpy_tpu_torch.data.datasets import SuperResImages
from rumpy_tpu_torch.ops import entropy as tentropy
from rumpy_tpu_torch.ops.cuda import local_entropy as tkernel
from rumpy_tpu_torch.ops.cuda import window_sum as twindow
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

# chip_smoke.py's tolerance of the kernel against its plain version
ENTROPY_ATOL = 1e-5


def _direct_entropy(counts):
    """-sum p log2 p in float64."""
    counts = np.asarray(counts, np.float64)
    p = counts / counts.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, p * np.log2(p), 0.0)
    return -terms.sum(axis=-1)


def _fixed_point_entropy(counts):
    """The kernel's arithmetic: entropy (float32 bits) of histograms
    (..., bins) of total N <= 225 as log2(N) - S / N, S the integer sum of
    the kernel's table over the bins."""
    counts = np.asarray(counts, np.int64)
    s = tkernel.plogp_table()[counts].sum(axis=-1)
    n = counts.sum(axis=-1).astype(np.float64)
    return (np.log2(n) - s / (n * 2.0 ** tkernel.FRACTION_BITS)).astype(np.float32)


@pytest.mark.parametrize("region", [9, 10, 15])
def test_fixed_point_entropy_matches_the_direct_formula(region):
    """log2(N) - S/N with S summed from the fixed-point table, against
    -sum p log2 p, over random histograms of every total N up to region**2
    (1..225 at region 15), skewed from one bin to many."""
    rng = np.random.default_rng(region)
    worst = 0.0
    for levels in (64, 256):
        for n in range(1, region * region + 1):
            bins = rng.integers(1, min(levels, n) + 1, size=8)
            counts = np.zeros((8, levels), np.int64)
            for row, k in zip(counts, bins):
                row[:k] = rng.multinomial(n, rng.dirichlet(np.full(k, 0.3)))
            got = _fixed_point_entropy(counts)
            assert got.dtype == np.float32
            worst = max(worst, float(np.abs(got - _direct_entropy(counts)).max()))
    assert worst <= ENTROPY_ATOL, worst


def test_fixed_point_table():
    table = tkernel.plogp_table()
    assert table.shape == (tkernel.MAX_REGION ** 2 + 1,) and table.dtype == np.int64
    c = np.arange(2, 226, dtype=np.float64)
    exact = c * np.log2(c) * 2.0 ** tkernel.FRACTION_BITS
    assert table[0] == table[1] == 0
    assert np.abs(table[2:] - exact).max() <= 0.5
    assert table.max() < 2 ** 31  # S, at most table[225], fits the kernel's int


def _column_walk(gray, region, levels, band=64, strip=8):
    """The kernel's walk in numpy (csrc/local_entropy.cu): a band of
    columns over a strip of rows staged with the halo (rows clamped,
    columns outside the image never counted); each column's histogram of
    its window rows counted for the strip's first row, then moved down a
    row by one removal and one addition; a pixel's window histogram the sum
    of its region columns' histograms (no count past 225: packed bytes never
    carry); its total N = region * (columns inside); S from the table."""
    h, w = gray.shape
    half = region // 2
    table = tkernel.plogp_table()
    q = (gray.astype(np.int64) * levels) >> 8
    out = np.zeros((h, w), np.float32)
    for y0 in range(0, h, strip):
        rows = np.clip(np.arange(y0 - half, y0 - half + strip + region - 1), 0, h - 1)
        for x0 in range(0, w, band):
            cols = np.arange(x0 - half, x0 - half + band + region - 1)
            inside = np.flatnonzero((cols >= 0) & (cols < w))
            tile = q[rows][:, np.clip(cols, 0, w - 1)]
            hist = np.zeros((len(cols), levels), np.int64)
            for c in inside:
                hist[c] = np.bincount(tile[:region, c], minlength=levels)
            y_end = min(y0 + strip, h)
            for y in range(y0, y_end):
                for t in range(min(band, w - x0)):
                    x = x0 + t
                    win = hist[t:t + region].sum(axis=0)
                    n = region * (min(w - x + half, region) - max(half - x, 0))
                    assert win.sum() == n and win.max() <= 225
                    out[y, x] = np.log2(n) - int(table[win].sum()) * (1.0 / (n * 2.0 ** 20))
                if y + 1 < y_end:
                    for c in inside:
                        hist[c, tile[y - y0, c]] -= 1
                        hist[c, tile[y - y0 + region, c]] += 1
    return out


@pytest.mark.parametrize("shape,region,levels", [
    ((23, 70), 10, 64), ((13, 37), 9, 256), ((4, 6), 10, 64), ((19, 20), 15, 8),
    ((17, 67), 3, 64)])
def test_column_walk_matches_the_plain_version_borders_included(shape, region, levels):
    """Strips of 8 rows, bands of 64 columns (two bands at width 70),
    images smaller than a window, and every border."""
    rng = np.random.default_rng(region * levels)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    img = np.clip(4.0 * yy + 3.0 * xx + rng.normal(0, 20, shape) * (xx > shape[1] // 3),
                  0, 255).astype(np.uint8)
    want = tkernel.local_entropy_reference(torch.from_numpy(img), region, levels).numpy()
    got = _column_walk(img, region, levels)
    np.testing.assert_allclose(got, want, atol=ENTROPY_ATOL)


def _rgb_u8(seed, shape=(64, 128)):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


def test_fused_front_gives_luma_u8_grey_levels():
    """The plain version of the kernel's front from uint8 (v / 255 as the
    dataset converts), and the plain grey levels of the float32 image that
    float input takes, equal luma_u8 of the converted image bit for bit,
    and the JAX package's grey levels."""
    for seed in range(6):
        u8 = _rgb_u8(seed)
        f32 = u8.astype(np.float32) / 255.0
        want = tentropy.luma_u8(torch.from_numpy(f32)).numpy()
        for got in (tkernel.grey_levels(torch.from_numpy(u8)),
                    tkernel.grey_levels_reference(torch.from_numpy(f32))):
            assert got.dtype == torch.uint8 and got.shape == u8.shape[:2]
            np.testing.assert_array_equal(got.numpy(), want)
        y = jax_rgb_to_ycbcr(jnp.asarray(f32), y_only=True, im_type="jpg")[..., 0]
        np.testing.assert_array_equal(want, np.asarray(jnp.clip(jnp.round(y * 255.0), 0, 255)))
    # the entropy of an RGB image, uint8 or float32, is that of its grey levels
    u8 = torch.from_numpy(_rgb_u8(9, (30, 41)))
    want = tkernel.local_entropy(tkernel.grey_levels(u8), 9, 64)
    for src in (u8, u8.float() / 255.0):
        torch.testing.assert_close(tkernel.local_entropy_rgb(src, 9, 64), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint8 image"):
        tkernel.grey_levels(u8.float())


def test_kernels_build_without_fast_math():
    """The fused front's grey levels and the window sums are bit-exact only
    with IEEE division and rounding: no --use_fast_math."""
    from rumpy_tpu_torch.ops.cuda import build
    assert not any("fast" in flag for flag in build.NVCC_FLAGS)


def test_rgb_to_ycbcr_matches_jax():
    """20 random 8-bit 64x128 images: no grey level of the jpg Y channel
    flips against the JAX package (the multiply-add order flipped 24 of
    163,840), y_only bit for bit, and every channel of the full conversion
    within one float32 ulp of the images' range [0, 1]."""
    flips = 0
    for seed in range(20):
        img = _rgb_u8(100 + seed).astype(np.float32) / 255.0
        for im_type in ("jpg", "png"):
            for y_only in (True, False):
                want = np.asarray(jax_rgb_to_ycbcr(jnp.asarray(img), y_only=y_only,
                                                   im_type=im_type))
                got = rgb_to_ycbcr(torch.from_numpy(img), y_only=y_only,
                                   im_type=im_type).numpy()
                assert got.dtype == np.float32 and got.shape == want.shape
                if y_only:
                    np.testing.assert_array_equal(got, want)
                assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
        y = rgb_to_ycbcr(torch.from_numpy(img), y_only=True, im_type="jpg").numpy()
        jy = np.asarray(jax_rgb_to_ycbcr(jnp.asarray(img), y_only=True, im_type="jpg"))
        flips += int((np.clip(np.round(y * 255), 0, 255)
                      != np.clip(np.round(jy * 255), 0, 255)).sum())
    assert flips == 0


@pytest.mark.parametrize("size", [1, 5, 16])
def test_window_sum_reference_is_the_jax_pooled_map(size):
    ent = np.random.default_rng(size).random((37, 53)).astype(np.float32) * 6
    got = twindow.window_sum(torch.from_numpy(ent), size).numpy()
    want = np.asarray(jentropy._box_filter_same(jnp.asarray(ent), size)[
        size // 2: 37 - (size - 1) // 2, size // 2: 53 - (size - 1) // 2])
    assert got.shape == (37 - size + 1, 53 - size + 1)
    np.testing.assert_array_equal(got, want)


def _window_chains(v, size, n):
    """The kernel's schedule of n window sums in numpy (csrc/window_sum.cu
    ::window_chains): sum m adds v[m], ..., v[m + size - 1] in ascending
    order, rounded to float32 at every add, the n sums fed one value at a
    time."""
    acc = [None] * n
    for a in range(size + n - 1):
        for m in range(n):
            if a == m:
                acc[m] = v[a]
            elif m < a and a - m < size:
                acc[m] = np.float32(acc[m] + v[a])
    return acc


def _window_walk(ent, size, rows=16, seg=8, cols=64):
    """The kernel's walk: blocks of rows x cols outputs over a tile of the
    map (zeros outside it), each column of the tile summed down for the
    block's rows, then each row segment of seg outputs summed across."""
    h, w = ent.shape
    ho, wo = h - size + 1, w - size + 1
    out = np.full((ho, wo), np.nan, np.float32)
    for y0 in range(0, ho, rows):
        for x0 in range(0, wo, cols):
            tile = np.zeros((rows + size - 1, cols + size - 1), np.float32)
            part = ent[y0:y0 + tile.shape[0], x0:x0 + tile.shape[1]]
            tile[:part.shape[0], :part.shape[1]] = part
            sums = np.stack([_window_chains(tile[:, c], size, rows)
                             for c in range(tile.shape[1])], axis=1)
            for r in range(min(rows, ho - y0)):
                for xs in range(0, min(cols, wo - x0), seg):
                    acc = _window_chains(sums[r, xs:], size, seg)
                    for m in range(min(seg, wo - x0 - xs)):
                        out[y0 + r, x0 + xs + m] = acc[m]
    return out


@pytest.mark.parametrize("shape,size", [((37, 53), 16), ((24, 30), 1), ((21, 90), 5),
                                        ((30, 83), 17), ((20, 31), 20)])
def test_window_walk_gives_the_plain_bits(shape, size):
    """Sixteen (down the rows) or eight (across) chains at a time, each in
    ascending order: the plain version's bits, windows shorter and longer than a chain group, two
    blocks across, ragged edges."""
    ent = (np.random.default_rng(size).random(shape) * 6).astype(np.float32)
    want = twindow.window_sum_reference(torch.from_numpy(ent), size).numpy()
    np.testing.assert_array_equal(_window_walk(ent, size), want)


def _pick_key(value, index, lowest):
    """The kernel's pick key in numpy: the value's bits ordered as the
    floats sort (negated for the minimum, -0 as +0), above 0xffffffff -
    index."""
    v = np.float32(-value if lowest else value) + np.float32(0.0)
    u = int(np.array(v, np.float32).view(np.uint32))
    ordered = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (ordered << 32) | (0xFFFFFFFF - index)


@pytest.mark.parametrize("lowest", [False, True])
def test_pick_key_chooses_the_first_best_as_numpy(lowest):
    """The largest key is np.nanargmax's (np.nanargmin's) choice, ties to the
    first index, on maps with ties, negatives and both zeros; pick_index
    reads it back and pick_reference agrees."""
    rng = np.random.default_rng(int(lowest))
    for trial in range(20):
        vals = rng.choice(np.float32([-2.5, -0.0, 0.0, 1.25, 3.0, 7.5]), size=(6, 9))
        keys = [_pick_key(v, i, lowest) for i, v in enumerate(vals.ravel())]
        best = int(np.argmax(np.array(keys, dtype=object)))
        want = np.nanargmin(vals) if lowest else np.nanargmax(vals)
        assert twindow.pick_index(keys[best]) == best == want
        # a key as the int64 slot hands it back
        signed = keys[best] - (1 << 64) if keys[best] >= 1 << 63 else keys[best]
        assert twindow.pick_index(signed) == want
        assert twindow.pick_reference(torch.from_numpy(vals), lowest)[0] == want


def test_window_sum_rejects_what_the_kernel_does_not_take():
    ent = torch.rand(10, 12)
    with pytest.raises(ValueError, match="does not fit"):
        twindow.window_sum(ent, 11)
    with pytest.raises(ValueError, match="float32"):
        twindow.window_sum(ent.double(), 3)
    with pytest.raises(ValueError, match="on the card"):
        twindow.window_sum(ent, 3, pick=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        tkernel.local_entropy_rgb(torch.zeros(4, 5, 4, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8 nor float32"):
        tkernel.local_entropy_rgb(torch.zeros(4, 5, 3, dtype=torch.float64))


def test_patch_positions_from_uint8_equal_those_from_float():
    for seed in range(3):
        u8 = _rgb_u8(200 + seed, (48, 72))
        f32 = u8.astype(np.float32) / 255.0
        for patches in (1, 3):
            assert tentropy.entropy_patch_positions(u8, 12, patches, device="cpu") == \
                tentropy.entropy_patch_positions(f32, 12, patches, device="cpu")


@pytest.mark.parametrize("colorspace", ["rgb", "ycbcr"])
def test_crop_then_convert_equals_convert_then_crop(colorspace):
    ds = SuperResImages(lr_dir=".", colorspace=colorspace, device="cpu")
    img = _rgb_u8(7, (40, 56))
    whole = ds._colorspace_convert(img)
    for top, left, size in ((0, 0, 12), (5, 9, 20), (28, 44, 12)):
        crop = ds._colorspace_convert(img[top:top + size, left:left + size])
        np.testing.assert_array_equal(crop, whole[top:top + size, left:left + size])
        assert crop.dtype == np.float32


def test_item_laps_time_every_part_only_while_asked(tmp_path):
    """SuperResImages.__getitem__'s laps: with part_ms set, the host ms of
    decode, select, convert and crop + augment of the items read, single-
    and multi-crop; unset, nothing is kept and the item is the same."""
    hr = _rgb_u8(11, (96, 128))
    for d in ("lr", "hr"):
        (tmp_path / d).mkdir()
    np.save(tmp_path / "hr" / "a.npy", hr)
    np.save(tmp_path / "lr" / "a.npy", np.ascontiguousarray(hr[::4, ::4]))
    for crop_count in (1, 3):
        items = []
        for timing in (False, True):
            ds = SuperResImages(lr_dir=str(tmp_path / "lr"), hr_dir=str(tmp_path / "hr"),
                                scale=4, crop=8, crop_count=crop_count, patch_type="entropy",
                                augmentations=True, device="cpu")
            if timing:
                ds.part_ms = {}
            items.append(ds[0])
            if timing:
                assert set(ds.part_ms) == {"decode", "select", "convert", "crop_augment"}
                assert all(v >= 0.0 for v in ds.part_ms.values())
            else:
                assert ds.part_ms is None
        for k in ("lr", "hr"):
            np.testing.assert_array_equal(items[0][k], items[1][k])
