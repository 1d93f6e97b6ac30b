"""The port's image metrics (rumpy_tpu_torch/utils/metrics.py) against the
JAX package's (rumpy_tpu/utils/metrics.py) on the CPU, on the same images
made from a seed with numpy: PSNR within 1e-5 dB, SSIM within 1e-6."""

import jax
import numpy as np
import pytest
import torch

from rumpy_tpu.utils import metrics as jm
from rumpy_tpu_torch.utils import metrics as tm

PSNR_TOL = 1e-5  # dB
SSIM_TOL = 1e-6
SIDES = [(11, 11), (12, 12), (57, 86), (70, 70), (128, 128)]


def _pair(shape, seed, max_value=1.0):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    noise = 0.05 * rng.standard_normal(shape).astype(np.float32)
    b = np.clip(a + noise, 0.0, 1.0).astype(np.float32)
    return a * np.float32(max_value), b * np.float32(max_value)


def _layouts(hw):
    h, w = hw
    return {"hw": (h, w), "hwc": (h, w, 3), "nhwc": (2, h, w, 3)}


@pytest.mark.parametrize("layout", ["hw", "hwc", "nhwc"])
@pytest.mark.parametrize("hw", SIDES, ids=[f"{h}x{w}" for h, w in SIDES])
def test_psnr_and_ssim_match_jax(hw, layout):
    shape = _layouts(hw)[layout]
    a, b = _pair(shape, seed=hw[0] * 1000 + hw[1])
    got_p = float(tm.psnr(a, b, 1.0))
    want_p = float(jm.psnr(a, b, 1.0))
    assert abs(got_p - want_p) <= PSNR_TOL, (got_p, want_p)
    got_s = tm.ssim(a, b, 1.0).numpy()
    want_s = np.asarray(jm.ssim(a, b, 1.0))
    assert got_s.shape == want_s.shape
    assert np.abs(got_s - want_s).max() <= SSIM_TOL, (got_s, want_s)
    if layout == "nhwc":  # per image, as Metrics runs them
        got = tm.psnr_batch(a, b, 1.0).numpy()
        want = np.asarray(jax.vmap(lambda x, y: jm.psnr(x, y, 1.0))(a, b))
        assert np.abs(got - want).max() <= PSNR_TOL


@pytest.mark.parametrize("max_value", [255.0, 2.0])
@pytest.mark.parametrize("hw", [(57, 86), (70, 70)], ids=["57x86", "70x70"])
def test_data_range_other_than_one(hw, max_value):
    a, b = _pair((2, *hw, 3), seed=7, max_value=max_value)
    got = tm.Metrics(["PSNR", "SSIM"]).run_metrics(a, b, max_value=max_value)
    want = jm.Metrics(["PSNR", "SSIM"]).run_metrics(a, b, max_value=max_value)
    assert list(got) == list(want) == ["PSNR", "SSIM"]
    assert np.abs(np.subtract(got["PSNR"], want["PSNR"])).max() <= PSNR_TOL
    assert np.abs(np.subtract(got["SSIM"], want["SSIM"])).max() <= SSIM_TOL


@pytest.mark.parametrize("shape", [(12, 12), (11, 12, 3), (2, 70, 70, 1)])
def test_equal_images(shape):
    a, _ = _pair(shape, seed=3)
    assert float(tm.psnr(a, a.copy(), 1.0)) == float(jm.psnr(a, a.copy(), 1.0)) == 100.0
    assert np.allclose(tm.ssim(a, a.copy()).numpy(), 1.0, atol=SSIM_TOL)
    assert np.abs(tm.ssim(a, a.copy()).numpy() - np.asarray(jm.ssim(a, a.copy()))).max() <= SSIM_TOL


@pytest.mark.parametrize("side", [1, 2, 3, 5, 11])
@pytest.mark.parametrize("pad", [0, 1, 5, 7, 23])
def test_symmetric_pad_is_numpys(side, pad):
    """Symmetric padding by index, a pad longer than the side included."""
    x = np.arange(side * 4, dtype=np.float32).reshape(4, side)
    got = tm.symmetric_pad(torch.from_numpy(x), pad, dim=-1).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (pad, pad)), mode="symmetric"))


def test_metrics_hub_keys_prefix_and_delimeter():
    a, b = _pair((3, 57, 86, 1), seed=11)
    got = tm.Metrics(["SSIM", "PSNR"], delimeter="/").run_metrics(
        a, b, max_value=1.0, key_prefix="val")
    want = jm.Metrics(["SSIM", "PSNR"], delimeter="/").run_metrics(
        a, b, max_value=1.0, key_prefix="val")
    assert list(got) == list(want) == ["val/SSIM", "val/PSNR"]
    assert all(isinstance(v, float) for v in got["val/PSNR"])
    assert np.abs(np.subtract(got["val/PSNR"], want["val/PSNR"])).max() <= PSNR_TOL
    assert np.abs(np.subtract(got["val/SSIM"], want["val/SSIM"])).max() <= SSIM_TOL


def test_face_psnr_with_boundary_csv(tmp_path):
    rows = ["name,top,left,height,width",
            "f0.png,4,6,20,30",       # a box
            "f1.png,-1,0,10,10",      # negative: dropped
            "f2.png,,3,10,10",        # missing value: dropped
            "f3.jpg,10,12,8.0,9"]     # found by stem; float text
    (tmp_path / "face_boundaries_0.csv").write_text("\n".join(rows) + "\n")
    a, b = _pair((4, 40, 50, 1), seed=5)
    names = ["f0", "f1", "f2", "f3"]
    got = tm.Metrics(["face_PSNR", "true_face_PSNR", "PSNR"],
                     hr_data_loc=str(tmp_path)).run_metrics(a, b, probe_names=names)
    want = jm.Metrics(["face_PSNR", "true_face_PSNR", "PSNR"],
                      hr_data_loc=str(tmp_path)).run_metrics(a, b, probe_names=names)
    assert tm.load_boundary_data(str(tmp_path)) == jm.load_boundary_data(str(tmp_path))
    assert list(got) == list(want)
    for k in want:
        assert np.abs(np.subtract(got[k], want[k])).max() <= PSNR_TOL, k
    # the box changes the score; no box scores the whole image
    assert got["true_face_PSNR"][0] != got["PSNR"][0]
    assert abs(got["true_face_PSNR"][1] - got["PSNR"][1]) <= PSNR_TOL


@pytest.mark.parametrize("metric,item", [("LPIPS", "weights")])
def test_metrics_of_later_slices_raise(metric, item):
    """LPIPS raises without its weights, as in the JAX package (FR_rank,
    ported since, is held in tests/test_torch_face_tools.py)."""
    with pytest.raises(NotImplementedError, match=item):
        tm.Metrics(["PSNR", metric])
    with pytest.raises(KeyError):
        tm.Metrics(["PSNR", "bogus"])


def test_compute_stays_on_the_device_and_fetch_copies_once():
    """compute() returns tensors; fetch() turns a batch's metrics into
    lists of floats in the order of the keys."""
    a, b = _pair((2, 24, 24, 1), seed=9)
    hub = tm.Metrics(["PSNR", "SSIM"])
    vals = hub.compute(torch.from_numpy(a), torch.from_numpy(b))
    assert all(torch.is_tensor(v) and v.shape == (2,) for v in vals.values())
    assert tm.fetch(vals) == {k: v.tolist() for k, v in vals.items()}
    assert tm.fetch({}) == {}
