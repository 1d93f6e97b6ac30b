"""The port's data layer (rumpy_tpu_torch.data) against the JAX package's:
the same files and seed give the same crops, tags, augment draws and batch
order. The JAX dataset's entropy map comes from the Pallas kernel in
interpret mode (as it would on a TPU); the port's from the kernel's plain
version, on the CPU."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from rumpy_tpu.data import datasets as jdata
from rumpy_tpu.data import loader as jloader
from rumpy_tpu.ops import entropy as jentropy
from rumpy_tpu.ops.pallas.entropy_kernel import local_entropy_pallas
from rumpy_tpu_torch.data import datasets as tdata
from rumpy_tpu_torch.data import loader as tloader

SCALE = 2


def _pallas_best(gray, region=10, levels=64):
    return local_entropy_pallas(
        jnp.clip(jnp.round(gray), 0, 255).astype(jnp.uint8),
        region=region, levels=levels, interpret=True)


def _image(rng, h, w, k):
    yy, xx = np.mgrid[:h, :w]
    amp = 70.0 * (0.5 + 0.5 * np.sin(xx / 9.0 + k)) * (0.5 + 0.5 * np.cos(yy / 7.0 + k))
    img = 128 + amp[..., None] * rng.standard_normal((h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Six LR/HR pairs (HR two pixels larger than LR * scale, so the
    centre-crop alignment runs), as PNG files and again as .npy files."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    dirs = {k: root / k for k in ("png_lr", "png_hr", "npy_lr", "npy_hr")}
    for d in dirs.values():
        os.makedirs(d)
    for k in range(6):
        hr = _image(rng, 40 * SCALE + 2, 56 * SCALE + 2, k)
        lr = hr[1:-1:SCALE, 1:-1:SCALE].copy()
        Image.fromarray(lr).save(dirs["png_lr"] / f"im{k}.png")
        Image.fromarray(hr).save(dirs["png_hr"] / f"im{k}.png")
        np.save(dirs["npy_lr"] / f"im{k}.npy", lr)
        np.save(dirs["npy_hr"] / f"im{k}.npy", hr)
    return {k: str(v) for k, v in dirs.items()}


def _both(pairs, files="png", **kw):
    jds = jdata.SuperResImages(lr_dir=pairs["png_lr"], hr_dir=pairs["png_hr"],
                               scale=SCALE, **kw)
    tds = tdata.SuperResImages(lr_dir=pairs[f"{files}_lr"], hr_dir=pairs[f"{files}_hr"],
                               scale=SCALE, device="cpu", **kw)
    return jds, tds


def _assert_items_equal(a, b, stem_only=False):
    assert set(a) == set(b)
    for k in ("lr", "hr"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
    ta, tb = a["tag"], b["tag"]
    if stem_only:
        ta, tb = os.path.splitext(ta)[0], os.path.splitext(tb)[0]
    assert ta == tb
    assert a["metadata"].size == b["metadata"].size == 0
    assert list(a["metadata_keys"]) == list(b["metadata_keys"]) == []


@pytest.mark.parametrize("files", ["png", "npy"])
@pytest.mark.parametrize("patch_type", ["random", "predefined", "entropy"])
def test_crops_tags_and_augment_draws_match_jax(monkeypatch, pairs, patch_type, files):
    monkeypatch.setattr(jentropy, "local_entropy_best", _pallas_best)
    kw = dict(crop=12, patch_type=patch_type, augmentations=True, seed=5)
    if patch_type == "predefined":
        kw["predefined_patch_locations"] = [(0, 0), (5, 9), (28, 44)]
    jds, tds = _both(pairs, files, **kw)
    assert len(jds) == len(tds) == 6
    for idx in (3, 0, 5, 3):  # the shared generator advances item by item
        a, b = jds[idx], tds[idx]
        assert b["lr"].shape == (12, 12, 3) and b["hr"].shape == (24, 24, 3)
        _assert_items_equal(a, b, stem_only=files == "npy")


def test_entropy_corner_is_the_highest_entropy_patch(pairs):
    from rumpy_tpu_torch.ops.entropy import pooled_entropy
    tds = tdata.SuperResImages(lr_dir=pairs["npy_lr"], hr_dir=pairs["npy_hr"],
                               scale=SCALE, crop=12, patch_type="entropy",
                               device="cpu")
    item = tds[2]
    lr = np.load(os.path.join(pairs["npy_lr"], "im2.npy")).astype(np.float32) / 255.0
    pooled = pooled_entropy(lr, 12, device="cpu").numpy()
    top, left = np.unravel_index(np.argmax(pooled), pooled.shape)
    np.testing.assert_array_equal(item["lr"], lr[top:top + 12, left:left + 12])


def test_multi_crop_ycbcr_and_full_images_match_jax(monkeypatch, pairs):
    monkeypatch.setattr(jentropy, "local_entropy_best", _pallas_best)
    jds, tds = _both(pairs, crop=10, crop_count=3, patch_type="entropy",
                     augmentations=True, seed=1)
    for idx in (1, 4):
        a, b = jds[idx], tds[idx]
        assert b["lr"].shape == (3, 10, 10, 3) and b["hr"].shape == (20, 20, 3)
        _assert_items_equal(a, b)
    jds, tds = _both(pairs, colorspace="ycbcr", crop=10, seed=2)
    a, b = jds[0], tds[0]
    assert b["lr"].shape == (10, 10, 1)
    np.testing.assert_allclose(b["lr"], a["lr"], atol=1e-6)
    np.testing.assert_allclose(b["hr"], a["hr"], atol=1e-6)
    jds, tds = _both(pairs)
    a, b = jds[4], tds[4]
    assert b["lr"].shape == (40, 56, 3) and b["hr"].shape == (80, 112, 3)
    _assert_items_equal(a, b)


def test_listing_options_match_jax(pairs, tmp_path):
    shortlist = tmp_path / "keep.txt"
    shortlist.write_text("im4.png\n\nim1.png\n")
    for kw in (dict(custom_split=(1, 4)), dict(image_shortlist=str(shortlist)),
               dict(blacklist=["im0.png", "im3.png"]),
               dict(dataset="div2k", split="train")):
        jds, tds = _both(pairs, **kw)
        assert [os.path.basename(f) for f in tds.lr_files] == \
            [os.path.basename(f) for f in jds.lr_files]
        assert 0 < len(tds) <= 6
    # `_qN` group tags
    qdir = tmp_path / "q"
    os.makedirs(qdir)
    for name in ("a_q1.png", "a_q2.png", "b_q1.png", "c.png"):
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(qdir / name)
    jq = jdata.SuperResImages(lr_dir=str(qdir), group_select=[1])
    tq = tdata.SuperResImages(lr_dir=str(qdir), group_select=[1], device="cpu")
    assert [os.path.basename(f) for f in tq.lr_files] == \
        [os.path.basename(f) for f in jq.lr_files] == ["a_q1.png", "b_q1.png"]
    # the HR partner of a tagged file drops the tag
    assert tq._hr_path(str(qdir / "a_q1.png")) is None
    tq.hr_dir = pairs["png_hr"]
    assert tq._hr_path("x/im2_q7.png") == os.path.join(pairs["png_hr"], "im2.png")


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batch_order_and_shapes_match_jax(pairs, shuffle):
    kw = dict(crop=8, augmentations=True, seed=3)
    jds, tds = _both(pairs, **kw)
    lkw = dict(batch_size=4, shuffle=shuffle, drop_last=False, num_workers=1, seed=9)
    jdl, tdl = jloader.DataLoader(jds, **lkw), tloader.DataLoader(tds, **lkw)
    assert len(jdl) == len(tdl) == 2
    for epoch in range(2):  # the shuffle generator carries over epochs
        jb, tb = list(jdl), list(tdl)
        assert [b["lr"].shape for b in tb] == [(4, 8, 8, 3), (2, 8, 8, 3)]
        for a, b in zip(jb, tb):
            assert a["tag"] == b["tag"]
            np.testing.assert_array_equal(a["lr"], b["lr"])
            np.testing.assert_array_equal(a["hr"], b["hr"])
    assert len(tloader.DataLoader(tds, batch_size=4, drop_last=True)) == 1


def test_data_setup_matches_jax(pairs):
    cfg = {"training_sets": {
        "data_2": {"lr": pairs["png_lr"], "hr": pairs["png_hr"], "cutoff": 3},
        "data_1": {"lr_dir": pairs["png_lr"], "hr_dir": pairs["png_hr"],
                   "random_crop": 6, "patch_selection_type": "random"}}}
    kw = dict(scale=SCALE, batch_size=4, dataloader_threads=1, crop=8,
              augmentations=True, seed=11)
    jtrain, jeval = jloader.sisr_data_setup(cfg, **kw)
    ttrain, teval = tloader.sisr_data_setup(cfg, device="cpu", **kw)
    assert jeval is None and teval is None
    assert ttrain.drop_last and ttrain.shuffle  # training defaults
    assert len(ttrain) == len(jtrain) == 2  # 9 items, the ragged batch dropped
    assert len(ttrain.dataset) == 9
    for a, b in zip(jtrain, ttrain):
        assert a["tag"] == b["tag"]
        for k in ("lr", "hr"):  # data_1 crops 6, data_2 crops 8: lists
            assert len(a[k]) == len(b[k]) == 4
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
    ttrain, _ = tloader.sisr_data_setup(dict(cfg, drop_last_training_batch=False),
                                        device="cpu", **kw)
    assert len(ttrain) == 3


CELEBA_NAMES = [f"Attr_{i}" for i in range(38)] + ["Male", "Young"]


@pytest.fixture(scope="module")
def face_files(pairs, tmp_path_factory):
    """Beside the pairs: a CelebA-format attribute table for their stems, a
    blacklist CSV, a patch-location CSV (tuple and plain-name indexes),
    masks named as the HR images (one smaller than its target), a
    ``uvtex_mask.png`` next to the HR images (in a copy of the HR folder)
    and a degradation-metadata CSV."""
    root = tmp_path_factory.mktemp("face_files")
    rng = np.random.default_rng(5)
    names = sorted(os.listdir(pairs["png_lr"]))
    rows = "".join(f"{os.path.splitext(n)[0]}.jpg " + " ".join(
        str(v) for v in rng.choice([-1, 1], len(CELEBA_NAMES))) + "\n" for n in names)
    (root / "attrs.txt").write_text(f"{len(names)}\n" + " ".join(CELEBA_NAMES) + "\n" + rows)
    (root / "blacklist.csv").write_text("Images,reason\n" + f"{names[1]},blur\n{names[4]},x\n")
    (root / "patches.csv").write_text(
        ",high_entropy_patches_left_corner\n"
        f"\"('{names[0]}', 0)\",\"[(3, 5), (10, 2)]\"\n{names[2]},\"[(20, 30)]\"\n")
    masks = root / "masks"
    hr_copy = root / "hr"
    shutil.copytree(pairs["png_hr"], hr_copy)
    os.makedirs(masks)
    for k, n in enumerate(names):
        shape = (60, 90) if k == 3 else (40 * SCALE + 2, 56 * SCALE + 2)
        m = (rng.random(shape + (3,)) > 0.3).astype(np.uint8) * 255
        Image.fromarray(m).save(masks / n)
    Image.fromarray((rng.random((40 * SCALE, 56 * SCALE, 3)) > 0.5).astype(np.uint8) * 255
                    ).save(hr_copy / "uvtex_mask.png")
    lr = root / "lr"
    shutil.copytree(pairs["png_lr"], lr)
    (lr / "degradation_metadata.csv").write_text("image,QPI,0-blur-sigma\n" + "".join(
        f"{n},{20 + 3 * i},{0.5 * i}\n" for i, n in enumerate(names)))
    return {"attrs.csv": str(root / "attrs.txt"), "blacklist.csv": str(root / "blacklist.csv"),
            "patches.csv": str(root / "patches.csv"), "masks": str(masks),
            "hr_with_uvtex": str(hr_copy), "lr_with_csv": str(lr)}


@pytest.mark.parametrize("kw", [
    dict(online_degradations=True, mask_data="masks"),
    dict(input="interp", attributes_loc="attrs.csv"),
    dict(use_random_colour_distort=True, blacklist="blacklist.csv"),
    dict(metadata_file="degradation_metadata.csv", attributes_loc="attrs.csv"),
    dict(attributes_loc="attrs.csv"), dict(blacklist="blacklist.csv"),
    dict(predefined_patch_location="patches.csv"), dict(mask_data="masks"),
    dict(custom_mask_name="uvtex_mask.png")])
def test_options_of_the_face_slice_match_jax(pairs, face_files, kw):
    """The options the face slice ported (they raised until then), each on
    crops of 8 with augmentations (colour distortion stays off: its draws
    differ by design), give the same items in both packages: listing,
    crops, augment draws, masks, metadata vectors and keys."""
    kw = {k: face_files.get(v, v) if isinstance(v, str) else v for k, v in kw.items()}
    lr_dir, hr_dir = pairs["png_lr"], pairs["png_hr"]
    if "metadata_file" in kw:
        lr_dir = face_files["lr_with_csv"]
        kw["metadata_file"] = "on_site"
    if "custom_mask_name" in kw:
        hr_dir = face_files["hr_with_uvtex"]
    kw = dict(dict(crop=8, augmentations="use_random_colour_distort" not in kw, seed=3), **kw)
    jds = jdata.SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=SCALE, **kw)
    tds = tdata.SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=SCALE, device="cpu", **kw)
    assert len(jds) == len(tds) == (4 if "blacklist" in kw else 6)
    assert list(jds.metadata_keys) == list(tds.metadata_keys)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert set(a) == set(b) and a["tag"] == b["tag"]
        assert ("mask" in b) == (("mask_data" in kw or "custom_mask_name" in kw)
                                 and not kw.get("online_degradations"))
        for k in ("lr", "hr", "mask", "metadata"):
            if k in a:
                assert np.asarray(a[k]).dtype == b[k].dtype
                np.testing.assert_array_equal(np.asarray(a[k]), b[k])
        assert list(a["metadata_keys"]) == list(b["metadata_keys"])


def test_on_site_metadata_resolves_to_the_lr_folders_csv(pairs, tmp_path):
    """``metadata_file = "on_site"`` means <lr_dir>/degradation_metadata.csv,
    as in the JAX package: without one the set carries no metadata; with
    one every item carries its image's row and the set the CSV's keys."""
    ds = tdata.SuperResImages(lr_dir=pairs["png_lr"], hr_dir=pairs["png_hr"],
                              metadata_file="on_site", device="cpu")
    assert len(ds) > 0 and ds[0]["metadata"].size == 0
    lr = tmp_path / "lr"
    shutil.copytree(pairs["png_lr"], lr)
    names = sorted(os.path.basename(f) for f in tdata.list_images(str(lr)))
    rows = "".join(f"{n},{20 + 2 * i},{i}\n" for i, n in enumerate(names))
    (lr / "degradation_metadata.csv").write_text("image,QPI,0-blur-sigma\n" + rows)
    ds = tdata.SuperResImages(lr_dir=str(lr), hr_dir=pairs["png_hr"],
                              metadata_file="on_site", device="cpu")
    assert ds.metadata_keys == ["qpi", "0-blur-sigma"]
    last = len(names) - 1
    for i in (0, last):
        item = ds[i]
        assert item["metadata_keys"] == ["qpi", "0-blur-sigma"]
        # QPI pinned to (20, 40), the other column by its min and max
        np.testing.assert_allclose(item["metadata"], [(2 * i) / 20, i / last], rtol=1e-6)


def test_entropy_positions_once_per_item(pairs, monkeypatch):
    """An item's entropy positions are computed once and shared by its
    crops; the same index read again (in the next epoch) computes them
    again, so every item is one pass of the entropy path."""
    from rumpy_tpu_torch.ops import entropy as tentropy
    real, calls = tentropy.entropy_patch_positions, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tentropy, "entropy_patch_positions", counted)
    for crop_count, want in ((1, 2), (3, 2)):
        calls.clear()
        ds = tdata.SuperResImages(lr_dir=pairs["png_lr"], hr_dir=pairs["png_hr"], crop=8,
                                  patch_type="entropy", crop_count=crop_count, device="cpu")
        ds[0]
        ds[0]
        assert len(calls) == want


def test_video_sampler_and_bad_files_raise(pairs, tmp_path):
    """A set with neither folder, and a .npy file that is no uint8 RGB
    image, raise."""
    with pytest.raises(ValueError, match="lr_dir or hr_dir"):
        tdata.SuperResImages(device="cpu")
    np.save(tmp_path / "grey.npy", np.zeros((4, 4), np.uint8))
    ds = tdata.SuperResImages(lr_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        ds[0]


def test_decode_cache_follows_the_file(tmp_path):
    """The cache is keyed by path and modification time: a rewritten file
    is read again."""
    path = tmp_path / "a.npy"
    np.save(path, np.full((4, 4, 3), 7, np.uint8))
    ds = tdata.SuperResImages(lr_dir=str(tmp_path), device="cpu")
    assert ds[0]["lr"][0, 0, 0] == np.float32(7 / 255)
    np.save(path, np.full((4, 4, 3), 9, np.uint8))
    os.utime(path, ns=(1, 1))
    assert ds[0]["lr"][0, 0, 0] == np.float32(9 / 255)
