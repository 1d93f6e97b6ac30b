"""The face slice's data layer in the port, on the CPU, against the JAX
package's: CelebA attributes (amplified, aliased, all of them) read
without pandas; blacklist and patch-location CSV files; loss masks (a
smaller one centred in a zero field, a missing one); ``VideoSequenceImages``
(the bundle, the centre tag and an index, ``use_masks``, and coherent
bundles under concurrent fetches); ``CelebaSplitSampler`` (its order, the
offsets of a concatenation, the ``ValueError``) alone and through
``sisr_data_setup``; and the mask fault: through either package's trainer,
all-zero and all-one masks give the same first-step loss, since neither
trainer hands the step the batch's mask. The same files and seeds go
through both packages, and everything compared is held equal (arrays bit
for bit; each package's two first-step losses exactly).
"""

import concurrent.futures as cf
import os

import numpy as np
import pytest
from PIL import Image

from rumpy_tpu.data import datasets as jdata
from rumpy_tpu.data import loader as jloader
from rumpy_tpu.data import metadata as jmeta
from rumpy_tpu_torch.data import datasets as tdata
from rumpy_tpu_torch.data import loader as tloader
from rumpy_tpu_torch.data import metadata as tmeta
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

CELEBA = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs Big_Lips "
          "Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows Chubby Double_Chin "
          "Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open "
          "Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose Receding_Hairline "
          "Rosy_Cheeks Sideburns Smiling Straight_Hair Wavy_Hair Wearing_Earrings Wearing_Hat "
          "Wearing_Lipstick Wearing_Necklace Wearing_Necktie Young").split()
SCALE = 2


def _write_attrs(path, stems, rng):
    rows = "".join(f"{s}.jpg  " + " ".join(f"{v:2d}" for v in rng.choice([-1, 1], 40)) + "\n"
                   for s in stems)
    path.write_text(f"{len(stems)}\n" + " ".join(CELEBA) + " \n" + rows)


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """Eight CelebA-named LR/HR pairs (000001.png ...), their attribute
    table, and a frame folder of 6 frames with a uvtex mask."""
    root = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for d in ("lr", "hr", "frames_lr", "frames_hr"):
        os.makedirs(root / d)
    stems = [f"{i:06d}" for i in range(1, 9)]
    for s in stems:
        hr = (rng.random((24 * SCALE, 20 * SCALE, 3)) * 255).astype(np.uint8)
        Image.fromarray(hr).save(root / "hr" / f"{s}.png")
        Image.fromarray(hr[::SCALE, ::SCALE].copy()).save(root / "lr" / f"{s}.png")
    for i in range(6):
        hr = (rng.random((16 * SCALE, 18 * SCALE, 3)) * 255).astype(np.uint8)
        Image.fromarray(hr).save(root / "frames_hr" / f"f{i:03d}.png")
        Image.fromarray(hr[::SCALE, ::SCALE].copy()).save(root / "frames_lr" / f"f{i:03d}.png")
    Image.fromarray((rng.random((14 * SCALE, 18 * SCALE, 3)) > 0.4).astype(np.uint8) * 255
                    ).save(root / "frames_hr" / "uvtex_mask.png")
    _write_attrs(root / "attrs.txt", stems, rng)
    return {k: str(root / k) for k in ("lr", "hr", "frames_lr", "frames_hr", "attrs.txt")}


# -- attributes --------------------------------------------------------------------

@pytest.mark.parametrize("selected,amplify", [
    ("all", None), (["gender", "age", "Smiling"], None), (["Smiling", "gender"], True),
    ("all", True)])
def test_celeba_attributes_match_jax(faces, selected, amplify):
    """The table read by the stdlib as pandas reads it: -1 to 0 (or -2/2
    amplified), Male and Young answering to gender and age, the columns in
    the selection's order, prepended to each image's vector, looked up by
    its CelebA stem."""
    images = {"000002_q3.png": np.asarray([0.5, 0.25], np.float32),
              "000007.png": np.asarray([1.0, 0.0], np.float32),
              "000001.png": np.asarray([0.0, 0.75], np.float32)}
    want, wkeys = jmeta.read_celeba_attributes(faces["attrs.txt"], dict(images), selected,
                                               amplify)
    got, gkeys = tmeta.read_celeba_attributes(faces["attrs.txt"], dict(images), selected,
                                              amplify)
    assert gkeys == wkeys and len(gkeys) == (40 if selected == "all" else len(selected))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_attributes_through_the_dataset_match_jax(faces):
    """``attributes_loc`` alone: each item's vector is its attributes, the
    keys ``celeba-<name>``."""
    kw = dict(lr_dir=faces["lr"], hr_dir=faces["hr"], scale=SCALE,
              attributes_loc=faces["attrs.txt"], data_attributes=["gender", "Smiling"])
    jds = jdata.SuperResImages(**kw)
    tds = tdata.SuperResImages(device="cpu", **kw)
    assert tds.metadata_keys == jds.metadata_keys == ["celeba-gender", "celeba-smiling"]
    for i in range(len(jds)):
        np.testing.assert_array_equal(tds[i]["metadata"], jds[i]["metadata"])


# -- masks -------------------------------------------------------------------------

@pytest.mark.parametrize("mask_shape", [(30, 34), (56, 48)])
def test_masks_match_jax(faces, tmp_path, mask_shape):
    """A mask smaller than the aligned HR target comes back centred in a
    zero field, a larger one centre-cropped; cropped and augmented with
    the HR image."""
    rng = np.random.default_rng(1)
    for n in os.listdir(faces["hr"]):
        Image.fromarray((rng.random(mask_shape + (3,)) > 0.5).astype(np.uint8) * 255
                        ).save(tmp_path / n)
    kw = dict(lr_dir=faces["lr"], hr_dir=faces["hr"], scale=SCALE, mask_data=str(tmp_path),
              crop=10, augmentations=True, seed=4)
    jds, tds = jdata.SuperResImages(**kw), tdata.SuperResImages(device="cpu", **kw)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        for k in ("lr", "hr", "mask"):
            np.testing.assert_array_equal(b[k], a[k])
    whole = tdata.SuperResImages(device="cpu", **dict(kw, crop=None, augmentations=False))
    m = whole[0]["mask"]
    assert m.shape == (24 * SCALE, 20 * SCALE, 3)
    if mask_shape[0] < m.shape[0]:
        assert not m[:(m.shape[0] - mask_shape[0]) // 2].any()


def test_a_missing_mask_raises_in_both(faces, tmp_path):
    kw = dict(lr_dir=faces["lr"], hr_dir=faces["hr"], scale=SCALE, mask_data=str(tmp_path))
    for ds in (jdata.SuperResImages(**kw), tdata.SuperResImages(device="cpu", **kw)):
        with pytest.raises(FileNotFoundError, match="mask"):
            ds[0]


# -- VideoSequenceImages -----------------------------------------------------------

@pytest.mark.parametrize("hr_selection,use_masks", [("center", False), (0, True),
                                                    ("center", True)])
def test_video_sequence_images_match_jax(faces, hr_selection, use_masks):
    """Windows of 3 frames on the channel axis, the target frame's tag, HR
    and mask (uvtex_mask.png, listed among the frames' HR images as in the
    JAX layout), one crop and augmentation draw a window."""
    kw = dict(lr_dir=faces["frames_lr"], hr_dir=faces["frames_hr"], scale=SCALE,
              num_frames=3, hr_selection=hr_selection, use_masks=use_masks, crop=6,
              augmentations=True, seed=2)
    jds = jdata.VideoSequenceImages(**kw)
    tds = tdata.VideoSequenceImages(device="cpu", **kw)
    assert len(tds) == len(jds) == 4
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert set(a) == set(b) and b["lr"].shape == (6, 6, 9)
        assert b["tag"] == a["tag"] == f"f{i + (1 if hr_selection == 'center' else 0):03d}.png"
        for k in ("lr", "hr", "mask"):
            if k in a:
                np.testing.assert_array_equal(b[k], a[k])
        assert ("mask" in b) == use_masks


def test_video_bundles_stay_coherent_under_threads(tmp_path):
    """Every frame of a window shares one crop and augmentation draw while
    other threads fetch other windows: channel 0 (the position) is the
    same plane in every frame of a bundle."""
    yy, xx = np.mgrid[0:40, 0:40]
    pos = ((yy * 40 + xx) % 251).astype(np.uint8)
    for i in range(8):
        np.save(tmp_path / f"f{i}.npy", np.stack([pos, np.full_like(pos, i * 30), pos], -1))
    ds = tdata.VideoSequenceImages(lr_dir=str(tmp_path), scale=2, crop=8, augmentations=True,
                                   num_frames=3, seed=0, device="cpu")

    def check(idx):
        bundle = ds[idx]["lr"]
        return all(np.array_equal(bundle[..., 0], bundle[..., 3 * f]) for f in (1, 2))

    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        assert all(pool.map(check, list(range(len(ds))) * 8))


# -- CelebaSplitSampler ------------------------------------------------------------

class _FakeSet:
    metadata_keys = ["5-celeba-gender", "5-celeba-smiling"]

    def __init__(self, meta):
        self.metadata = meta

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, i):
        return {"idx": np.asarray([i], np.int64)}


def test_celeba_split_sampler_matches_jax():
    """Positives (shuffled), then negatives (shuffled), every epoch; a
    concatenation's second set offset by the first's length; the same
    order as the JAX sampler from the same seed; ``ValueError`` unless
    exactly one key holds the attribute."""
    a = _FakeSet([[1, 0], [0, 1], [1, 1], [0, 0], [1, 0]])
    b = _FakeSet([[0, 0], [1, 0]])
    for src in (a, None):
        jsrc = a if src is not None else jloader.ConcatDataset([a, b])
        tsrc = a if src is not None else tloader.ConcatDataset([a, b])
        js = jloader.CelebaSplitSampler(jsrc, selected_attribute="gender", seed=3)
        ts = tloader.CelebaSplitSampler(tsrc, selected_attribute="gender", seed=3)
        for _ in range(2):  # two epochs
            order = list(iter(ts))
            assert order == list(iter(js))
        npos = len(ts.positive_indices)
        assert set(order[:npos]) == ({0, 2, 4} if src is not None else {0, 2, 4, 6})
        assert len(ts) == len(order)
    for attr in ("bogus", "celeba"):
        with pytest.raises(ValueError):
            tloader.CelebaSplitSampler(a, selected_attribute=attr)
        with pytest.raises(ValueError):
            jloader.CelebaSplitSampler(a, selected_attribute=attr)


def test_sampler_through_the_data_setup_matches_jax(faces):
    """``sampler_attributes`` with per-set attributes: the batches of both
    packages' loaders (order, crops, metadata) are the same, a batch holds
    one allocation until the positives run out; an unknown sampler name
    raises in both."""
    cfg = {"training_sets": {"d": {"lr_dir": faces["lr"], "hr_dir": faces["hr"],
                                   "attributes_loc": faces["attrs.txt"],
                                   "data_attributes": ["gender"]}}}
    kw = dict(scale=SCALE, batch_size=2, dataloader_threads=1, crop=6, seed=7,
              metadata=["gender"],
              sampler_attributes={"name": "celebasplitsampler", "selected_attribute": "gender"})
    jtrain, _ = jloader.sisr_data_setup(cfg, **kw)
    ttrain, _ = tloader.sisr_data_setup(cfg, device="cpu", **kw)
    assert isinstance(ttrain.sampler, tloader.CelebaSplitSampler) and not ttrain.shuffle
    jb, tb = list(jtrain), list(ttrain)
    assert len(tb) == len(jb) == 4
    for a, b in zip(jb, tb):
        assert list(a["tag"]) == list(b["tag"])
        for k in ("lr", "hr", "metadata"):
            np.testing.assert_array_equal(b[k], a[k])
    gates = np.concatenate([b["metadata"][:, 0] for b in tb])
    npos = int(gates.sum())
    assert (gates[:npos] == 1).all() and (gates[npos:] == 0).all()
    bad = dict(kw, sampler_attributes={"name": "other"})
    with pytest.raises(RuntimeError, match="not recognized"):
        tloader.sisr_data_setup(cfg, device="cpu", **bad)
    with pytest.raises(RuntimeError, match="not recognized"):
        jloader.sisr_data_setup(cfg, **bad)


# -- the mask fault ----------------------------------------------------------------

def _masked_config(faces, out, frames_hr):
    return {"experiment": "msk", "experiment_save_loc": str(out), "no_directories": True,
            "model": {"name": "rcan", "internal_params": {
                "scale": SCALE, "n_feats": 8, "n_resgroups": 1, "n_resblocks": 1,
                "reduction": 4, "in_features": 6}},
            "data": {"scale": SCALE, "multi_frame_config": {"num_frames": 2, "use_masks": True},
                     "training_sets": {"d": {"lr_dir": faces["frames_lr"], "hr_dir": frames_hr,
                                             "crop": 6}},
                     "batch_size": 4, "dataloader_threads": 1},
            "training": {"num_epochs": 1, "seed": 0, "metrics": ["PSNR"]}}


def test_neither_trainer_hands_the_step_its_mask(faces, tmp_path):
    """``use_masks`` turns on the model's loss masking in both trainers,
    yet the train loop hands the step lr, hr, metadata and tags only: an
    all-zero mask gives the first step the loss an all-one mask gives, in
    both packages (were the mask applied, the zero mask's loss would be
    0)."""
    import shutil

    from rumpy_tpu.training.trainer import TrainingHandler as JTrainer
    from rumpy_tpu_torch.training.trainer import TrainingHandler as TTrainer
    losses = {}
    for fill in (0, 255):
        frames_hr = tmp_path / f"hr_{fill}"
        shutil.copytree(faces["frames_hr"], frames_hr)
        Image.fromarray(np.full((16 * SCALE, 18 * SCALE, 3), fill, np.uint8)).save(
            frames_hr / "uvtex_mask.png")
        cfg = _masked_config(faces, tmp_path / f"out_{fill}", str(frames_hr))
        jt = JTrainer(cfg, use_mesh=False, verbose=False)
        tt = TTrainer(cfg, verbose=False, device="cpu")
        assert jt.model.model.loss_masking and tt.model.model.loss_masking
        assert "mask" in next(iter(tt.train_data)) and "mask" in next(iter(jt.train_data))
        losses[fill] = (jt.train(0)["train-loss"], tt.train(0)["train-loss"])
    for k in (0, 1):  # each package against itself: their random inits differ
        assert losses[0][k] == losses[255][k] > 0
