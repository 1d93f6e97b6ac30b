"""The port's face tools (rumpy_tpu_torch.utils.face_segmentation,
face_tools, face_recognition, cli/face_cli.py and FR_rank in Metrics and
EvalHub) against the JAX package's, on the CPU, at seeded weights.

Tolerances: BiSeNet's three heads within 1e-4 x max|logit| on a 64 x 64
input (float32 convolutions summed in different orders); the segmenter's
class maps at 512 agree on >= 99.9 % of pixels; the rank, CMC and ROC math
at equal features: ranks equal, CMC, AUC and EER within 1e-9; LightCNN
features within 1e-4 x max|feature|, and the ranks they give equal; the
fr_metrics CSV files have the same rows and columns, values within 1e-6."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from rumpy_tpu.cli.face_cli import face_segment as jax_face_segment
from rumpy_tpu.cli.face_cli import find_faces as jax_find_faces
from rumpy_tpu.evaluation.eval_hub import EvalHub as JaxEvalHub
from rumpy_tpu.models.feature_extractors import perceptual_loss_mechanism as jax_extractor
from rumpy_tpu.utils import face_recognition as jfr
from rumpy_tpu.utils import face_segmentation as jseg
from rumpy_tpu.utils import face_tools as jtools
from rumpy_tpu.utils.metrics import Metrics as JaxMetrics
from rumpy_tpu_torch.cli import face_cli
from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
from rumpy_tpu_torch.models.feature_extractors import LightCNNFeatures, perceptual_loss_mechanism
from rumpy_tpu_torch.utils import face_recognition as tfr
from rumpy_tpu_torch.utils import face_segmentation as tseg
from rumpy_tpu_torch.utils import face_tools as ttools
from rumpy_tpu_torch.utils.metrics import Metrics

SCALE = 4


def bisenet_npz(path, seed):
    """Seeded BiSeNet weights in the flax-layout npz both packages read:
    He-scaled conv kernels, BatchNorm scales in [0.5, 1.5], small biases and
    means, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, t in tseg.BiSeNet().state_dict().items():
        *path_, last = name.split(".")
        base = "/".join(path_)
        if last == "num_batches_tracked":
            continue
        if last == "weight" and t.dim() == 4:
            o, i, kh, kw = t.shape
            flat[f"params/{base}/kernel"] = (rng.standard_normal((kh, kw, i, o))
                                             * np.sqrt(2.0 / (kh * kw * i))).astype(np.float32)
        elif last == "weight":
            flat[f"params/{base}/scale"] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        elif last == "bias":
            flat[f"params/{base}/bias"] = (0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        elif last == "running_mean":
            flat[f"batch_stats/{base}/mean"] = (0.1 * rng.standard_normal(t.shape)).astype(
                np.float32)
        else:
            flat[f"batch_stats/{base}/var"] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
    np.savez(path, **flat)
    return str(path)


def lightcnn_npz(path, seed, cin=3):
    """Seeded LightCNN weights (``Conv_<i>/kernel`` HWIO, small biases)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (f, k, _) in enumerate(LightCNNFeatures.SPEC):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, cin, 2 * f))
                                   * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        out[f"Conv_{i}/bias"] = (0.01 * rng.standard_normal(2 * f)).astype(np.float32)
        cin = f
    np.savez(path, **out)
    return str(path)


def _face(h, w, seed):
    yy, xx = np.mgrid[:h, :w]
    base = 120 + 80 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (0.1 * h * w))
    noise = 25 * np.random.default_rng(seed).standard_normal((h, w, 3))
    return np.clip(base[..., None] + noise + 10 * seed, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("face_weights")
    return bisenet_npz(root / "bisenet.npz", 3), lightcnn_npz(root / "lightcnn.npz", 4)


@pytest.fixture(scope="module")
def jax_segmenter(weights):
    """One JAX segmenter for the module: its 512 x 512 program compiles once."""
    return jseg.BiSeNetSegmenter(weights[0])


# ---------------------------------------------------------------------------
# BiSeNet
# ---------------------------------------------------------------------------

def test_bisenet_heads_match_jax(weights):
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jseg.load_bisenet_npz(weights[0])
    want = jax.jit(jseg.BiSeNet().apply)(variables, jnp.asarray(x))
    module = tseg.BiSeNet().load_variables(tseg.load_bisenet_npz(weights[0])).eval()
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 64, 64, 19)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (8, 8)), ((5, 7), (16, 9)), ((8, 8), (8, 8))])
def test_resizes_match_jax(in_hw, out_hw):
    x = np.random.default_rng(2).standard_normal((1, *in_hw, 3)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    want_near, want_bil = jax.jit(lambda v: (jseg._nearest_resize(v, out_hw),
                                             jseg._bilinear_ac_resize(v, out_hw)))(x)
    near = tseg._nearest_resize(t, out_hw).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(near, np.asarray(want_near))
    bil = tseg._bilinear_ac_resize(t, out_hw).permute(0, 2, 3, 1).numpy()
    assert np.abs(bil - np.asarray(want_bil)).max() <= 1e-5


def test_torch_checkpoint_conversion_matches_jax(tmp_path):
    """A reference-layout state dict through both converters: the same
    flax tree, and the port's module loads it."""
    module = tseg.BiSeNet()
    torch.manual_seed(0)
    sd = {k: (torch.randn_like(v) if v.is_floating_point() else v)
          for k, v in module.state_dict().items()}
    ref = {k.replace("layer1_0", "layer1.0").replace("downsample_1", "downsample.1")
           .replace("downsample_0", "downsample.0"): v for k, v in sd.items()}
    got = tseg.convert_torch_bisenet(ref, out_npz=str(tmp_path / "port.npz"))
    want = jseg.convert_torch_bisenet({k: v.numpy() for k, v in ref.items()},
                                      out_npz=str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    tseg.BiSeNet().load_variables(got)
    assert set(got) == set(want) == {"params", "batch_stats"}


def test_segmenter_class_maps_match_jax(weights, jax_segmenter):
    """parse() at 512 (Pillow's bilinear, ImageNet statistics, argmax of
    the main head) on a float input, which both cut to uint8 (the CLI test
    holds a uint8 one)."""
    img = _face(100, 80, 1).astype(np.float32) / 255.0
    got = ttools.BiSeNetSegmenter(weights[0], device="cpu").parse(img)
    want = jax_segmenter.parse(img)
    assert got.shape == want.shape == (512, 512) and got.dtype == np.int32
    assert (got == want).mean() >= 0.999
    assert np.array_equal(tseg.colorize_parsing(got), jseg.colorize_parsing(got))


def test_segmenter_gates_on_weights_and_cuda(monkeypatch, weights):
    with pytest.raises(NotImplementedError, match="BiSeNet checkpoint"):
        tseg.BiSeNetSegmenter(None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseg.BiSeNetSegmenter(weights[0])


def test_face_segment_cli_matches_jax(monkeypatch, tmp_path, weights, jax_segmenter):
    """The port's CLI and the JAX package's on a PNG face (the map resized
    back, and the superimposed blend); the port's also on the same face as
    a .npy array, which the JAX CLI does not read."""
    src = tmp_path / "faces"
    os.makedirs(src)
    face = _face(218, 178, 0)
    Image.fromarray(face).save(src / "f0.png")
    np.save(src / "f1.npy", face)
    monkeypatch.setattr(jseg, "BiSeNetSegmenter", lambda path: jax_segmenter)
    r = CliRunner().invoke(jax_face_segment, ["-i", str(src), "-o", str(tmp_path / "jax"),
                                              "--weights", weights[0],
                                              "--save_superimposed_images"])
    assert r.exit_code == 0, r.output + repr(r.exception)
    n = face_cli.face_segment(["-i", str(src), "-o", str(tmp_path / "port"), "--weights",
                               weights[0], "--save_superimposed_images", "--device", "cpu"])
    assert n == 2
    assert sorted(os.listdir(tmp_path / "jax")) == ["f0.png", "f0_superimposed.png"]
    assert sorted(os.listdir(tmp_path / "port")) == [
        "f0.png", "f0_superimposed.png", "f1.npy", "f1_superimposed.npy"]
    for name in os.listdir(tmp_path / "jax"):
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == want.shape == (218, 178, 3)
        assert (got == want).all(-1).mean() >= 0.999, name
        assert np.array_equal(np.load(tmp_path / "port" / name.replace("f0", "f1").replace(
            ".png", ".npy")), got)


@pytest.mark.parametrize("cli", ["find_faces", "face_segment"])
def test_face_clis_give_the_gating_message_without_weights(tmp_path, capsys, cli):
    jax_cmd = {"find_faces": jax_find_faces, "face_segment": jax_face_segment}[cli]
    r = CliRunner().invoke(jax_cmd, ["-i", str(tmp_path), "-o", str(tmp_path / "o")])
    assert r.exit_code == 1
    with pytest.raises(SystemExit) as e:
        getattr(face_cli, cli)(["-i", str(tmp_path), "-o", str(tmp_path / "o")]
                               + (["--device", "cpu"] if cli == "face_segment" else []))
    message = str(e.value.code)
    assert message.startswith("Error: ") and message[len("Error: "):] in r.output


def test_blend_is_pils():
    a, b = _face(20, 30, 1), _face(20, 30, 2)
    want = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), 0.5))
    assert np.array_equal(face_cli._blend(a, b), want)


# ---------------------------------------------------------------------------
# Face tools: alignment and cropping
# ---------------------------------------------------------------------------

def test_aligner_matches_jax():
    img = _face(90, 80, 3)
    lm = [(28.5, 35.0), (52.0, 33.5)]
    got = ttools.FaceAligner((64, 64)).align(img, lm)
    assert np.array_equal(got, jtools.FaceAligner((64, 64)).align(img, lm))
    assert got.shape == (64, 64, 3)


class _Boxes:
    def detect(self, image_bgr):
        return [(5, 6, 20, 24), (40, 2, 10, 10)]


def test_crop_faces_matches_jax():
    img = _face(60, 70, 4)
    got, want = ttools.crop_faces(img, _Boxes(), 0.3), jtools.crop_faces(img, _Boxes(), 0.3)
    assert len(got) == len(want) == 2
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(NotImplementedError, match="darknet"):
        ttools.YoloFaceDetector()


# ---------------------------------------------------------------------------
# Face recognition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["l2", "euclidean", "l1", "cosine"])
def test_distances_match_jax(method):
    rng = np.random.default_rng(5)
    v, u = rng.standard_normal((6, 9)), rng.standard_normal((5, 9))
    assert np.abs(tfr.distance_feats(v, u, method) - jfr.distance_feats(v, u, method)).max() \
        <= 1e-12


@pytest.mark.parametrize("tie_mode", ["optimistic", "pessimistic", "average"])
@pytest.mark.parametrize("mode", ["dist", "sim"])
def test_cumulative_match_matches_jax_with_ties(tie_mode, mode):
    """Scores rounded to one decimal, so that ties are common."""
    rng = np.random.default_rng(6)
    m = np.round(rng.random((8, 6)), 1)
    probes = [f"id{i % 6}" for i in range(8)]
    gallery = [f"id{i}" for i in range(6)]
    got = tfr.cumulative_match(m, probes, gallery, mode=mode, tie_mode=tie_mode)
    want = jfr.cumulative_match(m, probes, gallery, mode=mode, tie_mode=tie_mode)
    assert got[0] == want[0] and np.array_equal(got[2], want[2])
    assert np.abs(np.subtract(got[1], want[1])).max() <= 1e-9


@pytest.mark.parametrize("score_mode", ["dist", "sim"])
def test_roc_matches_jax(score_mode):
    rng = np.random.default_rng(7)
    d = rng.random((6, 6))
    got = tfr.roc_main(d, score_mode=score_mode)
    want = jfr.roc_main(d, score_mode=score_mode)
    assert abs(got[0] - want[0]) <= 1e-9 and abs(got[1] - want[1]) <= 1e-9
    for g, w in zip(got[2:], want[2:]):
        assert np.abs(g - w).max() <= 1e-9


def _gallery_images(n=5, side=32):
    return np.stack([_face(side, side, i) for i in range(n)]).astype(np.float32) / 255.0


def test_recognizer_with_lightcnn_matches_jax(weights):
    """LightCNN features at seeded weights, the gallery, the ranks of
    perturbed probes and the full CMC/ROC package."""
    gallery = _gallery_images()
    ids = [f"p{i}" for i in range(5)]
    probes = np.clip(gallery + 0.08 * np.random.default_rng(8).standard_normal(gallery.shape),
                     0, 1).astype(np.float32)
    jrec = jfr.FaceRecognizer(jax.jit(jax_extractor("lightcnn", weights=weights[1])))
    trec = tfr.FaceRecognizer(perceptual_loss_mechanism("lightcnn", weights=weights[1],
                                                        device="cpu"))
    jrec.register_gallery(images=gallery, gallery_ids=ids)
    trec.register_gallery(images=gallery, gallery_ids=ids)
    assert np.abs(trec.gallery - jrec.gallery).max() <= 1e-4 * np.abs(jrec.gallery).max()
    order = [3, 1, 4, 0, 2]
    pids = [ids[i] for i in order]
    assert np.array_equal(trec.fr_rank(probes=probes[order], probe_ids=pids),
                          jrec.fr_rank(probes=probes[order], probe_ids=pids))
    feats = jrec._extract(probes)
    got = trec.full_package(features=feats, probe_ids=ids)
    want = jrec.full_package(features=feats, probe_ids=ids)
    assert np.array_equal(got["ranks"], want["ranks"]) and got["CMC_x"] == want["CMC_x"]
    for k in ("CMC_y", "FPR", "TPR"):
        assert np.abs(np.subtract(got[k], want[k])).max() <= 1e-9
    assert abs(got["AUC"] - want["AUC"]) <= 1e-9 and abs(got["EER"] - want["EER"]) <= 1e-9


def test_recognizer_needs_an_extractor_for_images():
    rec = tfr.FaceRecognizer()
    with pytest.raises(RuntimeError, match="extractor"):
        rec.register_gallery(images=_gallery_images(2))
    with pytest.raises(RuntimeError, match="No gallery"):
        rec.fr_rank(features=np.zeros((1, 4)), probe_ids=["a"])


def test_metrics_fr_rank_matches_jax(weights):
    """Metrics' FR_rank column scores the RGB images given beside the
    Y-channel pair, as in the JAX package; it needs a recognizer."""
    gallery = _gallery_images()
    ids = [f"p{i}" for i in range(5)]
    jrec = jfr.FaceRecognizer(jax.jit(jax_extractor("lightcnn", weights=weights[1])))
    trec = tfr.FaceRecognizer(perceptual_loss_mechanism("lightcnn", weights=weights[1],
                                                        device="cpu"))
    feats = jrec._extract(gallery)
    jrec.register_gallery(features=feats, gallery_ids=ids)
    trec.register_gallery(features=feats, gallery_ids=ids)
    rgb = gallery[[2, 0, 4, 1, 3]]  # the gallery's batch shape: JAX's eager ops compiled once
    y = rgb.mean(-1, keepdims=True)
    names = ["p2", "p1", "p4", "p1", "p3"]
    got = Metrics(["PSNR", "FR_rank"], face_recognizer=trec).run_metrics(
        y, y, probe_names=names, rgb_a=rgb, rgb_ref=rgb)
    want = JaxMetrics(["PSNR", "FR_rank"], face_recognizer=jrec).run_metrics(
        y, y, probe_names=names, rgb_a=rgb, rgb_ref=rgb)
    assert list(got) == list(want) and got["FR_rank"] == want["FR_rank"]
    with pytest.raises(KeyError, match="face_recognizer"):
        Metrics(["FR_rank"])
    with pytest.raises(ValueError, match="probe ID"):
        Metrics(["FR_rank"], face_recognizer=trec).run_metrics(y, y)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def face_pairs(tmp_path_factory, weights):
    """Three 16 x 16 LR faces and their 64 x 64 HR, and a features npz
    gallery of the HR faces (LightCNN at the seeded weights) with two
    identities of its own."""
    root = tmp_path_factory.mktemp("fr_pairs")
    lr_dir, hr_dir = root / "lr", root / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    hrs = []
    for k in range(3):
        hr = _face(16 * SCALE, 16 * SCALE, k)
        Image.fromarray(hr).save(hr_dir / f"face{k}.png")
        Image.fromarray(hr).resize((16, 16), Image.BICUBIC).save(lr_dir / f"face{k}.png")
        hrs.append(hr.astype(np.float32) / 255.0)
    extra = [_face(16 * SCALE, 16 * SCALE, 9 + k).astype(np.float32) / 255.0 for k in range(2)]
    feats = np.asarray(jax.jit(jax_extractor("lightcnn", weights=weights[1]))(
        np.stack(hrs + extra)))
    np.savez(root / "gallery.npz", out_stack=feats,
             id_stack=np.array([f"face{k}" for k in range(3)] + ["other0", "other1"]))
    return str(lr_dir), str(hr_dir), str(root / "gallery.npz")


@pytest.mark.parametrize("gallery_kind", ["features_npz", "image_folder"])
def test_eval_hub_fr_rank_matches_jax(monkeypatch, tmp_path, weights, face_pairs, gallery_kind):
    """EvalHub with FR_rank (the bicubic reference as the probes): the
    per-image FR_rank columns, the three fr_metrics CSV files and the
    curves handed to plot_cmc (which is not drawn: matplotlib's PDF text
    layout takes seconds). The JAX side's extractor runs jitted (one
    compile, not one an op)."""
    import rumpy_tpu.models.feature_extractors as jfe
    lr_dir, hr_dir, npz = face_pairs
    eager = jfe.perceptual_loss_mechanism
    monkeypatch.setattr(jfe, "perceptual_loss_mechanism",
                        lambda *a, **k: jax.jit(eager(*a, **k)))
    plotted = {}
    for side, module in (("jax", jfr), ("port", tfr)):
        monkeypatch.setattr(module, "plot_cmc",
                            lambda data, save_loc, side=side: plotted.update({side: data}))
    if gallery_kind == "features_npz":
        gallery = npz
    else:
        gallery = str(tmp_path / "gallery")
        os.makedirs(gallery)
        for k in range(2):
            Image.open(os.path.join(hr_dir, f"face{k}.png")).save(
                os.path.join(gallery, f"face{k}.png"))
        Image.fromarray(_face(48, 48, 12)).save(os.path.join(gallery, "face2.png"))
    kw = dict(models=[], model_loc=str(tmp_path), scale=SCALE,
              data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir},
              metrics=["PSNR", "FR_rank"], fr_gallery=gallery, fr_extractor="lightcnn",
              fr_extractor_weights=weights[1])
    JaxEvalHub(out_loc=str(tmp_path / "jax"), **kw).full_image_protocol()
    table = EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kw).full_image_protocol()
    assert ("bicubic", "FR_rank") in table.columns
    want = _read_csv(tmp_path / "jax" / "individual_metrics.csv")
    got = _read_csv(tmp_path / "port" / "individual_metrics.csv")
    assert got[:3] == want[:3] and [r[0] for r in got] == [r[0] for r in want]
    for g, w, metric in zip(got[3][1:], want[3][1:], want[1][1:]):
        if metric == "FR_rank":
            assert float(g) == float(w)
    for name in ("cmc_fr_metrics.csv", "extra_fr_metrics.csv", "individual_im_ranks.csv"):
        got = _read_csv(tmp_path / "port" / "fr_metrics" / name)
        want = _read_csv(tmp_path / "jax" / "fr_metrics" / name)
        assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want], name
        assert np.abs(np.asarray(got[1:])[:, 1:].astype(float)
                      - np.asarray(want[1:])[:, 1:].astype(float)).max() <= 1e-6, name
    assert list(plotted["port"]) == list(plotted["jax"]) == ["bicubic"]
    assert plotted["port"]["bicubic"][0] == plotted["jax"]["bicubic"][0]
    assert np.abs(np.subtract(plotted["port"]["bicubic"][1],
                              plotted["jax"]["bicubic"][1])).max() <= 1e-9


def test_eval_hub_fr_rank_needs_a_gallery(tmp_path, face_pairs, weights):
    lr_dir, hr_dir, _ = face_pairs
    with pytest.raises(KeyError, match="fr_gallery"):
        EvalHub(models=[], model_loc=str(tmp_path), out_loc=str(tmp_path), scale=SCALE,
                data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir}, metrics=["FR_rank"],
                fr_extractor_weights=weights[1], device="cpu")


def test_a_checkpoint_written_on_the_card_loads_on_the_cpu(tmp_path, capsys):
    """A checkpoint carries its generator's state, 16 bytes for a CUDA
    generator: a CPU handler loads the weights and keeps its seed, and says
    so (the CPU run of eval_sisr on a model the card trained)."""
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.utils import checkpoint as ckpt
    handler = get_model("srcnn")(device="cpu", seed=3)
    state = handler.init_state()
    path = handler.save_model(state, str(tmp_path), 0)
    payload = ckpt.load_checkpoint(path)
    payload["rng"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA generator's state
    ckpt.save_checkpoint(path, payload)
    other = get_model("srcnn")(device="cpu", seed=3)
    seeded = other.rng.get_state()
    _, epoch = other.load_model(str(tmp_path), epoch=0)
    assert epoch == 0 and torch.equal(other.rng.get_state(), seeded)
    assert "the cpu generator keeps its seed" in capsys.readouterr().out
    assert all(torch.equal(a, b) for a, b in zip(other.module.state_dict().values(),
                                                 handler.module.state_dict().values()))
