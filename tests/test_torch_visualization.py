"""The port's figures on the CPU against the JAX package's: the three
functions of ``utils/visualization.py`` (``interpret_sisr_images``,
``compare_training_curves``, ``crop_zoom_figure``), ``EvalHub``'s
comparison collages and ``ContrastiveEval.scatter_plot``.

Each side runs with matplotlib's ``Axes`` (and the figure's colorbar and
savefig) recorded: what each hands matplotlib (panel arrays, titles, the
crop rectangle, curves, scatter points, figure sizes) is held against the
JAX side's, and each file is written. Panels of float images are uint8 and
equal bit for bit, except those that pass a float32 colour conversion or a
model in one package and float64 or torch in the other (YCbCr panels, the
collage's SR and bicubic panels): within 1 level. The collage's PSNR
captions agree within 0.01 dB. t-SNE is a deterministic stand-in in both
packages (``sklearn.manifold.TSNE`` replaced), which records its
perplexity. A missing matplotlib or scikit-learn raises an ImportError that
names it.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from rumpy_tpu.evaluation.contrastive_eval import ContrastiveEval as JaxContrastiveEval
from rumpy_tpu.evaluation.eval_hub import EvalHub as JaxEvalHub
from rumpy_tpu.utils import visualization as jvis
from rumpy_tpu_torch.evaluation.contrastive_eval import ContrastiveEval
from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
from rumpy_tpu_torch.utils import visualization as tvis
from test_torch_gui import eval_pairs, jax_experiment
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

RECORDED = ("imshow", "set_title", "axis", "add_patch", "plot", "scatter", "set_xlabel",
            "set_ylabel", "grid", "legend")


class Recorder:
    """Every call of the recorded ``Axes`` methods, ``Figure.colorbar`` and
    ``Figure.savefig`` (the figure's size and the file's name), in order."""

    def __init__(self, monkeypatch):
        from matplotlib.axes import Axes
        from matplotlib.figure import Figure
        self.calls = []
        for cls, names in ((Axes, RECORDED), (Figure, ("colorbar",))):
            for name in names:
                monkeypatch.setattr(cls, name, self._wrap(name, getattr(cls, name)))
        real_save = Figure.savefig

        def savefig(fig, path, *a, **k):
            self.calls.append(("savefig", (tuple(fig.get_size_inches()),
                                           os.path.basename(str(path))), {}))
            return real_save(fig, path, *a, **k)
        monkeypatch.setattr(Figure, "savefig", savefig)

    def _wrap(self, name, real):
        def method(obj, *a, **k):
            self.calls.append((name, a, k))
            return real(obj, *a, **k)
        return method

    def take(self):
        out, self.calls = self.calls, []
        return out


def _norm(v):
    """A call's argument in a comparable form: arrays (numpy, torch, pandas)
    as numpy arrays, a Rectangle by its geometry and colours, a scatter's
    collection by its points, values and colour map, an Axes by its
    type."""
    from matplotlib.axes import Axes
    from matplotlib.collections import Collection
    from matplotlib.patches import Rectangle
    if isinstance(v, Axes):
        return "Axes"
    if isinstance(v, Collection):
        return ("Collection", _norm(np.asarray(v.get_offsets()).tolist()),
                _norm(np.asarray(v.get_array()).tolist()), v.get_cmap().name)
    if isinstance(v, Rectangle):
        return ("Rectangle", v.get_xy(), v.get_width(), v.get_height(), v.get_edgecolor(),
                v.get_facecolor(), v.get_linewidth())
    if torch.is_tensor(v):
        return v.numpy()
    if hasattr(v, "to_numpy") or isinstance(v, (np.ndarray, range)):
        return np.asarray(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


def assert_same_calls(got, want, levels=0, panel_levels=None):
    """The two recordings call the same methods with equal arguments;
    arrays equal (uint8 panels within ``levels``, or ``panel_levels(i)``
    for the i-th imshow)."""
    assert [c[0] for c in got] == [c[0] for c in want]
    shown = 0
    for (name, ga, gk), (_, wa, wk) in zip(got, want):
        assert sorted(gk) == sorted(wk), name
        tol = levels
        if name == "imshow":
            tol = levels if panel_levels is None else panel_levels(shown)
            shown += 1
        for g, w in zip(list(ga) + [gk[k] for k in sorted(gk)],
                        list(wa) + [wk[k] for k in sorted(wk)]):
            g, w = _norm(g), _norm(w)
            if isinstance(w, np.ndarray):
                g = np.asarray(g)
                assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype, w.dtype)
                diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
                assert diff.max(initial=0) <= tol, (name, diff.max())
            else:
                assert g == w, (name, g, w)


def _images(seed, n, shape=(16, 20, 3)):
    rng = np.random.default_rng(seed)
    return {f"model_{i}": rng.random(shape).astype(np.float32) for i in range(n)}


@pytest.mark.parametrize("n", [1, 4])
def test_interpret_sisr_images_matches_jax(monkeypatch, tmp_path, n):
    """A collage of n panels (3 a row, the rest of the grid off), captions
    for some: the port, given tensors, hands matplotlib JAX's panels,
    titles and figure size."""
    images = _images(n, n)
    captions = {"model_0": "PSNR 27.50"}
    rec = Recorder(monkeypatch)
    jvis.interpret_sisr_images(images, str(tmp_path / "j.pdf"), captions=captions)
    want = rec.take()
    out = tvis.interpret_sisr_images({k: torch.from_numpy(v) for k, v in images.items()},
                                     str(tmp_path / "t.pdf"), captions=captions)
    got = rec.take()
    assert_same_calls(got[:-1], want[:-1])
    assert got[-1][1][0] == want[-1][1][0]  # the figure's size
    assert sum(c[0] == "imshow" for c in got) == n
    assert out == str(tmp_path / "t.pdf") and os.path.getsize(out) > 0


@pytest.mark.parametrize("colorspace,levels", [("rgb", 0), ("ycbcr", 1)])
def test_crop_zoom_figure_matches_jax(monkeypatch, tmp_path, colorspace, levels):
    """Two images with a crop box outlined and zoomed below: panels (YCbCr
    converted in float32 by JAX, in torch by the port: within 1 level),
    rectangles, titles."""
    images = _images(7, 2)
    box = (3, 4, 6, 8)
    rec = Recorder(monkeypatch)
    jvis.crop_zoom_figure(images, box, str(tmp_path / "j.pdf"), colorspace=colorspace)
    want = rec.take()
    out = tvis.crop_zoom_figure(images, box, str(tmp_path / "t.pdf"), colorspace=colorspace)
    got = rec.take()
    assert_same_calls(got[:-1], want[:-1], levels=levels)
    assert [c[0] for c in got].count("add_patch") == 2
    assert os.path.getsize(out) > 0


def test_compare_training_curves_matches_jax(monkeypatch, tmp_path):
    """One metric of several summary.csv files against their rows; an
    experiment without the file or without the column adds no curve."""
    dirs = {}
    for name, cols in (("a", ("epoch", "val-PSNR", "train-loss")),
                       ("b", ("epoch", "val-PSNR")), ("c", ("epoch", "train-loss"))):
        d = tmp_path / name / "result_outputs"
        os.makedirs(d)
        with open(d / "summary.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for e in range(4 if name == "a" else 3):
                w.writerow([e] + [round(20 + e * 0.37 + len(c) * 0.01, 4) for c in cols[1:]])
        dirs[name] = str(d)
    dirs["absent"] = str(tmp_path / "absent")
    rec = Recorder(monkeypatch)
    jvis.compare_training_curves(dirs, str(tmp_path / "j.pdf"))
    want = rec.take()
    out = tvis.compare_training_curves(dirs, str(tmp_path / "t.pdf"))
    got = rec.take()
    assert_same_calls(got[:-1], want[:-1])
    assert [c[2].get("label") for c in got if c[0] == "plot"] == ["a", "b"]
    assert os.path.getsize(out) > 0


class FakeTSNE:
    """A deterministic stand-in for scikit-learn's t-SNE: the first two
    columns, doubled; records its perplexity."""
    perplexities = []

    def __init__(self, n_components, perplexity):
        assert n_components == 2
        FakeTSNE.perplexities.append(perplexity)

    def fit_transform(self, x):
        return np.asarray(x, np.float64)[:, :2] * 2.0


@pytest.mark.parametrize("n,method", [(4, "tsne"), (7, "tsne"), (12, "umap"), (100, "tsne")])
def test_scatter_plot_matches_jax(monkeypatch, tmp_path, n, method):
    """Fewer than 5 embeddings give None; otherwise the t-SNE map (UMAP
    falls back to it where ``umap`` is absent) at perplexity min(30, max(2,
    N // 3)): the same points, colours, colour bar and title."""
    import sklearn.manifold
    monkeypatch.setattr(sklearn.manifold, "TSNE", FakeTSNE)
    monkeypatch.setitem(sys.modules, "umap", None)
    FakeTSNE.perplexities = []
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    rec = Recorder(monkeypatch)
    want_path = JaxContrastiveEval.scatter_plot(emb, labels, str(tmp_path / "j.pdf"), method)
    want = rec.take()
    got_path = ContrastiveEval.scatter_plot(torch.from_numpy(emb), torch.from_numpy(labels),
                                            str(tmp_path / "t.pdf"), method)
    got = rec.take()
    if n < 5:
        assert want_path is None and got_path is None and got == want == []
        return
    assert FakeTSNE.perplexities == [min(30, max(2, n // 3))] * 2
    assert_same_calls(got[:-1], want[:-1])
    assert got[-1][1][0] == want[-1][1][0]
    assert ("set_title", ("tsne embedding map",), {}) in got
    assert os.path.getsize(got_path) > 0


def test_scatter_plot_refuses_an_unknown_method_as_jax(tmp_path):
    emb = np.zeros((6, 3), np.float32)
    with pytest.raises(ValueError) as want:
        JaxContrastiveEval.scatter_plot(emb, np.zeros(6), str(tmp_path / "j.pdf"), "pca")
    with pytest.raises(ValueError) as got:
        ContrastiveEval.scatter_plot(emb, np.zeros(6), str(tmp_path / "t.pdf"), "pca")
    assert str(got.value) == str(want.value)


def test_eval_hub_collages_match_jax(monkeypatch, tmp_path):
    """``gallery`` in both EvalHubs on the same JAX-written experiment: per
    image a ``<stem>_comparison.pdf`` of HR, bicubic and the model, each
    titled with its name and PSNR (within 0.01 dB), the HR panel bit for
    bit, the bicubic and SR panels within 1 level; the metrics as well."""
    lr_dir, hr_dir = eval_pairs(tmp_path / "pairs")
    model_loc = jax_experiment(tmp_path / "Results")
    kw = dict(models=[{"experiment": "exp", "epoch": "last"}], model_loc=model_loc,
              data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir}, scale=2, gallery=True)
    rec = Recorder(monkeypatch)
    JaxEvalHub(out_loc=str(tmp_path / "jax"), **kw).full_image_protocol()
    want = rec.take()
    EvalHub(out_loc=str(tmp_path / "port"), device="cpu", **kw).full_image_protocol()
    got = rec.take()
    for rec_ in (want, got):  # the captions' PSNR values, compared apart
        for i, (name, a, k) in enumerate(rec_):
            if name == "set_title" and "\n" in a[0]:
                title, cap = a[0].split("\n")
                rec_[i] = (name, (title,), dict(k, psnr=float(cap.split()[1])))
    psnr = [(g[2].pop("psnr"), w[2].pop("psnr")) for g, w in zip(got, want)
            if g[0] == "set_title" and "psnr" in w[2]]
    assert len(psnr) == 2 * len(os.listdir(lr_dir))
    assert all(abs(g - w) <= 0.01 for g, w in psnr), psnr
    assert_same_calls(got, want, panel_levels=lambda i: 0 if i % 3 == 0 else 1)
    for stem in ("im0", "im1"):
        assert os.path.getsize(tmp_path / "port" / f"{stem}_comparison.pdf") > 0
    assert not os.path.exists(tmp_path / "port2")
    EvalHub(out_loc=str(tmp_path / "port2"), device="cpu", no_image_comparison=True,
            **kw).full_image_protocol()
    assert not [f for f in os.listdir(tmp_path / "port2") if f.endswith(".pdf")]


def test_missing_libraries_raise_naming_them(monkeypatch, tmp_path):
    """Without matplotlib each figure raises an ImportError that names it,
    ``EvalHub(gallery=True)`` before it loads a model (the experiment does
    not exist); without scikit-learn the t-SNE map names it."""
    import matplotlib
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    calls = [lambda: tvis.interpret_sisr_images(_images(0, 1), str(tmp_path / "a.pdf")),
             lambda: tvis.compare_training_curves({}, str(tmp_path / "b.pdf")),
             lambda: tvis.crop_zoom_figure(_images(0, 1), (0, 0, 2, 2), str(tmp_path / "c.pdf")),
             lambda: ContrastiveEval.scatter_plot(np.zeros((6, 2)), np.zeros(6),
                                                  str(tmp_path / "d.pdf")),
             lambda: EvalHub(models=[{"experiment": "absent"}], model_loc=str(tmp_path),
                             data_cfg={}, out_loc=str(tmp_path / "o"), gallery=True,
                             device="cpu")]
    for call in calls:
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    monkeypatch.setitem(sys.modules, "matplotlib", matplotlib)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        ContrastiveEval.scatter_plot(np.zeros((6, 2)), np.zeros(6), str(tmp_path / "e.pdf"))
