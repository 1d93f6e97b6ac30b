"""DIC in the port, on the CPU, against the JAX package
(``rumpy_tpu/models/dic.py`` and the two layers it takes from
``face_attribute_gans.py``): ``PRelu``, ``TorchConvTranspose``,
``render_heatmaps``, ``merge_heatmap_5`` and ``upsample_bilinear_align``;
every step's SR image and heatmaps at x4 and x8 (num_features 8, num_groups
2, hg_num_feature 16, 68 keypoints, 1 fusion block, 2 steps) with the
weight bridge both ways bit for bit against the tree of ``jax.eval_shape``
of the flax init; two SGD steps of the handler with landmarks looked up
from a pickle by tag, the first with the hourglass gated, the second
released; the handler's surface (``dicnet``'s aliases, the refusals, the
default schedule); and the landmark lookup that ignores the crop corner in
both packages (ROADMAP.md section 3).

Weights come from the port's seeded init, jittered off their init values
and carried to flax by the bridge (JAX's jitted init of the unrolled
recurrence is the slow part here); inputs from a numpy seed. Tolerances:
float32 forwards within 2e-5 of the largest entry; heatmaps rendered within
1e-6; a step under SGD at lr 1 (a parameter moves by its gradient) within
1e-4 of each leaf's largest move plus two float32 ulps, losses within 1e-5
of their value.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import dic as jdic
from rumpy_tpu.models import face_attribute_gans as jfag
from rumpy_tpu.models.base import TrainState
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import dic as tdic
from rumpy_tpu_torch.models import face_attribute_gans as tfag
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, F32_GRAD_REL, HEAT_ATOL = 2e-5, 1e-4, 1e-6
PARAM_ULPS = 2.0 ** -22
SMALL = dict(num_steps=2, num_features=8, num_groups=2, hg_num_feature=16, hg_num_keypoints=68,
             num_fusion_block=1)
SGD = dict(optimizer_type="sgd", lr=1.0)


def _close(got, want, rel=F32_REL):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _seeded(module, seed):
    """``module`` at its seeded init, every leaf then jittered (a zero bias
    or a 0.2 slope would hide a mislaid leaf)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return module


@functools.lru_cache(maxsize=None)
def _net(scale):
    """(port DIC, its flax params, the flax module), the params' tree
    checked against the flax init's by ``jax.eval_shape``."""
    tm = _seeded(tdic.DIC(scale=scale, **SMALL), scale)
    params = jax_tree_from_state_dict(tm.state_dict(), tm)
    jm = jdic.DIC(scale=scale, **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    assert [s.shape for s in jax.tree_util.tree_leaves(shapes)] == \
        [p.shape for p in jax.tree_util.tree_leaves(params)]
    return tm, params, jm


# -- layers -----------------------------------------------------------------------------

@pytest.mark.parametrize("num", [1, 4])
def test_prelu_matches_jax(num):
    x = np.random.default_rng(1).standard_normal((2, 5, 6, num)).astype(np.float32)
    jm = jfag.PRelu(num=num, init=0.2)
    with pytest.raises(TypeError, match="not callable"):  # its ``init`` field hides flax's
        jm.init(jax.random.PRNGKey(0), x)  # init method (ROADMAP.md section 3)
    params = {"prelu": np.float32(0.2) + np.linspace(0.0, 0.3, num, dtype=np.float32)}
    tm = tfag.PRelu(num, 0.2)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    np.testing.assert_array_equal(
        _nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2))),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))))
    np.testing.assert_array_equal(jax_tree_from_state_dict(tm.state_dict(), tm)["prelu"],
                                  params["prelu"])


@pytest.mark.parametrize("ksp", [(4, 2, 1), (8, 4, 2), (12, 8, 2), (3, 1, 0)])
def test_torch_conv_transpose_matches_jax(ksp):
    """torch's ConvTranspose2d(k, s, p) semantics: the flax kernel (k, k,
    out, in) becomes the unflipped (in, out, k, k) weight."""
    k, s, p = ksp
    x = np.random.default_rng(2).standard_normal((2, 5, 4, 6)).astype(np.float32)
    jm = jfag.TorchConvTranspose(out_ch=3, kernel=k, stride=s, pad=p)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(k), x)["params"])
    params["bias"] = params["bias"] + np.float32(0.1)
    tm = tfag.TorchConvTranspose(6, 3, k, s, p)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, (5 - 1) * s - 2 * p + k, (4 - 1) * s - 2 * p + k, 3)
    _close(got, want)
    back = jax_tree_from_state_dict(tm.state_dict(), tm)
    np.testing.assert_array_equal(back["kernel"], params["kernel"])


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_render_heatmaps_matches_jax(sigma):
    coords = (np.random.default_rng(3).random((2, 68, 2)) * 16).astype(np.float32)
    want = np.asarray(jdic.render_heatmaps(jnp.asarray(coords), 16, 12, sigma))
    got = tdic.render_heatmaps(torch.from_numpy(coords), 16, 12, sigma).numpy()
    assert got.shape == want.shape == (2, 16, 12, 68)
    np.testing.assert_allclose(got, want, atol=HEAT_ATOL, rtol=0)


@pytest.mark.parametrize("k", [68, 5])
def test_merge_heatmap_5_matches_jax(k):
    """Each map divided by its spatial max (at least 0.05: the last map
    stays below it), the 68 landmarks merged into 5 regions; ``detach``
    cuts the gradient."""
    hm = np.random.default_rng(4).standard_normal((2, 6, 7, k)).astype(np.float32)
    hm[..., -1] *= 0.01
    want = np.asarray(jdic.merge_heatmap_5(jnp.asarray(hm), False))
    t = torch.from_numpy(hm).permute(0, 3, 1, 2).requires_grad_(True)
    got = tdic.merge_heatmap_5(t, False)
    assert got.requires_grad and not tdic.merge_heatmap_5(t, True).requires_grad
    assert want.shape == (2, 6, 7, 5)
    _close(_nhwc(got), want, 1e-6)
    with pytest.raises(NotImplementedError):
        tdic.merge_heatmap_5(t[:, :4], False)


def test_upsample_bilinear_align_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jdic.upsample_bilinear_align(jnp.asarray(x), 2))
    got = _nhwc(tdic.upsample_bilinear_align(torch.from_numpy(x).permute(0, 3, 1, 2), 2))
    assert got.shape == want.shape == (2, 10, 14, 3)
    _close(got, want, 1e-6)


# -- the network ------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [4, 8])
def test_dic_forward_matches_jax(scale):
    """Every step's SR image and heatmaps; the bridge carries the params
    into a fresh port DIC and back bit for bit."""
    tm, params, jm = _net(scale)
    x = np.random.default_rng(scale).random((2, 8, 8, 3)).astype(np.float32)
    srs, heatmaps = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        tsrs, theat = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(tsrs) == len(srs) == len(theat) == len(heatmaps) == SMALL["num_steps"]
    for a, b in zip(tsrs, srs):
        assert a.shape == (2, 3, 8 * scale, 8 * scale)
        _close(_nhwc(a), b)
    for a, b in zip(theat, heatmaps):
        assert a.shape == (2, 68, 16, 16)
        _close(_nhwc(a), b)
    fresh = tdic.DIC(scale=scale, **SMALL)
    fresh.load_state_dict(state_dict_from_jax(params, fresh))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in fresh.state_dict().items())
    back = jax_tree_from_state_dict(fresh.state_dict(), fresh)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                    jax.tree_util.tree_leaves(params)))


# -- the handler ------------------------------------------------------------------------

def _landmarks(path, names, seed=6):
    rng = np.random.default_rng(seed)
    marks = {n: (rng.random((68, 2)) * 32).astype(np.float32) for n in names}
    with open(path, "wb") as f:
        pickle.dump(marks, f)
    return marks


def _assert_moves(got_after, want_after, before, rel=F32_GRAD_REL, ulps=PARAM_ULPS):
    largest = 0.0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want_after)[0],
                               jax.tree_util.tree_leaves(got_after),
                               jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        largest = max(largest, move)
        assert np.abs(g - w).max() <= rel * move + ulps, jax.tree_util.keystr(path)
    assert largest > 0


def test_dic_steps_match_jax(tmp_path):
    """Two SGD steps (lr 1, momentum 0.9) with the landmarks looked up from
    a pickle by tag (``_<anything>.`` cut to ``.``): the losses and every
    parameter. Before ``hg_release_step`` (1) the hourglass does not move
    in either package; at it, it does."""
    tm, params, _ = _net(4)
    lm = str(tmp_path / "landmarks.pkl")
    _landmarks(lm, ["000001.npy", "000002.npy"])
    kw = dict(SMALL, landmarks_file=lm, hg_release_step=1, **SGD)
    jh = jax_model("dic")(**kw)
    th = torch_model("dic")(device="cpu", **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jh.tx.init(jp),
                    extra={}, rng=jax.random.PRNGKey(0))
    th.module.load_state_dict(state_dict_from_jax(params, th.module))
    state = th._own_state()
    rng = np.random.default_rng(7)
    batch = {"lr": rng.random((2, 8, 8, 3)).astype(np.float32),
             "hr": rng.random((2, 32, 32, 3)).astype(np.float32),
             "tags": ["000001_x4.npy", "000002.npy"]}
    before = params
    for step in range(2):
        js, jl = jh.train_batch(js, {k: v if k == "tags" else jnp.asarray(v)
                                     for k, v in batch.items()})
        state, tl = th.train_batch(state, batch)
        assert set(tl) == set(jl) == {"pix_loss", "align_loss", "train-loss", "full_loss"}
        for k, w in jl.items():
            assert abs(float(tl[k]) - float(w)) <= 1e-5 * abs(float(w)), (k, step)
        want = jax.tree_util.tree_map(np.array, js.params)
        got = jax_tree_from_state_dict(state.params, th.module)
        _assert_moves(got, want, before)
        hg_moved = [not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(want["hg"]), jax.tree_util.tree_leaves(before["hg"]))]
        port_moved = [not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(got["hg"]), jax.tree_util.tree_leaves(before["hg"]))]
        assert hg_moved == port_moved, step
        assert all(hg_moved) if step else not any(hg_moved), step
        before = want
    assert int(js.step) == state.step == 2


def test_dic_handler_surface_matches_jax(tmp_path):
    """dicnet's aliases and its warning; x2 refused; the default schedule,
    size multiple and tags; the lookup's key rule and its KeyError; an eval
    forward's shape."""
    lm = str(tmp_path / "landmarks.pkl")
    _landmarks(lm, ["000003.npy"])
    for make in (jax_model, lambda n: (lambda **kw: torch_model(n)(device="cpu", **kw))):
        with pytest.warns(UserWarning, match="num_landmarks"):
            h = make("dicnet")(nf=8, iterations=1, num_landmarks=5, num_groups=1,
                               hg_num_feature=16, num_fusion_block=1, landmarks_file=lm)
        assert h.model_kwargs["num_features"] == 8 and h.model_kwargs["num_steps"] == 1
        assert h.size_multiple == 8 and h.wants_tags and h.hg_release_step == 2_000_000
        np.testing.assert_array_equal(np.asarray(h._lookup_landmarks("000003_q7.npy")),
                                      np.asarray(h._lookup_landmarks("000003.npy")))
        with pytest.raises(KeyError, match="no landmarks"):
            h._lookup_landmarks("000004.npy")
        with pytest.raises(NotImplementedError, match="Upscale factor 2"):
            m = make("dic")(scale=2, **SMALL).module
            if hasattr(m, "init"):
                jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    th = torch_model("dic")(device="cpu", **SMALL)
    assert th.scheduler_params == {"milestones": [10000, 20000, 40000, 80000], "gamma": 0.5}
    assert [th.schedule(t) for t in (9999, 10000, 80000)] == [1e-4, 5e-5, 6.25e-6]
    out = th.run_eval(th.init_state(), {"lr": np.full((1, 8, 8, 3), 0.5, np.float32)})
    assert tuple(out.shape) == (1, 32, 32, 3) and bool(torch.isfinite(out).all())


def test_landmark_targets_ignore_the_crop_corner_in_both(tmp_path):
    """ROADMAP.md section 3: an item's tag carries no crop corner, so both
    handlers look up the whole image's landmarks for every crop of it and
    render the same heatmap target, wherever the face lies in the crop."""
    from rumpy_tpu_torch.data.datasets import SuperResImages
    lr_dir, hr_dir = tmp_path / "lr", tmp_path / "hr"
    lr_dir.mkdir()
    hr_dir.mkdir()
    rng = np.random.default_rng(8)
    np.save(hr_dir / "000001.npy", (rng.random((64, 64, 3)) * 255).astype(np.uint8))
    np.save(lr_dir / "000001.npy", (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    lm = str(tmp_path / "landmarks.pkl")
    _landmarks(lm, ["000001.npy"])
    ds = SuperResImages(lr_dir=str(lr_dir), hr_dir=str(hr_dir), scale=4, crop=8)
    items = [ds[0] for _ in range(12)]
    crops = {it["lr"].tobytes() for it in items}
    assert len(crops) > 1 and {it["tag"] for it in items} == {"000001.npy"}
    assert not [k for k in items[0] if "corner" in k or k in ("top", "left")]
    jh = jax_model("dic")(landmarks_file=lm, **SMALL)
    th = torch_model("dic")(device="cpu", landmarks_file=lm, **SMALL)
    coords = np.asarray(jh._lookup_landmarks(items[0]["tag"]))
    for it in items:
        np.testing.assert_array_equal(th._lookup_landmarks(it["tag"]), coords)
    want = np.asarray(jdic.render_heatmaps(jnp.asarray(coords[None] / 2.0), 16, 16))
    got = tdic.render_heatmaps(torch.from_numpy(coords[None] / 2.0), 16, 16).numpy()
    np.testing.assert_allclose(got, want, atol=HEAT_ATOL, rtol=0)
