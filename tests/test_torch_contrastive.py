"""The contrastive predictors of the port on the CPU, against the JAX
package: class labelling, the supervised contrastive loss, one train step
of each handler (moco, supmoco, weakcon, supcon, degradationregressor) from
one state bridged from the JAX handler, the packaged
``supmoco_fullchain_d256`` checkpoint loaded whole, the queue's K % n rule,
the clustering scores, and the degradation chain's multi-view mode.

Tolerances (f32): classes exact, vectors within 1e-6; supcon_loss rtol
1e-5; a train step's losses within 1e-6 + 5e-6 |loss| (SupCon's, through
two chained train-mode forwards and exponentials of logits up to 1/T,
stood 1.3e-6 off at 0.50), its parameter moves (SGD at lr 1: the
gradients; Adam's first step, lr * g / (|g| + 1e-8), would let rounding
decide the move of a parameter whose gradient is near 1e-8) within 1e-6,
or 1e-5 of the largest gradient entry where that is more (SupMoCo's with
its direct loss reach 293; measured up to 4e-6 of it), and its BatchNorm
statistics within 1e-6 of the largest, the key
encoder within one float32 ulp of its operands' size (one product and
one sum of the same values, which XLA may fuse); the
queue rows a step writes (the key encoder's normalized projections, the
end of eight layers of f32 sums in another order) within 1e-5 and every
other row bit for bit, the pointer and the label and vector
queues exact. Clustering scores rtol 1e-6 of scikit-learn's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import contrastive_labelling as jcl
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.utils.losses import supcon_loss as jax_supcon
from rumpy_tpu_torch.models import contrastive_labelling as tcl
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils import checkpoint as ckpt
from rumpy_tpu_torch.utils.losses import supcon_loss
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

PACKAGED = "supmoco_fullchain_d256"
SGD = dict(optimizer_type="sgd", lr=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_diff(a, b):
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda u, v: float(np.abs(np.asarray(u, np.float32) - np.asarray(v, np.float32)).max()),
        a, b)))


def _momentum_agrees(got, want, key_before, query_before):
    """The key encoder after ``key * m + query * (1 - m)``: leaf for leaf
    within one float32 ulp of the operands' size, 2**-23 (|key| + |query|)
    (one product and one sum of the same values, which XLA may fuse; a
    result that cancels is exact only to its operands' ulps)."""
    jax.tree_util.tree_map(
        lambda g, w, k, q: np.testing.assert_array_less(
            np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)),
            2.0 ** -23 * (np.abs(np.asarray(k)) + np.abs(np.asarray(q))) + 1e-30),
        got, want, key_before, query_before)


def _max_abs(tree):
    return max(float(np.abs(np.asarray(v, np.float32)).max())
               for v in jax.tree_util.tree_leaves(tree))


# -- labelling -----------------------------------------------------------------

BLUR = ["0-realesrganblur-sigma_x", "0-realesrganblur-sigma_y", "0-realesrganblur-kernel_type"]
NOISE = ["2-realesrgannoise-gaussian_noise_scale", "2-realesrgannoise-poisson_noise_scale",
         "2-realesrgannoise-gray_noise"]
KEY_SETS = {"all": BLUR + ["1-downsample-scale"] + NOISE
            + ["3-randomcompress-jm_qpi", "3-randomcompress-jpeg_quality"],
            "jpeg_only": NOISE + ["3-jpegcompress-quality"] + BLUR,
            "jm_only": ["3-jmcompress-qpi"] + NOISE}


def _metadata(keys, n=64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((n, len(keys))).astype(np.float32)
    for j, k in enumerate(keys):
        if k.endswith("kernel_type"):
            m[:, j] = rng.integers(0, 7, n)
        elif k.endswith(("gaussian_noise_scale", "jm_qpi")):
            m[rng.random(n) < 0.5, j] = 0.0  # the other type of the pair
        elif k.endswith("gray_noise"):
            m[:, j] = rng.integers(0, 2, n)
    # boundary values of the magnitude splits
    m[:4, :] = np.array([0.5, 0.33, 0.66, 0.0], np.float32)[:, None]
    return m


@pytest.mark.parametrize("strategy", ["default", "double_precision", "triple_precision"])
@pytest.mark.parametrize("keys", list(KEY_SETS))
@pytest.mark.parametrize("selected", ["all", ("noise", "blur")])
def test_classes_and_vectors_match_jax(strategy, keys, selected):
    meta_keys = KEY_SETS[keys]
    std = tcl.register_metadata(meta_keys)
    assert std == jcl.register_metadata(meta_keys)
    m_map = {k: i for i, k in enumerate(std)}
    got = tcl.partition_metadata(m_map, selected, strategy)
    want = jcl.partition_metadata(m_map, selected, strategy)
    assert got == (want[0], [int(v) for v in want[1]], int(want[2]))
    valid, mags, nc = got
    meta = _metadata(meta_keys)
    labels = tcl.assign_classes(torch.from_numpy(meta), m_map, valid, mags, nc, strategy)
    want_labels = np.asarray(jcl.assign_classes(jnp.asarray(meta), m_map, valid, mags, nc,
                                                strategy))
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert labels.dtype == torch.int64 and (nc == 0 or labels.max() < nc)
    vec = tcl.degradation_vectors(torch.from_numpy(meta), m_map, valid)
    want_vec = np.asarray(jcl.degradation_vectors(jnp.asarray(meta), m_map, valid))
    assert vec.shape[1] == tcl.degradation_vector_size(valid) == want_vec.shape[1]
    np.testing.assert_allclose(vec.numpy(), want_vec, atol=1e-6, rtol=0)


# -- supcon_loss ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["one", "all"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_supcon_loss_matches_jax(mode, with_labels):
    rng = np.random.default_rng(1)
    f = rng.standard_normal((6, 3, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = np.array([0, 1, 0, 2, 1, 0]) if with_labels else None
    want = float(jax_supcon(jnp.asarray(f), None if labels is None else jnp.asarray(labels),
                            contrast_mode=mode))
    got = float(supcon_loss(torch.from_numpy(f),
                            None if labels is None else torch.from_numpy(labels),
                            contrast_mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="contrast_mode"):
        supcon_loss(torch.from_numpy(f), contrast_mode="none")


# -- one train step of each handler -------------------------------------------------

CASES = {
    "moco_p1": ("moco", dict(K=8, dim=32, positives=1), 1),
    "moco_p3": ("moco", dict(K=8, dim=32, positives=3), 3),
    "supmoco_direct_dropdown": ("supmoco", dict(K=8, dim=32, dropdown=6, num_classes=4,
                                                positives_per_class=2,
                                                include_direct_loss=True), 2),
    "weakcon": ("weakcon", dict(K=8, dim=32, positives_per_class=2, vector_size=6), 2),
    "supcon": ("supcon", dict(dim=32), 1),
}


def _jax_state(jh, name):
    """The JAX handler's fresh state, with the pointer off slot 0 and
    side-queues that hold something."""
    js = jh.init_state()
    extra = dict(js.extra)
    extra["queue_ptr"] = jnp.asarray(4, jnp.int32)
    if "queue_labels" in extra:
        extra["queue_labels"] = jnp.asarray([0, 1, 2, 3, -1, 1, -1, 0], jnp.int32)
    if "queue_vectors" in extra:
        extra["queue_vectors"] = jnp.asarray(
            np.random.default_rng(9).random(extra["queue_vectors"].shape), jnp.float32)
    return js.replace(extra=extra)


def _contrastive_batch(p, n=2, seed=0, vector_size=6):
    rng = np.random.default_rng(seed)
    return {"image_query": rng.random((n, 16, 16, 3)).astype(np.float32),
            "image_key": rng.random((n * p, 16, 16, 3)).astype(np.float32),
            "labels": np.array([1, 3, 0, 2], np.int32)[:n],
            "vector": rng.random((n, vector_size)).astype(np.float32)}


def _losses_agree(tl, jl):
    for k in tl:
        want = float(jl[k])
        assert abs(float(tl[k]) - want) <= 1e-6 + 5e-6 * abs(want), k


def _moves_agree(got_params, js, js2, rel=1e-5):
    """Parameters after one SGD step at lr 1 (the gradient) within 1e-6,
    or ``rel`` of the largest gradient entry where that is more."""
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   _np(js.params), _np(js2.params))
    assert _max_diff(got_params, _np(js2.params)) <= max(1e-6, rel * _max_abs(grads))


def _port_from(name, kw, js):
    th = torch_model(name)(device="cpu", **kw)
    th.module.load_state_dict(th._jax_state_dict({"network": _np(js.params),
                                                  "extra": _np(js.extra)}))
    return th, th._own_state()


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    name, kw, p = CASES[case]
    kw = dict(kw, **SGD)
    jh = jax_model(name)(**kw)
    js = _jax_state(jh, name)
    th, state = _port_from(name, kw, js)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = _contrastive_batch(p)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(state, batch)
    assert set(tl) == set(jl)
    _losses_agree(tl, jl)
    got = th.jax_trees(state2)
    want_extra = _np(js2.extra)
    _moves_agree(got["network"], js, js2)
    for stats in ("q_bstats", "k_bstats"):
        assert _max_diff(got["extra"][stats], want_extra[stats]) \
            <= 1e-6 * _max_abs(want_extra[stats]), stats
    # supcon runs the query encoder twice: its statistics advance twice
    _momentum_agrees(got["extra"]["key_params"], want_extra["key_params"],
                     _np(js.extra["key_params"]), _np(js.params))
    queue, want_q = got["extra"]["queue"], want_extra["queue"]
    written = [4, 5] if name != "supcon" else []
    np.testing.assert_allclose(queue[written], want_q[written], atol=1e-5, rtol=0)
    rest = [i for i in range(len(queue)) if i not in written]
    np.testing.assert_array_equal(queue[rest], want_q[rest])
    np.testing.assert_array_equal(queue[rest], before["queue"].numpy()[rest])
    assert int(got["extra"]["queue_ptr"]) == int(want_extra["queue_ptr"])
    for side in th.QUEUE_SIDES:
        np.testing.assert_array_equal(got["extra"][side], want_extra[side])


def test_degradation_regressor_step_matches_jax():
    kw = dict(num_targets=5, **SGD)
    jh = jax_model("degradationregressor")(**kw)
    js = jh.init_state()
    th = torch_model("degradationregressor")(device="cpu", **kw)
    th.module.load_state_dict(th._jax_state_dict({"network": _np(js.params),
                                                  "extra": _np(js.extra)}))
    state = th._own_state()
    rng = np.random.default_rng(2)
    batch = {"lr": rng.random((3, 16, 16, 3)).astype(np.float32),
             "metadata": rng.random((3, 5)).astype(np.float32)}
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(state, batch)
    _losses_agree(tl, jl)
    from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
    _moves_agree(jax_tree_from_state_dict(state2.params, th.module), js, js2)
    want = _np(js2.extra["q_bstats"])
    assert _max_diff(jax_tree_from_state_dict(state2.params, th.module, "batch_stats"),
                     want) <= 1e-6 * _max_abs(want)


@pytest.mark.parametrize("name", ["moco", "supmoco", "weakcon"])
def test_queue_batch_must_divide_k(name):
    """K % n != 0 raises in both packages, before the state moves."""
    kw = dict(K=8, dim=32, positives_per_class=1) if name != "moco" else dict(K=8, dim=32)
    if name == "supmoco":
        kw["num_classes"] = 4
    if name == "weakcon":
        kw["vector_size"] = 6
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th, state = _port_from(name, kw, js)
    batch = _contrastive_batch(1, n=3)
    with pytest.raises(ValueError, match="multiple of the global enqueue batch"):
        jh.train_batch(js, {k: jnp.asarray(v) for k, v in batch.items()})
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(ValueError, match="multiple of the global enqueue batch"):
        th.train_batch(state, batch)
    assert all(torch.equal(before[k], v) for k, v in state.params.items())


def test_supmoco_empty_slot_label_matches_nothing():
    """-1 marks an empty queue slot: the port's label matches are JAX's
    one-hot products, where -1 (and a label past num_classes) is a zero
    row; ``F.one_hot`` would raise on -1."""
    from rumpy_tpu_torch.models.contrastive import class_matches
    labels = np.array([0, 1, 3, 5, -1])
    queue = np.array([-1, 0, 1, -1, 3, 5, 0])
    nc = 3
    want = np.asarray(jax.nn.one_hot(labels, nc + 1) @ jax.nn.one_hot(queue, nc + 1).T)
    got = class_matches(torch.from_numpy(labels), torch.from_numpy(queue), nc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_supmoco_dropdown_default_is_dim_wide():
    """contrastive_dropdown defaults to True with dropdown None: it
    collapses to a falsy value, and the queue is dim wide."""
    th = torch_model("supmoco")(device="cpu", K=8, dim=32)
    jh = jax_model("supmoco")(K=8, dim=32)
    assert not th.contrastive_dropdown and not jh.contrastive_dropdown
    assert th.proj_dim == jh.proj_dim == 32
    assert tuple(th.module.queue.shape) == (8, 32)


# -- the packaged checkpoint --------------------------------------------------------

@pytest.fixture(scope="module")
def packaged_pair():
    path = ckpt.resolve_packaged(PACKAGED)
    jh = jax_model("supmoco")(dim=256, K=8192, num_classes=12, **SGD)
    js, _ = jh.load_model(path, "last", skip_optimizer_load=True)
    th = torch_model("supmoco")(device="cpu", dim=256, K=8192, num_classes=12, **SGD)
    ts, epoch = th.load_model(path, "last", skip_optimizer_load=True)
    assert epoch == 29
    return jh, js, th, ts


def test_packaged_checkpoint_loads_whole(packaged_pair):
    """Every part of supmoco_fullchain_d256's state lands in the port bit
    for bit: weights, both encoders' statistics, the key encoder, the
    8192 x 256 queue, its pointer and its labels; the embeddings agree."""
    jh, js, th, ts = packaged_pair
    got = th.jax_trees(ts)
    assert _max_diff(got["network"], _np(js.params)) == 0.0
    for k in ("key_params", "q_bstats", "k_bstats", "queue"):
        assert _max_diff(got["extra"][k], _np(js.extra[k])) == 0.0, k
    assert got["extra"]["queue"].shape == (8192, 256)
    assert int(got["extra"]["queue_ptr"]) == int(js.extra["queue_ptr"])
    np.testing.assert_array_equal(got["extra"]["queue_labels"], np.asarray(js.extra["queue_labels"]))
    x = np.random.default_rng(4).random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jh.run_embedding(js, x))
    emb = th.run_embedding(ts, x).numpy()
    assert np.abs(emb - want).max() <= 1e-4 * np.abs(want).max()


def test_packaged_checkpoint_next_step_matches(packaged_pair):
    jh, js, th, ts = packaged_pair
    rng = np.random.default_rng(5)
    batch = {"image_query": rng.random((2, 32, 32, 3)).astype(np.float32),
             "image_key": rng.random((8, 32, 32, 3)).astype(np.float32),
             "labels": np.array([3, 7], np.int32)}
    ptr = int(js.extra["queue_ptr"])
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    ts2, tl = th.train_batch(ts, batch)
    _losses_agree(tl, jl)
    got = th.jax_trees(ts2)
    # a trained 256-wide encoder whose last BatchNorm normalizes 128 values
    # a channel here: 3.3e-5 of the largest gradient measured
    _moves_agree(got["network"], js, js2, rel=1e-4)
    _momentum_agrees(got["extra"]["key_params"], _np(js2.extra["key_params"]),
                     _np(js.extra["key_params"]), _np(js.params))
    q = got["extra"]["queue"]
    np.testing.assert_allclose(q[ptr:ptr + 2], np.asarray(js2.extra["queue"])[ptr:ptr + 2],
                               atol=1e-5, rtol=0)
    assert int(got["extra"]["queue_ptr"]) == int(js2.extra["queue_ptr"]) == (ptr + 2) % 8192
    np.testing.assert_array_equal(got["extra"]["queue_labels"],
                                  np.asarray(js2.extra["queue_labels"]))


# -- clustering scores -------------------------------------------------------------

def test_clustering_scores_match_sklearn():
    """The port's float64 device scores against the JAX package's
    scikit-learn ones, on the same encoder embeddings (a class of one
    sample included, whose silhouette is 0)."""
    from rumpy_tpu.evaluation.contrastive_eval import ContrastiveEval as JaxEval
    from rumpy_tpu_torch.evaluation.contrastive_eval import clustering_scores
    jh = jax_model("moco")(K=8, dim=32)
    js = jh.init_state()
    x = np.random.default_rng(6).random((40, 24, 24, 3)).astype(np.float32)
    x[:20] *= 0.5  # two families of inputs
    emb = np.array(jh.run_embedding(js, x))
    labels = np.repeat(np.arange(5), 8)
    labels[-1] = 9
    want = JaxEval.clustering_scores(emb, labels)
    got = clustering_scores(torch.from_numpy(emb), torch.from_numpy(labels))
    assert set(got) == set(want) == {"davies_bouldin", "calinski_harabasz", "silhouette"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert clustering_scores(torch.from_numpy(emb), torch.zeros(40, dtype=torch.int64)) == {}
    assert JaxEval.clustering_scores(emb, np.zeros(40)) == {}


# -- the chain's multi-view mode -------------------------------------------------------

CHAIN = [["realesrganblur", "b"], ["downsample", "d"], ["realesrgannoise", "n"]]
CHAIN_CFG = {"b": {"kernel_range": ["iso", "aniso"], "kernel_size": 9,
                   "request_kernel_metadata": True},
             "d": {"scale": 2}, "n": {"gaussian_noise_sigma_range": [1, 30]}}


def test_views_of_one_image_share_one_draw_set():
    """A stack of P views an image in one pass: the metadata has a row an
    image, the same rows as the first views degraded alone from the same
    seed, and identical views come out identical (Gaussian noise: one
    field an image); a Poisson image's views share its scale and gray flag,
    their samples follow their own pixels."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    pipe = ImagePipeline(CHAIN, deg_configs=CHAIN_CFG, scale=2)
    n, p = 4, 3
    rng = np.random.default_rng(8)
    hr = torch.from_numpy(rng.random((n, p, 32, 32, 3)).astype(np.float32))
    hr[:, 1] = hr[:, 0]  # view 1 repeats view 0
    lr, meta = pipe.degrade_batch(torch.Generator().manual_seed(3),
                                  hr.reshape(n * p, 32, 32, 3), views=p)
    mat, keys = pipe.metadata_matrix(meta)
    assert lr.shape == (n * p, 16, 16, 3) and mat.shape[0] == n
    first, meta1 = pipe.degrade_batch(torch.Generator().manual_seed(3), hr[:, 0])
    mat1, keys1 = pipe.metadata_matrix(meta1)
    assert keys == keys1
    np.testing.assert_array_equal(mat.numpy(), mat1.numpy())
    lr = lr.reshape(n, p, 16, 16, 3)
    gauss = meta["2-realesrgannoise-gaussian_noise_scale"] > 0
    assert 0 < int(gauss.sum()) < n  # both noise types drawn
    for i in range(n):
        if gauss[i]:
            np.testing.assert_array_equal(lr[i, 1].numpy(), lr[i, 0].numpy())
            np.testing.assert_array_equal(lr[i, 0].numpy(), first[i].numpy())
    with pytest.raises(ValueError, match="views an image"):
        pipe.degrade_batch(torch.Generator().manual_seed(3), hr[:, 0], views=3)
