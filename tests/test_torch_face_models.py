"""The face models in the port, on the CPU, against the JAX package
(``rumpy_tpu/models/face_models.py``): ``ConvTranspose`` alone (flax's
kernel orientation and 'SAME' alignment), ``SPConv`` in its scale, norm and
activation variants and an ``HourGlassBlock`` at a size where its two
branches differ (train-mode outputs and BatchNorm statistics); SPARNet and
QSPARNet (eval, one train step's updates and statistics); RCANSplitCeleb
(eval of both experts, a mixed batch's step, a single-allocation step after
two warm-up steps: NaN loss and the absent expert bit for bit); FaceGAN (one
step with the JAX side's draws injected); and JAX-written checkpoints of
the four models evaluated in the port. Flax params and statistics come over
through the weight bridge; inputs come from a numpy seed.

Tolerances: f32 outputs within 1e-5 of flax (1e-4 for the deep SPARNet's
and FaceGAN's, whose outputs pass through 20-40 BatchNorm layers or a
tanh of sums of 25 nf terms; stated where used), BatchNorm statistics
within 1e-5, a train step under SGD at lr 1 (a parameter moves by its
gradient) within 1e-6 of the loss (1e-5 for FaceGAN's BCE logs) and each
move within 1e-4 of that leaf's largest move (of the largest move of all
for a bias in front of a train-mode BatchNorm, whose exact gradient is
zero) plus two float32 ulps. SPARNet's step is the exception: its
hourglasses normalise 2 x 4 x 4 values a channel in train mode, and JAX's
float32 step stands up to 8e-4 of a move off the float64 step (the
port's float32 step 1.2e-4; CPU, this test's batch of 2), so its float32
moves are held within 1e-3 of the largest move of all, and the two
packages' float64 steps within 1e-9 of each leaf's move.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import face_models as jfm
from rumpy_tpu.models.base import build_optimizer as jax_optimizer
from rumpy_tpu.models.common import TConvTranspose
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import common as tcommon
from rumpy_tpu_torch.models import face_models as tfm
from rumpy_tpu_torch.models.base import build_optimizer as torch_optimizer
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

F32_ATOL, DEEP_ATOL, STAT_ATOL = 1e-5, 1e-4, 1e-5
MOVE_REL, SPAR_MOVE_REL, F64_MOVE_REL, PARAM_ULPS = 1e-4, 1e-3, 1e-9, 2.0 ** -22
SGD = dict(optimizer_type="sgd", lr=1.0)
SPAR = dict(scale=2, min_ch=8, max_ch=16, in_size=32, out_size=32, min_feat_size=16,
            res_depth=1, bottleneck_size=16)
HANDLERS = {
    "sparnet": ("sparnet", dict(SPAR)),
    "sparnet_prelu_pixel": ("sparnet", dict(SPAR, relu_type="prelu", norm_type="pixel")),
    "qsparnet": ("qsparnet", dict(SPAR, metadata=["all"])),
    "qsparnet_encoder_only": ("qsparnet", dict(SPAR, metadata=["all"],
                                               metadata_encoder_only=True, relu_type="prelu")),
}
SPLIT = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _stats(tree):
    return _np(tree) if tree else None


# -- blocks ------------------------------------------------------------------------

@pytest.mark.parametrize("k,s", [(4, 2), (3, 2), (5, 2), (2, 2), (3, 3)])
def test_conv_transpose_matches_flax(k, s):
    """flax's ConvTranspose (no kernel flip, 'SAME': size x stride outputs)
    against the port's on a 5 x 7 input, and the bias."""
    x = _rand((2, 5, 7, 6), 1) - 0.5
    jm = TConvTranspose(4, (k, k), strides=(s, s), padding="SAME")
    params = jm.init(jax.random.PRNGKey(k * 10 + s), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"], "bias": jnp.asarray(_rand((4,), 2))}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tcommon.ConvTranspose(6, 4, k, s)
    tm.load_state_dict(state_dict_from_jax(_np(params), tm))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, 5 * s, 7 * s, 4)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    back = jax_tree_from_state_dict(tm.state_dict(), tm)
    np.testing.assert_array_equal(back["kernel"], np.asarray(params["kernel"]))


def _block_pair(jm, tm, x, seed, *args):
    """flax init of ``jm`` on ``x``, its statistics moved off their init;
    ``tm`` loaded with both. Returns (variables, tm)."""
    variables = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), *args))
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + 0.2 * rng.random(a.shape).astype(np.float32), variables["batch_stats"])
    tm.load_state_dict(state_dict_from_jax(variables["params"], tm,
                                           batch_stats=_stats(variables.get("batch_stats"))))
    return variables, tm


def _train_mode_pair(jm, tm, variables, x, call_kw):
    """Train-mode outputs and the statistics after one call, both packages."""
    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                         **call_kw)
    got = tm(_nchw(x), train=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=F32_ATOL, rtol=0)
    got_stats = jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(got_stats),
                    jax.tree_util.tree_leaves(_np(mut.get("batch_stats", {})))):
        np.testing.assert_allclose(g, w, atol=STAT_ATOL, rtol=0)


@pytest.mark.parametrize("scale,norm,relu", [
    ("none", "none", "prelu"), ("down", "bn", "leakyrelu"), ("up", "pixel", "relu"),
    ("none", "bn", "prelu"), ("down", "none", "none")])
def test_spconv_matches_flax(scale, norm, relu):
    """SPConv's eval output, then its train-mode output and statistics."""
    x = _rand((2, 7, 6, 5), 3) - 0.5
    jm = jfm.SPConv(8, 3, scale=scale, norm=norm, relu=relu)
    variables, tm = _block_pair(jm, tfm.SPConv(5, 8, 3, scale=scale, norm=norm, relu=relu),
                                x, 4)
    if "prelu" in variables["params"]:  # off its 0.25 init
        variables["params"]["prelu"] = _rand((8,), 5) - 0.5
        tm.load_state_dict(state_dict_from_jax(variables["params"], tm,
                                               batch_stats=_stats(variables.get("batch_stats"))))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, atol=F32_ATOL, rtol=0)
    _train_mode_pair(jm, tm, variables, x, {})


@pytest.mark.parametrize("size", [(10, 10), (7, 9)])
def test_hourglass_matches_flax_where_its_branches_differ(size):
    """An HourGlassBlock of depth 2: at 10 x 10 the inner level's branches
    are 5 x 5 and 6 x 6, at 7 x 9 both levels' differ, so up2 is resized
    by nearest with half-pixel centres."""
    x = _rand((2, *size, 8), 6) - 0.5
    jm = jfm.HourGlassBlock(2, 1, c_mid=8)
    variables, tm = _block_pair(jm, tfm.HourGlassBlock(8, 2, 1, c_mid=8), x, 7)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, atol=F32_ATOL, rtol=0)
    _train_mode_pair(jm, tm, variables, x, {})


def test_resize_nearest_reads_half_pixel_centres():
    x = torch.arange(6.0).reshape(1, 1, 1, 6)
    want = np.asarray(jax.image.resize(jnp.arange(6.0).reshape(1, 1, 6, 1), (1, 1, 5, 1),
                                       "nearest"))[0, 0, :, 0]
    np.testing.assert_array_equal(tfm.resize_nearest(x, (1, 5))[0, 0, 0].numpy(), want)


# -- SPARNet / QSPARNet ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _handler_pair(case):
    """The JAX handler and state (statistics moved off their init) and the
    port handler loaded with them."""
    name, kw = HANDLERS[case]
    jh = jax_model(name)(**kw, **SGD)
    js = jh.init_state()
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.random(a.shape)
                                   .astype(np.float32), _np(js.extra["vars"]["batch_stats"]))
    js = js.replace(extra={**js.extra, "vars": {"batch_stats": stats}})
    th = torch_model(name)(device="cpu", **kw, **SGD)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module,
                                                  batch_stats=_stats(stats)))
    return jh, js, th


def _spar_batch(th, rng, n=2):
    b = {"lr": rng.random((n, 32, 32, 3)).astype(np.float32),
         "hr": rng.random((n, 32, 32, 3)).astype(np.float32)}
    if th.uses_metadata:
        b["metadata"] = (rng.random((n, th.num_metadata)) > 0.5).astype(np.float32)
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_moves(after, before, want_after, zero_in_exact=lambda path: False,
                  rel=MOVE_REL, ulps=PARAM_ULPS):
    """Each leaf's move within ``rel`` of that leaf's largest JAX move plus
    ``ulps``; a leaf whose exact gradient is zero within ``rel`` of the
    largest move of all."""
    flat = jax.tree_util.tree_flatten_with_path(_np(want_after))[0]
    moves = [np.abs(w - b).max() for (_, w), b in zip(flat, jax.tree_util.tree_leaves(before))]
    top = max(moves)
    assert top > 0
    for ((path, w), g, move) in zip(flat, jax.tree_util.tree_leaves(after), moves):
        name = jax.tree_util.keystr(path)
        scale = top if zero_in_exact(name) else move
        assert np.abs(g - w).max() <= rel * scale + ulps, name


@pytest.mark.parametrize("case", list(HANDLERS))
def test_sparnet_handlers_match_jax(case):
    """Eval (running statistics), then one train step: the loss, every
    parameter's move and every BatchNorm statistic the step wrote (deep
    outputs within 1e-4)."""
    jh, js, th = _handler_pair(case)
    state = th._own_state()
    batch = _spar_batch(th, np.random.default_rng(9))
    want = np.asarray(jh.run_eval(js, _jnp(batch)))
    np.testing.assert_allclose(th.run_eval(state, batch).numpy(), want, atol=DEEP_ATOL, rtol=0)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, tl = th.train_batch(state, batch)
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)
    # a conv's bias in front of a train-mode BatchNorm: none here (SPConv
    # drops it under "bn"), so every leaf is held to its own move
    _assert_moves(after, before, js2.params, zero_in_exact=lambda path: True,
                  rel=SPAR_MOVE_REL)
    got = jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats")
    want_stats = js2.extra["vars"]["batch_stats"]
    if jax.tree_util.tree_leaves(want_stats):
        for g, w, b in zip(jax.tree_util.tree_leaves(got),
                           jax.tree_util.tree_leaves(_np(want_stats)),
                           jax.tree_util.tree_leaves(js.extra["vars"]["batch_stats"])):
            np.testing.assert_allclose(g, w, atol=STAT_ATOL, rtol=0)
            assert not np.array_equal(w, b)
    th.module.load_state_dict(state_dict_from_jax(
        _np(js.params), th.module, batch_stats=_stats(js.extra["vars"]["batch_stats"])))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


@pytest.mark.parametrize("case", ["sparnet", "qsparnet"])
def test_sparnet_step_matches_jax_in_float64(case, monkeypatch):
    """The same step with both packages in float64 (flax's modules rebuilt
    with dtype float64; the port's modules widened and every
    ``Tensor.float()`` of its BatchNorm and loss made float64): every move
    within 1e-9 of its leaf's move."""
    name, kw = HANDLERS[case]
    _, js, _ = _handler_pair(case)
    batch = _spar_batch(torch_model(name)(device="cpu", **kw), np.random.default_rng(9))
    stats = js.extra["vars"]["batch_stats"]
    with jax.enable_x64(True):
        jh = jax_model(name)(**kw, **SGD)
        jh.module = jh.module.clone(dtype=jnp.float64)
        jh.dtype = jnp.float64
        jh._rejit()
        params = _f64(js.params)
        state = js.replace(params=params, opt_state=jh.tx.init(params),
                           extra={"vars": {"batch_stats": _f64(stats)}})
        js2, _ = jh.train_batch(state, {k: jnp.asarray(v, jnp.float64)
                                        for k, v in batch.items()})
        want = _np(js2.params)
    th = torch_model(name)(device="cpu", **kw, **SGD)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module,
                                                  batch_stats=_stats(stats)))
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    th.module.double()
    for m in th.module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    state = th._own_state()
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, _ = th.train_batch(state, {k: torch.from_numpy(v).double()
                                       for k, v in batch.items()})
    _assert_moves(jax_tree_from_state_dict(state2.params, th.module), before, want,
                  rel=F64_MOVE_REL, ulps=0.0)


def test_qsparnet_takes_the_40_celeba_attributes():
    _, _, th = _handler_pair("qsparnet")
    assert th.num_metadata == 40
    blocks = th.module.blocks
    assert all(b.q is not None for b in blocks)
    _, _, th2 = _handler_pair("qsparnet_encoder_only")
    assert [b.q is not None for b in th2.module.blocks] == [True] + [False] * (len(blocks) - 1)


# -- RCANSplitCeleb ----------------------------------------------------------------

def _split_pair(**opt):
    jh = jax_model("rcansplitceleb")(**SPLIT, **opt)
    js = jh.init_state()
    th = torch_model("rcansplitceleb")(device="cpu", **SPLIT, **opt)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))
    return jh, js, th


def _split_batch(rng, gate):
    n = len(gate)
    return {"lr": rng.random((n, 8, 10, 3)).astype(np.float32),
            "hr": rng.random((n, 16, 20, 3)).astype(np.float32),
            "metadata": np.asarray(gate, np.float32)[:, None]}


def test_rcansplitceleb_eval_and_mixed_step_match_jax():
    """Eval with every image on expert a, then on expert b, then one SGD
    step on a mixed batch: the per-allocation losses and every move."""
    jh, js, th = _split_pair(**SGD)
    state = th._own_state()
    rng = np.random.default_rng(10)
    for gate in ([1, 1, 1], [0, 0, 0]):
        batch = _split_batch(rng, gate)
        want = np.asarray(jh.run_eval(js, _jnp(batch)))
        np.testing.assert_allclose(th.run_eval(state, batch).numpy(), want, atol=F32_ATOL,
                                   rtol=0)
    batch = _split_batch(rng, [1, 0, 1])
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, tl = th.train_batch(state, batch)
    for k in ("train-loss", "positive-loss", "negative-loss"):
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-6, k
    _assert_moves(jax_tree_from_state_dict(state2.params, th.module), before, js2.params)


def test_rcansplitceleb_single_allocation_keeps_the_absent_expert():
    """Adam, two warm-up steps on a mixed batch (both experts' moments
    nonzero), then a batch of expert a's images only: the negative loss is
    NaN in both packages, the train loss the positive one, and expert b's
    parameters are bit for bit what they were, in both; expert a moves as
    JAX's does."""
    jh, js, th = _split_pair(lr=1e-3)
    state = th._own_state()
    rng = np.random.default_rng(11)
    mixed = _split_batch(rng, [1, 0])
    for _ in range(2):
        js, _ = jh.train_batch(js, _jnp(mixed))
        state, _ = th.train_batch(state, mixed)
    single = _split_batch(rng, [1, 1])
    b_before = jax_tree_from_state_dict(state.params, th.module)["expert_b"]
    jb_before = _np(js.params["expert_b"])
    a_before = _np(js.params["expert_a"])
    js3, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(single))
    state3, tl = th.train_batch(state, single)
    assert np.isnan(float(jl["negative-loss"])) and np.isnan(float(tl["negative-loss"]))
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    assert float(tl["train-loss"]) == float(tl["positive-loss"])
    got = jax_tree_from_state_dict(state3.params, th.module)
    for a, b in zip(jax.tree_util.tree_leaves(got["expert_b"]),
                    jax.tree_util.tree_leaves(b_before)):
        assert np.array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(_np(js3.params["expert_b"])),
                    jax.tree_util.tree_leaves(jb_before)):
        assert np.array_equal(a, b)
    # expert a moved: by Adam from moments the two packages share up to
    # rounding, within 2 % of a move of about lr
    for w, g, b in zip(jax.tree_util.tree_leaves(_np(js3.params["expert_a"])),
                       jax.tree_util.tree_leaves(got["expert_a"]),
                       jax.tree_util.tree_leaves(a_before)):
        assert np.abs(g - w).max() <= 2e-2 * 1e-3
    assert max(np.abs(w - b).max() for w, b in zip(
        jax.tree_util.tree_leaves(_np(js3.params["expert_a"])),
        jax.tree_util.tree_leaves(a_before))) > 0


# -- FaceGAN -----------------------------------------------------------------------

GAN = dict(latent_dim=8, nf=8)
D_LR = 1e-2  # a discriminator moved at lr 1 calls every fake: no gradient for G


def _dropout_keep(jd, variables, key, shape):
    """The keep mask flax's Dropout draws from ``key`` in a train-mode
    call of the discriminator (its first, as in the handler's step): the
    dropout's input replaced by ones, its output is 1 / 0.6 where kept."""
    taken = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            taken.append(np.asarray(out) != 0)
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jd.apply(variables, jnp.zeros(shape), train=True, mutable=["batch_stats"],
                 rngs={"dropout": key})
    return taken[0]


def test_facegan_step_matches_jax_with_its_draws():
    """One step with the JAX step's draws (its permutation, latents and
    dropout masks) and SGD for both networks (the JAX handler's optax
    transform for the discriminator, an Adam, swapped on the instance for
    SGD as the port's is; lr 1 for the generator, 1e-2 for the
    discriminator): the losses and
    accuracies, every move of the discriminator and of the generator, and
    the discriminator's statistics after its two train-mode calls; then the
    generated image, in [0, 1]."""
    jh = jax_model("facegan")(**GAN, **SGD)
    jh.d_tx = jax_optimizer(D_LR, "sgd")
    js = jh.init_state()
    th = torch_model("facegan")(device="cpu", **GAN, **SGD)
    th.module.load_state_dict(state_dict_from_jax(
        _np(js.params), th.module, batch_stats={"discriminator": _np(js.extra["d_bstats"])}))
    state = th._own_state()
    th._d_optimizer = torch_optimizer(th.discriminator.parameters(), D_LR, "sgd")
    n, half = 8, 4
    hr = _rand((n, 80, 80, 3), 12)
    _, zk_d, zk_g, perm_k, drop1, drop2 = jax.random.split(js.rng, 6)
    d_vars = {"params": js.params["discriminator"], "batch_stats": js.extra["d_bstats"]}
    draws = {"perm": torch.from_numpy(np.asarray(jax.random.permutation(perm_k, n))),
             "z_d": torch.from_numpy(np.asarray(jax.random.uniform(zk_d, (half, 8)))),
             "z_g": torch.from_numpy(np.asarray(jax.random.uniform(zk_g, (n, 8)))),
             "keep_real": torch.from_numpy(_dropout_keep(jh.discriminator, d_vars, drop1,
                                                         (half, 80, 80, 3))),
             "keep_fake": torch.from_numpy(_dropout_keep(jh.discriminator, d_vars, drop2,
                                                         (half, 80, 80, 3)))}
    assert 0.3 < draws["keep_real"].float().mean() < 0.9
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), {"hr": jnp.asarray(hr)})
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    tl = th.step_from_draws(state, {"hr": torch.from_numpy(hr)}, draws)
    for k in ("train-loss", "d-loss-real", "d-loss-fake"):
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5, k
    for k in ("d-acc-real", "d-acc-fake"):
        assert float(tl[k]) == float(jl[k]), k
    after = jax_tree_from_state_dict(state.params, th.module)
    for part in ("discriminator", "generator"):
        _assert_moves(after[part], before[part], js2.params[part],
                      # the strided convs' biases feed a train-mode BatchNorm
                      zero_in_exact=lambda p: part == "discriminator" and "bias" in p
                      and "TConv_0" not in p)
    stats = jax_tree_from_state_dict(state.params, th.module, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(stats["discriminator"]),
                    jax.tree_util.tree_leaves(_np(js2.extra["d_bstats"]))):
        np.testing.assert_allclose(g, w, atol=STAT_ATOL, rtol=0)
    z = _rand((2, 8), 13)
    want, _, _ = jh.apply(js2.params, {"latent": jnp.asarray(z)}, extra=js2.extra)
    got, _, _ = th.apply(state.params, {"latent": z})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=DEEP_ATOL, rtol=0)
    got = got.detach()
    assert got.shape == (2, 80, 80, 3) and 0 <= float(got.min()) <= float(got.max()) <= 1


def test_facegan_trains_from_its_own_draws():
    """``train_batch`` draws from the handler's generator: finite losses,
    accuracies in [0, 1], both networks moved, the statistics moved."""
    th = torch_model("facegan")(device="cpu", **GAN)
    state = th.init_state()
    before = {k: v.clone() for k, v in state.params.items()}
    state2, losses = th.train_batch(state, {"hr": _rand((4, 80, 80, 3), 14)})
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert 0 <= float(losses["d-acc-real"]) <= 1 and 0 <= float(losses["d-acc-fake"]) <= 1
    moved = {k.split(".")[0] for k, v in state2.params.items() if not torch.equal(v, before[k])}
    assert moved == {"generator", "discriminator"}
    assert any(not torch.equal(state2.params[k], before[k])
               for k in before if k.endswith("running_mean"))


# -- JAX-written checkpoints -------------------------------------------------------

CHECKPOINTS = {"sparnet": dict(SPAR), "qsparnet": dict(SPAR, metadata=["all"]),
               "rcansplitceleb": dict(SPLIT), "facegan": dict(GAN)}


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_jax_written_checkpoint_evaluates_in_the_port(name, tmp_path):
    """A checkpoint the JAX package wrote (SPARNet's statistics in
    extra.vars.batch_stats, FaceGAN's in extra.d_bstats) loads through
    ``load_model`` and evaluates as the JAX handler does."""
    kw = CHECKPOINTS[name]
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    jh.save_model(js, str(tmp_path / "saved_models"), epoch=0)
    th = torch_model(name)(device="cpu", **kw)
    state, epoch = th.load_model(str(tmp_path / "saved_models"), "last",
                                 skip_optimizer_load=True)
    assert epoch == 0
    rng = np.random.default_rng(15)
    if name == "facegan":
        batch = {"latent": rng.random((2, 8)).astype(np.float32)}
        want, _, _ = jh.apply(js.params, {"latent": jnp.asarray(batch["latent"])})
        got = th.run_eval(state, batch)
    else:
        side = 32 if "spar" in name else 8
        batch = {"lr": rng.random((2, side, side, 3)).astype(np.float32)}
        if name == "qsparnet":
            batch["metadata"] = rng.random((2, 40)).astype(np.float32)
        if name == "rcansplitceleb":
            batch["metadata"] = np.asarray([[1.0], [0.0]], np.float32)
        want = jh.run_eval(js, _jnp(batch))
        got = th.run_eval(state, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DEEP_ATOL, rtol=0)
