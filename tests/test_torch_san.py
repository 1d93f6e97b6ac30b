"""SAN and QSAN in the port, and ``forward_chop``, on the CPU, against the
JAX package (``rumpy_tpu/models/san.py``, ``rumpy_tpu/ops/tiling.py``):
the covariance square root, SOCA and the non-local block (quadrants of
even and odd sizes) forward and gradients; ``forward_chop`` bit for bit
given the same per-tile forward, on forced splits of odd sizes (the clamp
of a tile to the image included) and on a recursive chop; the handlers'
always-chopped ``run_eval`` and one train step, whose gradients sum over
the eight uses of the one shared non-local block; bf16 evaluation; and
``contrastiveblindqsan``'s forward and step, ``srmd_mode`` and
``sft_mode``. Flax params carried over by the weight bridge, inputs from a
numpy seed, SAN's ``gamma`` (zero at init) set to 0.5 in both packages.

Tolerances: f32 outputs within 1e-5 of flax (the covariance root within
1e-5 of its largest entry), gradients within 1e-4 of each gradient's
largest entry (of all gradients' largest for the non-local block's phi
bias, whose exact gradient is zero), a train step under SGD at lr 1 within 1e-6 on the loss and
1e-4 of each parameter's move plus two float32 ulps; bf16 within 2**-6 of
the largest output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import san as jsan
from rumpy_tpu.ops.tiling import forward_chop as jax_chop
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import san as tsan
from rumpy_tpu_torch.ops.tiling import forward_chop
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22
GAMMA = 0.5
SGD = dict(optimizer_type="sgd", lr=1.0)
HANDLERS = {"san": dict(scale=2, n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4),
            "qsan": dict(scale=2, metadata=["qpi"], n_feats=16, n_resgroups=2, n_resblocks=2,
                         reduction=4)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gammas(tree, value=GAMMA):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.full_like(np.asarray(a), value)
                      if jax.tree_util.keystr(p).endswith("['gamma']") else np.asarray(a)), tree)


def _jitter(tree, rng):
    """Biases off zero, so that each reaches the output."""
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _grad_pairs(tm, gp):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tm.named_parameters()}
    got = dict(jax.tree_util.tree_flatten_with_path(jax_tree_from_state_dict(grads, tm))[0])
    want = jax.tree_util.tree_flatten_with_path(_np(gp))[0]
    assert len(want) == len(got)
    return [(jax.tree_util.keystr(k), got[k], v) for k, v in want]


# phi's bias adds one constant to a row of the non-local block's logits,
# which its softmax takes away: its exact gradient is zero
ZERO_IN_EXACT = "['TConv_3']['bias']"


def _assert_grads(pairs):
    """Each gradient within 1e-4 of its largest entry; phi's bias, whose
    entries are rounding noise, within 1e-4 of the largest entry of all."""
    top = max(np.abs(want).max() for _, _, want in pairs)
    for name, got, want in pairs:
        scale = top if name.endswith(ZERO_IN_EXACT) else max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= F32_GRAD_REL * scale, name


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _block_case(jm, tm, x, seed):
    """Forward and gradients (input's and every parameter's) of a flax
    block and its port on NHWC ``x``."""
    rng = np.random.default_rng(seed)
    params = _jitter(_np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]), rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, v: jnp.sum(jm.apply({"params": p}, v) * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))
    tm.load_state_dict(state_dict_from_jax(params, tm))
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt)
    np.testing.assert_allclose(_nhwc(out), want, atol=F32_ATOL, rtol=0)
    (out * _nchw(cot)).sum().backward()
    _assert_grads([("x", _nhwc(xt.grad), np.asarray(gx))] + _grad_pairs(tm, gp))


def test_cov_sqrt_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 45, 12)).astype(np.float32)
    want = np.asarray(jsan._cov_sqrt(jnp.asarray(x)))
    got = tsan.cov_sqrt(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_soca_matches_flax():
    x = np.random.default_rng(1).standard_normal((2, 6, 7, 16)).astype(np.float32)
    _block_case(jsan.SOCA(16, 4), tsan.SOCA(16, 4), x, 1)


@pytest.mark.parametrize("shape", [(2, 8, 10, 16), (2, 7, 9, 16)], ids=["even", "odd"])
def test_nonlocal_block_matches_flax(shape):
    """g and phi max-pooled at stride 2 whatever the flag (odd sizes floor)."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _block_case(jsan.NonLocalBlock2D(16, 2), tsan.NonLocalBlock2D(16, 2), x, 2)


@pytest.mark.parametrize("shape", [(2, 12, 10, 16), (1, 13, 11, 16)], ids=["even", "odd"])
def test_nonlocal_ca_runs_one_shared_block(shape):
    """NonlocalCA's four quadrants run one block (one batched call when they
    share a shape): one set of parameters whose gradients sum over them."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    tm = tsan.NonlocalCA(16, 2)
    assert sum(1 for _ in tm.modules() if isinstance(_, tsan.NonLocalBlock2D)) == 1
    _block_case(jsan.NonlocalCA(16, 2), tm, x, 3)


CHOP_CASES = {"forced-odd": ((1, 23, 17, 3), 160000, True),
              "forced-clamped": ((2, 5, 3, 3), 160000, True),
              "recursive": ((1, 61, 47, 3), 300, False),
              "forced-recursive": ((1, 45, 53, 3), 300, True)}


@pytest.mark.parametrize("case", list(CHOP_CASES))
def test_forward_chop_matches_jax_bit_for_bit(case):
    """The same per-tile forward in both (a nearest x2 upscale plus the
    tile's call index and shape, exact in float32): the stitched outputs
    agree bit for bit, so each quadrant's valid region lands where the JAX
    function puts it."""
    shape, max_size, force = CHOP_CASES[case]
    x = np.random.default_rng(4).integers(0, 100, shape).astype(np.float32)
    calls = {"jax": [], "torch": []}

    def tile_value(kind, t):
        calls[kind].append(tuple(t.shape))
        return 100000.0 * len(calls[kind]) + 1000.0 * t.shape[1] + t.shape[2]

    def jax_forward(t):
        return jnp.repeat(jnp.repeat(t, 2, 1), 2, 2) + tile_value("jax", t)

    def torch_forward(t):
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2) + tile_value("torch", t)

    want = np.asarray(jax_chop(jax_forward, jnp.asarray(x), 2, max_size=max_size,
                               force_split=force))
    got = forward_chop(torch_forward, torch.from_numpy(x), 2, max_size=max_size,
                       force_split=force).numpy()
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) >= 4
    np.testing.assert_array_equal(got, want)


# -- handlers ------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _handler_pair(name, dtype="float32", max_combined_im_size=160000):
    kw = dict(HANDLERS[name], dtype=dtype, max_combined_im_size=max_combined_im_size, **SGD)
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, _gammas(_np(js.params))))
    th = torch_model(name)(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))
    return jh, js, th


def _batch(name, rng, h, w, n=2):
    b = {"lr": rng.random((n, h, w, 3)).astype(np.float32),
         "hr": rng.random((n, 2 * h, 2 * w, 3)).astype(np.float32)}
    if name == "qsan":
        b["metadata"] = rng.random((n, 1)).astype(np.float32)
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


EVAL_CASES = {"san-forced": ("san", 160000, (23, 17)), "qsan-forced": ("qsan", 160000, (23, 17)),
              "san-recursive": ("san", 150, (26, 19))}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_chopped_run_eval_matches_jax(case, monkeypatch):
    """run_eval goes through forward_chop alone (force_split, the handler's
    max size), QSAN's metadata into every tile, and gives the JAX output."""
    name, max_size, (h, w) = EVAL_CASES[case]
    jh, js, th = _handler_pair(name, max_combined_im_size=max_size)
    batch = _batch(name, np.random.default_rng(5), h, w)
    chops = []
    real = tsan.forward_chop

    def counted(forward, x, scale, **kw):
        chops.append(kw)
        return real(forward, x, scale, **kw)

    monkeypatch.setattr(tsan, "forward_chop", counted)
    got = th.run_eval(th._own_state(), batch).numpy()
    assert chops == [{"max_size": max_size, "force_split": True}]
    want = np.asarray(jh.run_eval(js, _jnp(batch)))
    assert got.shape == (2, 2 * h, 2 * w, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(HANDLERS))
def test_train_step_matches_jax(name):
    """One step: the loss and each parameter's move, gamma's and the shared
    non-local block's (its gradient summed over two NonlocalCA calls of
    four quadrants each) among them."""
    jh, js, th = _handler_pair(name)
    state = th._own_state()
    batch = _batch(name, np.random.default_rng(6), 10, 12)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, tl = th.train_batch(state, batch)
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)
    moved = {}
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(js2.params))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        moved[jax.tree_util.keystr(path)] = move
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)
    assert moved["['gamma']"] > 0
    assert moved["['NonlocalCA_0']['NonLocalBlock2D_0']['TConv_0']['kernel']"] > 0
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))


def test_bf16_eval_matches_jax_bf16():
    jh, js, th = _handler_pair("san", "bf16")
    batch = _batch("san", np.random.default_rng(7), 12, 14)
    want = np.asarray(jh.run_eval(js, _jnp(batch)), np.float32)
    got = th.run_eval(th._own_state(), batch).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# -- BoBW --------------------------------------------------------------------------

BOBW = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=1, reduction=4, **SGD)


def _bobw_pair(**kw):
    jh = jax_model("contrastiveblindqsan")(**BOBW, **kw)
    js = jh.init_state()
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, _gammas(_np(js.params))))
    th = torch_model("contrastiveblindqsan")(device="cpu", **BOBW, **kw)
    full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    return jh, js, th


def test_bobw_qsan_matches_jax():
    """contrastiveblindqsan's eval forward (no tiling: the BoBW handler's
    own) and one train step."""
    jh, js, th = _bobw_pair()
    state = th._own_state()
    rng = np.random.default_rng(8)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(state, {"lr": x}).numpy(), want, atol=F32_ATOL,
                               rtol=0)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    before = jax.tree_util.tree_map(
        np.copy, jax_tree_from_state_dict(state.params, th.module)["generator"])
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)["generator"]
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(js2.params["generator"]))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)


def test_bobw_qsan_modes_as_in_jax():
    """srmd_mode feeds SAN 3 + 256 channels, which it takes in both
    packages; sft_mode hands SAN the maps as a third argument it does not
    have: a TypeError in both."""
    jh, js, th = _bobw_pair(srmd_mode=True)
    assert th.module.generator.head.weight.shape[1] == 3 + 256
    x = np.random.default_rng(9).random((1, 8, 10, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(th._own_state(), {"lr": x}).numpy(), want,
                               atol=F32_ATOL, rtol=0)
    with pytest.raises(TypeError, match="positional argument"):
        jax_model("contrastiveblindqsan")(**BOBW, sft_mode=True).init_state()
    th = torch_model("contrastiveblindqsan")(device="cpu", **BOBW, sft_mode=True)
    with pytest.raises(TypeError, match="positional argument"):
        th.run_eval(th.init_state(), {"lr": x})
