"""The port's RCAN and EDSR (rumpy_tpu_torch.models.advanced) against the
JAX package's, with flax params carried over by the weight bridge, on the
CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models.advanced import RCAN
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import state_dict_from_jax

# 11 blocks a group, so the bridge must tell RCAB_10 from RCAB_2
RCAN_KW = dict(n_feats=64, n_resgroups=2, n_resblocks=11)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _shaped_tree(module):
    """A flax module's param tree with its real names and shapes, filled
    with random values (abstract init: no flax compute)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


_JAX = {}


def _jax_handler(name, scale, **kw):
    """JAX handler and its eagerly initialised state, made once per
    configuration (flax's eager init of a 22-block RCAN takes seconds)."""
    key = (name, scale, tuple(sorted(kw.items())))
    if key not in _JAX:
        jh = jax_model(name)(scale=scale, **kw)
        _JAX[key] = jh, jh.init_state()
    return _JAX[key]


def _compare(name, scale, kw, atol=1e-4):
    jh, js = _jax_handler(name, scale, **kw)
    th = torch_model(name)(scale=scale, device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np_tree(js.params),
                                                          th.module))
    x = np.random.default_rng(scale).random((2, 10, 9, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = th.run_eval(state, {"lr": x}).numpy()
    assert got.shape == want.shape == (2, 10 * scale, 9 * scale, 3)
    np.testing.assert_allclose(got, want, atol=atol)
    return jh, js, th


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_rcan_matches_jax(scale):
    torch.set_num_threads(2)
    _compare("rcan", scale, RCAN_KW)


@pytest.mark.parametrize("scale", [2, 4])
def test_edsr_matches_jax(scale):
    _compare("edsr", scale, dict(num_features=64, num_blocks=3))


def test_rcan_bf16_matches_jax_bf16():
    """bf16 RCAN x4, flax init bridged. The port rounds to bf16 where its
    RCAB kernel does (h1 and the block's output; h2, the gate and the add in
    f32), flax after every op, so the two differ by bf16 rounding: on this
    input max 1.95e-3, mean 2.9e-4 on the CPU. Allowed: about twice that."""
    kw = dict(n_feats=64, n_resgroups=2, n_resblocks=5, dtype="bf16")
    jh, js = _jax_handler("rcan", 4, **kw)
    th = torch_model("rcan")(scale=4, device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np_tree(js.params), th.module))
    x = np.random.default_rng(4).random((2, 24, 20, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)})).astype(np.float32)
    got = th.run_eval(state, {"lr": x})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 96, 80, 3)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 4e-3 and err.mean() <= 5e-4, (err.max(), err.mean())


def test_bridge_takes_sorted_and_remat_trees():
    _, js = _jax_handler("rcan", 2, **RCAN_KW)
    th = torch_model("rcan")(scale=2, device="cpu", **RCAN_KW)
    eager = state_dict_from_jax(_np_tree(js.params), th.module)
    # a tree that crossed jax.jit comes back key-sorted
    jitted = jax.jit(lambda p: p)(js.params)
    assert list(jitted["ResidualGroup_0"])[:3] == ["Conv_0", "RCAB_0", "RCAB_1"]
    assert list(jitted["ResidualGroup_0"]).index("RCAB_10") < \
        list(jitted["ResidualGroup_0"]).index("RCAB_2")
    sorted_sd = state_dict_from_jax(_np_tree(jitted), th.module)
    assert sorted_sd.keys() == eager.keys()
    for k in eager:
        torch.testing.assert_close(sorted_sd[k], eager[k], rtol=0, atol=0)
    # RCAB_10 of group 0 lands on blocks.10, not blocks.2
    want = np.asarray(js.params["ResidualGroup_0"]["RCAB_10"]["Conv_0"]
                      ["TConv_0"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(eager["groups.0.blocks.10.conv1.weight"].numpy(), want)
    # nn.remat renames the groups
    kw = dict(n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4)
    remat = _shaped_tree(RCAN(scale=2, remat=True, **kw))
    assert "CheckpointResidualGroup_1" in remat
    small = torch_model("rcan")(scale=2, device="cpu", **kw)
    remat_sd = state_dict_from_jax(remat, small.module)
    assert remat_sd.keys() == small.module.state_dict().keys()


def test_bridge_raises_on_missing_unused_and_mismatched_leaves():
    kw = dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4)
    th = torch_model("rcan")(scale=2, device="cpu", **kw)
    params = _shaped_tree(RCAN(scale=2, **kw))
    state_dict_from_jax(params, th.module)  # the whole tree maps

    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["ResidualGroup_0"]["RCAB_1"]["CALayer_0"]["TConv_1"]["bias"]
    with pytest.raises(KeyError, match="RCAB_1/CALayer_0/TConv_1/bias"):
        state_dict_from_jax(missing, th.module)

    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["Conv_9"] = {"TConv_0": {"kernel": np.zeros((3, 3, 16, 16))}}
    with pytest.raises(ValueError, match="not used"):
        state_dict_from_jax(extra, th.module)

    small = torch_model("rcan")(scale=2, device="cpu", n_feats=8, n_resgroups=1,
                                n_resblocks=2, reduction=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        state_dict_from_jax(params, small.module)


@pytest.mark.parametrize("scale", [2, 3])
def test_pixel_shuffle_and_mean_shift_match_jax(scale):
    """Depth-to-space ordering (and its inverse) and the RGB mean shift, on
    NHWC arrays through the JAX functions and NCHW tensors in the port."""
    from rumpy_tpu.models import common as jcommon
    from rumpy_tpu_torch.models import common as tcommon
    x = np.random.default_rng(scale).standard_normal(
        (2, 5, 4, 3 * scale * scale)).astype(np.float32)
    want = np.asarray(jcommon.pixel_shuffle(jnp.asarray(x), scale))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tcommon.pixel_shuffle(xt, scale).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    back = tcommon.pixel_unshuffle(torch.from_numpy(want.copy()).permute(0, 3, 1, 2), scale)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), x)
    rgb = x[..., :3]
    for sign in (-1, 1):
        want = np.asarray(jcommon.MeanShift(sign=sign, rgb_range=255.0).apply(
            {}, jnp.asarray(rgb)))
        got = tcommon.MeanShift(sign=sign, rgb_range=255.0)(
            torch.from_numpy(rgb).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
