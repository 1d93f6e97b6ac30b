"""SwinIR and the basic family (SRCNN, VDSR) in the port, on the CPU,
against the JAX package (``rumpy_tpu/models/{swinir,basic}.py``): the
window plan (the roll and the partition as one gather, and the shifted
window mask), SwinIR's forward with each of its four heads at 16 x 16
(windows shifted and masked) and 13 x 19 (reflect-padded to 16 x 24), one
Adam step of a tiny SwinIR handler, a bf16 forward, flax's LayerNorm in
float32 and bf16, and SRCNN's and VDSR's
forwards and a VDSR step with its gradient clip active. Flax params come
over through the weight bridge and go back bit for bit; inputs come from a
numpy seed.

Tolerances: float32 forwards within 2e-5 of flax; an Adam first step moves
every parameter by about the learning rate, so each parameter after the
step within 1e-3 of the learning rate of JAX's, and each step's loss within
1e-6 of its value;
VDSR's SGD step at lr 1 (the moves are the clipped gradients) within 1e-4
of each leaf's largest move plus two float32 ulps; the bf16 forward within
0.05 of JAX's bf16 forward (a few bf16 roundings of values up to 1), and
a bf16 LayerNorm within 0.01 of flax's (a bf16 ulp of its outputs, up to
about 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import swinir as jswin
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import common as tcommon
from rumpy_tpu_torch.models import swinir as tswin
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_ATOL, BF16_ATOL, LOSS_REL = 2e-5, 5e-2, 1e-6
ADAM_LR, ADAM_REL, MOVE_REL, PARAM_ULPS = 1e-3, 1e-3, 1e-4, 2.0 ** -22
TINY = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=8, num_feat=8)
HEADS = ["pixelshuffle", "pixelshuffledirect", "nearest+conv", ""]


def _np(tree):
    """Copies: the JAX train step donates its state's buffers."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """flax's nn.LayerNorm (epsilon 1e-6, float32 statistics of a bf16
    input) against the port's, scale and bias off their init."""
    import flax.linen as fnn
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    x = 3 * _rand((4, 5, 7, 24), 11) - 1
    jm = fnn.LayerNorm(dtype=jdtype)
    params = {"scale": _rand((24,), 12) + 0.5, "bias": _rand((24,), 13) - 0.5}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x, jdtype)).astype(jnp.float32))
    tm = tcommon.LayerNorm(24, dtype=tdtype)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    got = tm(torch.from_numpy(x).to(tdtype))
    assert got.dtype == tdtype
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL * 0.2
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("size", [(16, 16), (16, 24)])
def test_window_plan_is_the_roll_and_partition(size, shift):
    """One gather by the plan's index gives jnp.roll then the window
    partition; the inverse gives the image back; the mask is the JAX
    block's ``_attn_mask``."""
    h, w = size
    ws = 8
    x = np.arange(h * w * 3).reshape(1, h, w, 3)
    rolled = np.roll(x, (-shift, -shift), axis=(1, 2))
    want = (rolled.reshape(1, h // ws, ws, w // ws, ws, 3).transpose(0, 1, 3, 2, 4, 5)
            .reshape(-1, ws * ws, 3))
    index, inverse, mask = tswin.window_plan(h, w, ws, shift, "cpu")
    flat = torch.from_numpy(x).reshape(1, h * w, 3)
    got = flat.index_select(1, index)
    np.testing.assert_array_equal(got.reshape(-1, ws * ws, 3).numpy(), want)
    np.testing.assert_array_equal(got.index_select(1, inverse).numpy(), flat.numpy())
    if shift:
        block = jswin.SwinBlock(16, 2, window_size=ws, shift=shift)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(block._attn_mask(h, w)))
    else:
        assert mask is None


@pytest.mark.parametrize("size", [(16, 16), (13, 19)])
@pytest.mark.parametrize("upsampler", HEADS)
def test_swinir_forward_matches_flax(upsampler, size):
    """Every parameter moved off its init (LayerNorm scales, the bias
    table), so that each leaf's mapping shows; the bridge gives the flax
    tree back bit for bit."""
    scale = 4 if upsampler == "nearest+conv" else 2
    jm = jswin.SwinIR(scale=scale, upsampler=upsampler, **TINY)
    x = _rand((2, *size, 3), 1)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tswin.SwinIR(scale=scale, upsampler=upsampler, **TINY)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert _leaves_equal(jax_tree_from_state_dict(tm.state_dict(), tm), params)


def _handler_pair(name, **kw):
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th = torch_model(name)(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))
    return jh, js, th


def test_swinir_adam_step_matches_jax():
    kw = dict(scale=2, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8, num_feat=8,
              lr=ADAM_LR)
    jh, js, th = _handler_pair("swinir", **kw)
    rng = np.random.default_rng(3)
    batch = {"lr": rng.random((2, 16, 16, 3)).astype(np.float32),
             "hr": rng.random((2, 32, 32, 3)).astype(np.float32)}
    before = _np(js.params)
    js2, jl = jh.train_batch(js, {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= LOSS_REL * float(jl["train-loss"])
    got = jax_tree_from_state_dict(state2.params, th.module)
    moved = 0
    for g, w, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(js2.params)),
                       jax.tree_util.tree_leaves(before)):
        assert np.abs(g - w).max() <= ADAM_REL * ADAM_LR
        moved += int(np.abs(w - b).max() > 0.5 * ADAM_LR)
    assert moved == len(jax.tree_util.tree_leaves(before))


def test_swinir_bf16_forward_follows_jax():
    """dtype bf16: the convs, Dense layers and logits in bf16, the softmax
    and the product with the values in float32 after the float32 bias
    table is added, as XLA promotes them."""
    kw = dict(scale=2, dtype="bf16", **TINY)
    jh, js, th = _handler_pair("swinir", **kw)
    x = _rand((1, 13, 19, 3), 4)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}), np.float32)
    got = th.run_eval(th._own_state(), {"lr": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 26, 38, 3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["srcnn", "vdsr"])
def test_basic_handlers_match_jax(name):
    """Their defaults (SRCNN 9-5-5 with 64 and 32 features, VDSR 20 3 x 3
    convs of 64 and the global residual) on an interpolated Y channel; the
    handlers' data contract and loss."""
    jh, js, th = _handler_pair(name, scale=2)
    x = _rand((2, 20, 24, 1), 5)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = th.run_eval(th._own_state(), {"lr": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert (th.im_input, th.colorspace, th.loss_type, th.in_features) == (
        jh.im_input, jh.colorspace, jh.loss_type, jh.in_features) == ("interp", "ycbcr", "mse", 1)
    assert th.grad_clip == (0.1 if name == "vdsr" else None)


def test_vdsr_step_clips_as_jax():
    """One SGD step at lr 1 towards targets 4 above the inputs: the
    gradients' global norm is far above 0.1, so both packages scale them to
    0.1 before the step."""
    jh, js, th = _handler_pair("vdsr", scale=2, optimizer_type="sgd", lr=1.0)
    rng = np.random.default_rng(6)
    batch = {"lr": rng.random((2, 20, 24, 1)).astype(np.float32),
             "hr": 4 + rng.random((2, 20, 24, 1)).astype(np.float32)}
    before = _np(js.params)
    js2, jl = jh.train_batch(js, {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= LOSS_REL * float(jl["train-loss"])
    got = jax_tree_from_state_dict(state2.params, th.module)
    want = _np(js2.params)
    moves = [w - b for w, b in zip(jax.tree_util.tree_leaves(want),
                                   jax.tree_util.tree_leaves(before))]
    norm = np.sqrt(sum(float((m.astype(np.float64) ** 2).sum()) for m in moves))
    assert abs(norm - 0.1) <= 1e-5  # the clip was active
    for g, w, m in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), moves):
        assert np.abs(g - w).max() <= MOVE_REL * np.abs(m).max() + PARAM_ULPS
