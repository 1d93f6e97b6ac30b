"""Metabed in the port, on the CPU, against the JAX package
(``rumpy_tpu/models/metabed.py`` and the metadata layers of
``attention_manipulators.py``): the multi-pipe and split-pipe q-layers and
the DGFMB layer, forward and gradients; Metabed's forward with each of its
six meta types (and with selective blocks); the metadata autoencoder's
train steps on both sides of ``encoder_pretrain_epochs`` (the scaled AE
loss, then the frozen decoder); ``metabedesrgan``'s pre-train and
adversarial steps; and ``contrastiveblindmetabed`` behind the frozen
encoder.

Flax params are carried over by the weight bridge (biases jittered off
zero), inputs come from a numpy seed. Tolerances: f32 outputs within 1e-5
of the largest output entry, gradients within 1e-4 of each gradient's
largest entry, a train step under SGD at lr 1 (a parameter moves by its
gradient) within 1e-4 of each leaf's move plus two float32 ulps, losses
within 1e-5 of their value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import attention_manipulators as jam
from rumpy_tpu.models import metabed as jmb
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import attention_manipulators as tam
from rumpy_tpu_torch.models import metabed as tmb
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.precision import float64
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, F32_GRAD_REL, F64_REL = 1e-5, 1e-4, 1e-9
PARAM_ULPS = 2.0 ** -22
SGD = dict(optimizer_type="sgd", lr=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        _np(tree))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _close(got, want, rel=F32_REL):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _assert_moves(module, params_after, before, want_after):
    after = jax_tree_from_state_dict(params_after, module)
    largest = 0.0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(want_after))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        largest = max(largest, move)
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)
    assert largest > 0


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= F32_REL * max(abs(w), 1e-6), (k, float(got[k]), w)


# -- metadata layers ---------------------------------------------------------------

LAYERS = {
    "respipes-concat": (jam.ResPipesCALayer, tam.ResPipesCALayer,
                        dict(network_channels=16, num_metadata=5)),
    "respipes-add": (jam.ResPipesCALayer, tam.ResPipesCALayer,
                     dict(network_channels=16, num_metadata=5, combine_pipes="add",
                          num_pipes=2)),
    "respipes-listed": (jam.ResPipesCALayer, tam.ResPipesCALayer,
                        dict(network_channels=16, num_metadata=20, num_layers=[1, 3, 2],
                             nonlinearity=False)),
    "split": (jam.ResPipesSplitCALayer, tam.ResPipesSplitCALayer,
              dict(network_channels=16, num_metadata=5)),
    "split-third": (jam.ResPipesSplitCALayer, tam.ResPipesSplitCALayer,
                    dict(network_channels=18, num_metadata=7, split_percent=0.3, num_pipes=2)),
    "dgfmb": (jam.DGFMBLayer, tam.DGFMBLayer, dict(num_channels=16, degradation_full_dim=5)),
    "dgfmb-full": (jam.DGFMBLayer, tam.DGFMBLayer,
                   dict(num_channels=16, degradation_full_dim=5, use_reduction=False,
                        num_layers=[12])),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_metadata_layers_match_flax(case):
    """The pipe sizing (``int`` of equal steps), the split slicing, the
    pipes' combination and DGFMB's pooled concat: the output, the input's
    and the metadata's gradients and the parameters'."""
    jcls, tcls, kw = LAYERS[case]
    channels = kw.get("network_channels", kw.get("num_channels"))
    m = kw.get("num_metadata", kw.get("degradation_full_dim"))
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, 5, 6, channels)).astype(np.float32)
    meta = rng.random((2, m)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jm = jcls(**kw)
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(meta))["params"],
                     len(case))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(meta)))
    gp, gx, gm = jax.grad(lambda p, a, b: jnp.sum(jm.apply({"params": p}, a, b) * cot),
                          argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(meta))
    tm = tcls(**kw)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    xt = _nchw(x).requires_grad_(True)
    mt = torch.from_numpy(meta).requires_grad_(True)
    out = tm(xt, mt)
    _close(_nhwc(out), want)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    pairs = [(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)), (mt.grad.numpy(), np.asarray(gm))]
    grads = jax_tree_from_state_dict({k: p.grad for k, p in tm.named_parameters()}, tm)
    pairs += list(zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(_np(gp))))
    for got, w in pairs:
        assert np.abs(got - w).max() <= F32_GRAD_REL * np.abs(w).max()


# -- Metabed -----------------------------------------------------------------------

@pytest.mark.parametrize("meta_type", list(tmb.META_TYPES))
def test_metabed_forward_matches_jax(meta_type):
    """Metabed x2 with the meta layer in blocks 0 and 2 of 3 (block 1
    plain): the output, and the bridge back to flax's tree."""
    kw = dict(scale=2, num_features=16, num_blocks=3, input_para=5, meta_block=meta_type,
              selective_meta_blocks=(True, False, True))
    jm = jmb.Metabed(**kw)
    rng = np.random.default_rng(len(meta_type))
    x = rng.random((2, 6, 7, 3)).astype(np.float32)
    meta = rng.random((2, 5)).astype(np.float32)
    params = _jitter(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(meta))["params"],
                     3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(meta)))
    tm = tmb.Metabed(**kw)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(meta)))
    assert got.shape == (2, 12, 14, 3)
    _close(got, want)
    back = jax_tree_from_state_dict(tm.state_dict(), tm)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)


AE = dict(scale=2, num_features=16, num_blocks=2, meta_block="q-layer", use_encoder=True,
          encoder_pretrain_epochs=1, num_bottleneck_nodes=6, metadata=["a", "b", "c"],
          freeze_encoder_after_pretrain=True, **SGD)


@pytest.mark.parametrize("epoch", [0, 1])
def test_metabed_autoencoder_phases_match_jax(epoch):
    """With the metadata autoencoder: epoch 0 trains it beside the SR loss
    (``train-loss = l1 + 5 * l1-loss-ae``), epoch 1 drops its loss and
    freezes encoder and decoder (their parameters do not move); one step
    each, losses and every parameter."""
    jh = jax_model("metabed")(**AE)
    js = jh.init_state()
    params = _jitter(js.params, 4)
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    th = torch_model("metabed")(device="cpu", **AE)
    th.module.load_state_dict(state_dict_from_jax(params, th.module))
    jh.set_epoch(epoch)
    th.set_epoch(epoch)
    rng = np.random.default_rng(5 + epoch)
    batch = {"lr": rng.random((2, 6, 6, 3)).astype(np.float32),
             "hr": rng.random((2, 12, 12, 3)).astype(np.float32),
             "metadata": rng.random((2, 3)).astype(np.float32)}
    state = th._own_state()
    _close(th.run_eval(state, batch).numpy(),
           jh.run_eval(js, {k: jnp.asarray(v) for k, v in batch.items()}))
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(state, batch)
    _assert_losses(tl, jl)
    assert (float(tl["scaled-l1-loss-ae"]) > 0) == (epoch == 0)
    after = jax_tree_from_state_dict(state2.params, th.module)
    for part in ("meta_enc", "meta_dec"):
        moved = [not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(after[part]), jax.tree_util.tree_leaves(before[part]))]
        assert all(moved) if epoch == 0 else not any(moved), part
    _assert_moves(th.module, state2.params, before, js2.params)


ESRGAN_MB = dict(scale=4, num_features=16, num_blocks=2, meta_block="q-layer", d_nf=4,
                 pretrain_epochs=1, main_lr=1.0, d_lr=1.0, **SGD)


def _f64_pretrain_moves(js, th, batch):
    """The pre-train step in float64 in both packages from the same state:
    the JAX handler's modules rebuilt with dtype float64 (flax casts params
    and inputs to it), the port's handler widened by
    ``utils.precision.float64``. Returns the generator's params before the
    step and after each package's step, in flax's tree."""
    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
    with jax.enable_x64(True):
        jh = jax_model("metabedesrgan")(**ESRGAN_MB)
        jh.set_epoch(0)
        jh.dtype = jnp.float64
        jh.module = jh.build_module(**jh.model_kwargs)
        params = f64(_np(js.params))
        state = jax.tree_util.tree_map(jnp.copy, js).replace(
            params=params,
            opt_state={**js.opt_state, "generator_pre": jh.tx.init(params["generator"])})
        out, _ = jh.train_batch(state, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        want = _np(out.params["generator"])
    th.set_epoch(0)
    with float64(th) as state:
        th._optimizers = {}
        before = jax.tree_util.tree_map(
            np.copy, jax_tree_from_state_dict(state.params, th.module)["generator"])
        state2, _ = th.train_batch(state, {k: torch.from_numpy(v).double()
                                           for k, v in batch.items()})
        got = jax_tree_from_state_dict(state2.params, th.module)["generator"]
    return before, got, want


def test_metabedesrgan_steps_match_jax():
    """Metabed under the ESRGAN recipe (relativistic, VGG-128; LR 32 for
    its 128 x 128 crops): the pre-train step (losses, then the generator's
    update in float64 in both packages, each leaf within 1e-9 of its move:
    the tail conv's bias gradient sums 2 x 128 x 128 terms, which float32
    summed in order on one thread put 1.1 times 1e-4 of its move off JAX's
    float32 step, at torch's threaded order within it), then the adversarial
    step's losses and the discriminator's BatchNorm statistics (the
    relativistic updates through VGG-128 are held in float64 in
    tests/test_torch_gan_handler.py)."""
    jh = jax_model("metabedesrgan")(**ESRGAN_MB)
    js = jh.init_state()
    params = _jitter(js.params, 6)
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    stats = _np(js.extra["d_vars"]["batch_stats"])
    th = torch_model("metabedesrgan")(device="cpu", **ESRGAN_MB)
    th.module.load_state_dict(state_dict_from_jax(params, th.module,
                                                  batch_stats={"discriminator": stats}))
    rng = np.random.default_rng(7)
    batch = {"lr": rng.random((2, 32, 32, 3)).astype(np.float32),
             "hr": rng.random((2, 128, 128, 3)).astype(np.float32),
             "metadata": rng.random((2, 1)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = th._own_state()
    jh.set_epoch(0)
    th.set_epoch(0)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), jb)
    _, tl = th.train_batch(state, batch)
    _assert_losses(tl, jl)
    # the update in float64, from the same state in a handler of its own
    th64 = torch_model("metabedesrgan")(device="cpu", **ESRGAN_MB)
    th64.module.load_state_dict(state_dict_from_jax(params, th64.module,
                                                    batch_stats={"discriminator": stats}))
    start, got, want = _f64_pretrain_moves(js, th64, batch)
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                               jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(start)):
        assert np.abs(g - w).max() <= F64_REL * np.abs(w - b).max(), jax.tree_util.keystr(path)
    assert max(np.abs(w - b).max() for w, b in zip(
        jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(start))) > 0
    # the adversarial step from JAX's state after pre-training
    th.module.load_state_dict(state_dict_from_jax(
        _np(js2.params), th.module,
        batch_stats={"discriminator": _np(js2.extra["d_vars"]["batch_stats"])}))
    jh.set_epoch(1)
    th.set_epoch(1)
    js3, jl = jh.train_batch(js2, jb)
    state3, tl = th.train_batch(th._own_state(), batch)
    _assert_losses(tl, jl)
    got = jax_tree_from_state_dict(state3.params, th.module, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(got["discriminator"]),
                    jax.tree_util.tree_leaves(_np(js3.extra["d_vars"]["batch_stats"]))):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


BOBW_MB = dict(scale=2, num_features=16, num_blocks=3, **SGD)


def test_contrastiveblindmetabed_matches_jax():
    """Metabed behind the frozen DASR encoder, with its ``front_only``
    default (the q-layer in block 0 alone): the eval forward and one L1
    step (the generator's update, the encoder's batch statistics)."""
    jh = jax_model("contrastiveblindmetabed")(**BOBW_MB)
    js = jh.init_state()
    params = _jitter(js.params, 8)
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    th = torch_model("contrastiveblindmetabed")(device="cpu", **BOBW_MB)
    assert [b.meta is not None for b in th.module.generator.blocks] == [True, False, False]
    full = {**params, "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    state = th._own_state()
    rng = np.random.default_rng(9)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    _close(th.run_eval(state, {"lr": x}).numpy(), jh.run_eval(js, {"lr": jnp.asarray(x)}))
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    before = jax.tree_util.tree_map(
        np.copy, jax_tree_from_state_dict(state.params, th.module)["generator"])
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    _assert_moves(th.module.generator,
                  {k[len("generator."):]: v for k, v in state2.params.items()
                   if k.startswith("generator.")}, before, js2.params["generator"])
    stats = jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(_np(js2.extra["bstats"]))):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_frozen_decoder_moves_under_adam_in_both():
    """Found in both packages: after ``encoder_pretrain_epochs`` the decoder
    is frozen by detaching it, so its gradients are zero, yet Adam moves it
    on the moments of the pre-training steps (optax updates every leaf; the
    port gives a parameter without gradient a zero one)."""
    kw = dict(AE, optimizer_type="adam", lr=1e-2)
    jh = jax_model("metabed")(**kw)
    js = jh.init_state()
    th = torch_model("metabed")(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))
    rng = np.random.default_rng(10)
    batch = {"lr": rng.random((2, 6, 6, 3)).astype(np.float32),
             "hr": rng.random((2, 12, 12, 3)).astype(np.float32),
             "metadata": rng.random((2, 3)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = th._own_state()
    for epoch in (0, 1):
        jh.set_epoch(epoch)
        th.set_epoch(epoch)
        before_j = _np(js.params["meta_dec"])
        before_t = jax.tree_util.tree_map(
            np.copy, jax_tree_from_state_dict(state.params, th.module)["meta_dec"])
        js, _ = jh.train_batch(js, jb)
        state, _ = th.train_batch(state, batch)
    after_t = jax_tree_from_state_dict(state.params, th.module)["meta_dec"]
    for bj, aj, bt, at in zip(*(jax.tree_util.tree_leaves(t) for t in (
            before_j, _np(js.params["meta_dec"]), before_t, after_t))):
        assert not np.array_equal(bj, aj) and not np.array_equal(bt, at)
        np.testing.assert_allclose(at - bt, aj - bj, atol=1e-6, rtol=1e-3)
