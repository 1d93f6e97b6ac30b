"""The GAN group in the port, on the CPU, against the JAX package
(``rumpy_tpu/models/gan_models.py``, ``feature_extractors.py``, the GAN
conjugations of ``dan.py`` and ``blind_sr.py``): RRDBNet and QRRDBNet at
scales 4, 2 and 1; flax's spectral norm (outputs, ``u`` and ``sigma`` after
one and three train calls, eval calls that leave them); the VGG-128
discriminator with BatchNorm in train mode; the VGG-19 taps and
``PerceptualMechanism`` at seeded npz weights, and both packages refusing to
build them without weights; ``danv1qrealesrgan`` and
``contrastiveblindqrealesrgan`` steps; a JAX-written GAN checkpoint scored
in the port; and a tiny ``realesrgan`` through both CLIs with a resume bit
for bit. The handler's steps are in ``test_torch_gan_handler.py``, which
takes this file's helpers.

Flax params are carried over by the weight bridge (biases jittered off
zero), inputs come from a numpy seed. Tolerances: f32 outputs within 1e-5 of
the largest output entry (RRDBNet's trunk sums 23 x 15 convs here in
another order); spectral-norm ``u`` within 1e-6 and ``sigma`` within 1e-6 of
its value; a train step under SGD at lr 1 (a parameter moves by its
gradient) within 1e-4 of each leaf's largest move plus two float32 ulps,
losses within 1e-5 of their value, BatchNorm statistics within 1e-6.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import feature_extractors as jfe
from rumpy_tpu.models import gan_models as jgan
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.utils import losses as jlosses
from rumpy_tpu_torch.models import feature_extractors as tfe
from rumpy_tpu_torch.models import gan_models as tgan
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils import losses as tlosses
from rumpy_tpu_torch.utils.weights import (jax_tree_from_state_dict, model_constants_from_jax,
                                           state_dict_from_jax)
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, F32_GRAD_REL, STAT_TOL = 1e-5, 1e-4, 1e-6
PARAM_ULPS = 2.0 ** -22
SGD = dict(optimizer_type="sgd", lr=1.0)
SMALL = dict(nf=16, nb=2, gc=8, d_nf=4)


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


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= F32_REL * max(abs(w), 1e-6), (k, float(got[k]), w)


def _assert_gan_step(jh, js, th, batch, moves=True):
    """One adversarial step in both packages: the losses, both networks'
    updates (unless ``moves`` is False) and the discriminator's state."""
    state = th._own_state()
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    state2, tl = th.train_batch(state, batch)
    _assert_losses(tl, jl)
    for part in ("generator", "discriminator") if moves else ():
        prefix = f"{part}."
        _assert_moves(getattr(th.module, part),
                      {k[len(prefix):]: v for k, v in state2.params.items()
                       if k.startswith(prefix)}, before[part], js2.params[part])
    got = jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats")
    want = _np(js2.extra["d_vars"]["batch_stats"])
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                               jax.tree_util.tree_leaves(got["discriminator"]),
                               jax.tree_util.tree_leaves(_np(js.extra["d_vars"]["batch_stats"]))):
        np.testing.assert_allclose(g, w, atol=STAT_TOL, rtol=STAT_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        assert not np.array_equal(w, b) or w.ndim == 0, jax.tree_util.keystr(path)
    return tl


def _assert_moves(module, params_after, before, want_after, rel=F32_GRAD_REL, ulps=PARAM_ULPS):
    """Each leaf's move under SGD at lr 1 within ``rel`` of the JAX move
    plus ``ulps`` (two float32 ulps of a parameter below 1; leaves in
    flax's order)."""
    after = jax_tree_from_state_dict(params_after, module)
    largest = 0.0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(want_after))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        largest = max(largest, move)
        assert np.abs(g - w).max() <= rel * move + ulps, jax.tree_util.keystr(path)
    assert largest > 0


# shared by the handler tests in test_torch_gan_handler.py

VGG_CFG_CONVS = [c for c in jfe.VGG19_CFG if c != "M"]


@functools.lru_cache(maxsize=None)
def _vgg_npz(tmp_dir):
    """Seeded random VGG-19 weights in the flax-layout npz (He-scaled, so
    features stay O(1) to conv5_4)."""
    rng = np.random.default_rng(19)
    out, cin = {}, 3
    for i, c in enumerate(VGG_CFG_CONVS):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((3, 3, cin, c))
                                   * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        out[f"Conv_{i}/bias"] = (0.01 * rng.standard_normal(c)).astype(np.float32)
        cin = c
    path = os.path.join(tmp_dir, "vgg19_seeded.npz")
    np.savez(path, **out)
    return path


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return _vgg_npz(str(tmp_path_factory.mktemp("vgg")))


# (handler, gan_mode, lr side); esrgan runs the VGG-128 discriminator (HR 128)
# and the VGG-19 content term
STEP_CASES = {"lsgan": ("realesrgan", "lsgan", 8), "bce": ("bsrgan", "bce", 8),
              "relativistic": ("esrgan", "relativistic", 32)}


def _gan_kwargs(vgg=None):
    kw = dict(SMALL, **SGD, main_lr=1.0, d_lr=1.0, pretrain_epochs=1)
    if vgg is not None:
        kw.update(vgg_weights=vgg, lambda_vgg=1.0)
    return kw


def _gan_pair(case, vgg=None):
    name, mode, _ = STEP_CASES[case]
    kw = _gan_kwargs(vgg)
    jh = jax_model(name)(**kw)
    jh.gan_mode = mode
    js = jh.init_state()
    params = _jitter(js.params, len(case))
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    th = torch_model(name)(device="cpu", **kw)
    th.gan_mode = mode
    stats = _np(js.extra["d_vars"]["batch_stats"])
    th.module.load_state_dict(state_dict_from_jax(params, th.module,
                                                  batch_stats={"discriminator": stats}))
    return jh, js, th


def _gan_batch(case, seed=0, n=2):
    side = STEP_CASES[case][2]
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((n, side, side, 3)).astype(np.float32),
            "hr": rng.random((n, 4 * side, 4 * side, 3)).astype(np.float32)}


# -- generator ---------------------------------------------------------------------

@pytest.mark.parametrize("scale", [4, 2, 1])
@pytest.mark.parametrize("num_metadata", [0, 3])
def test_rrdbnet_forward_matches_jax(scale, num_metadata):
    """RRDBNet (pixel-unshuffle heads at scales 2 and 1) and QRRDBNet (a
    ParaCALayer after each RRDB) against flax, and the bridge back."""
    jm = jgan.RRDBNet(scale=scale, nf=16, nb=2, gc=8, num_metadata=num_metadata)
    rng = np.random.default_rng(scale + 10 * num_metadata)
    x = rng.random((2, 8, 12, 3)).astype(np.float32)
    meta = rng.random((2, max(num_metadata, 1))).astype(np.float32)
    args = (jnp.asarray(x),) + ((jnp.asarray(meta),) if num_metadata else ())
    params = _jitter(jm.init(jax.random.PRNGKey(0), *args)["params"], scale)
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = tgan.RRDBNet(scale=scale, nf=16, nb=2, gc=8, num_metadata=num_metadata)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(meta) if num_metadata else None))
    assert got.shape == (2, 8 * scale, 12 * scale, 3)
    _close(got, want)
    back = jax_tree_from_state_dict(tm.state_dict(), tm)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)


def test_rrdb_residuals_stay_in_bf16():
    """``x + 0.2 * x5`` keeps the activation type, as flax's weak-typed
    0.2 does: a bf16 RRDBNet's output is bf16 and within 2**-6 of flax's
    bf16 output."""
    jm = jgan.RRDBNet(scale=4, nf=16, nb=2, gc=8, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).random((1, 8, 8, 3)).astype(np.float32)
    params = _jitter(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    tm = tgan.RRDBNet(scale=4, nf=16, nb=2, gc=8, dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    with torch.no_grad():
        out = tm(_nchw(x))
    assert out.dtype == torch.bfloat16
    assert np.abs(_nhwc(out) - want).max() <= 2.0 ** -6 * np.abs(want).max()


# -- discriminators ----------------------------------------------------------------

def _sn_pair(seed=0):
    jm = jgan.UNetDiscriminatorSN(nf=4)
    x0 = jnp.zeros((1, 16, 16, 3))
    variables = _np(jm.init(jax.random.PRNGKey(seed), x0, train=True))
    params = _jitter(variables["params"], seed + 1)
    stats = variables["batch_stats"]
    tm = tgan.UNetDiscriminatorSN(nf=4)
    tm.load_state_dict(state_dict_from_jax(params, tm, batch_stats=stats))
    return jm, params, stats, tm


@pytest.mark.parametrize("calls", [1, 3])
def test_spectral_norm_state_matches_flax(calls):
    """The U-Net SN discriminator's output, and every ``u`` and ``sigma``
    after ``calls`` train calls (each a power-iteration step written
    back); then an eval call, which computes with them and writes
    nothing."""
    jm, params, stats, tm = _sn_pair(calls)
    rng = np.random.default_rng(calls)
    for i in range(calls):
        x = rng.random((2, 16, 24, 3)).astype(np.float32)
        want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
        stats = _np(mut["batch_stats"])
        with torch.no_grad():
            got = tm(_nchw(x), train=True)
        _close(_nhwc(got), want)
    got_stats = jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats")
    assert set(got_stats) == {f"SpectralNorm_{i}" for i in range(8)}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(stats)[0],
                            jax.tree_util.tree_leaves(got_stats)):
        np.testing.assert_allclose(g, w, atol=STAT_TOL, rtol=STAT_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    kept = {k: v.clone() for k, v in tm.state_dict().items()}
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(_nchw(x), train=False)
    _close(_nhwc(got), want)
    assert all(torch.equal(kept[k], v) for k, v in tm.state_dict().items())


def test_spectral_norm_gradient_flows_through_sigma():
    """The discriminator's parameter gradients, ``sigma = v W u^T`` carrying
    W's gradient (u and v none), against ``jax.grad``."""
    jm, params, stats, tm = _sn_pair(5)
    x = np.random.default_rng(5).random((2, 16, 16, 3)).astype(np.float32)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    gp = _np(jax.grad(loss)(params))
    (tm(_nchw(x), train=True) ** 2).mean().backward()
    got = jax_tree_from_state_dict({k: p.grad for k, p in tm.named_parameters()}, tm)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gp)[0],
                            jax.tree_util.tree_leaves(got)):
        assert np.abs(g - w).max() <= F32_GRAD_REL * np.abs(w).max(), jax.tree_util.keystr(path)


def test_vgg128_discriminator_matches_flax():
    """VGG-128: BatchNorm on batch statistics in train mode (running ones
    updated, momentum 0.9), the CHW flatten before Dense(100), then eval on
    the running statistics."""
    jm = jgan.VGGStyleDiscriminator128(nf=4)
    variables = _np(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 128, 128, 3)), train=True))
    params, stats = _jitter(variables["params"], 2), variables["batch_stats"]
    tm = tgan.VGGStyleDiscriminator128(nf=4)
    tm.load_state_dict(state_dict_from_jax(params, tm, batch_stats=stats))
    x = np.random.default_rng(2).random((3, 128, 128, 3)).astype(np.float32)
    want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(_nchw(x), train=True)
    assert got.shape == (3, 1)
    # batch statistics of 3 x 4 x 4 values deep in the net amplify float32
    # rounding: both runs are held to flax in float64 (flax's own float32
    # run stands about 1.4e-5 of the largest output off it)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        want64, _ = jgan.VGGStyleDiscriminator128(nf=4, dtype=jnp.float64).apply(
            {"params": f64(params), "batch_stats": f64(stats)}, jnp.asarray(x, jnp.float64),
            train=True, mutable=["batch_stats"])
        want64 = np.asarray(want64)
    scale = np.abs(want64).max()
    print(f"VGG-128 train-mode output off flax float64, of its largest entry: port "
          f"{np.abs(got.numpy() - want64).max() / scale:.3g}, flax float32 "
          f"{np.abs(np.asarray(want) - want64).max() / scale:.3g}")
    _close(got.numpy(), want64)
    _close(want, want64, rel=4 * F32_REL)
    got_stats = jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(got_stats),
                    jax.tree_util.tree_leaves(_np(mut["batch_stats"]))):
        np.testing.assert_allclose(g, w, atol=STAT_TOL, rtol=STAT_TOL)
    want = jm.apply({"params": params, **_np(mut)}, jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(tm(_nchw(x), train=False).numpy(), want)


# -- conjugations ---------------------------------------------------------------------

DAN_GAN = dict(nf=16, nb=1, gc=8, d_nf=4, loop=2, scale=2, pretrain_epochs=1, **SGD,
               main_lr=1.0, d_lr=1.0)


@functools.lru_cache(maxsize=None)
def _dan_pair():
    ikm = tuple(np.random.default_rng(9).standard_normal(10).astype(np.float32).tolist())
    jh = jax_model("danv1qrealesrgan")(init_ker_map=ikm, **DAN_GAN)
    js = jh.init_state()
    params = _jitter(js.params, 9)
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    th = torch_model("danv1qrealesrgan")(device="cpu", **DAN_GAN)
    th.module.load_state_dict(state_dict_from_jax(
        params, th.module, batch_stats={"discriminator": _np(js.extra["d_vars"]["batch_stats"])}))
    model_constants_from_jax(jh.module, th.module.generator)
    return jh, js, th


def _dan_batch(seed):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((2, 8, 8, 3)).astype(np.float32),
            "hr": rng.random((2, 16, 16, 3)).astype(np.float32),
            "metadata": rng.random((2, 10)).astype(np.float32)}


@pytest.mark.parametrize("epoch", [0, 1])
def test_danv1qrealesrgan_steps_match_jax(epoch):
    """DAN v1 with a QRRDBNet restorer (loop 2), JAX's ``init_ker_map``
    carried across: the DAN loss's pre-train step, then the GAN step (bce,
    U-Net SN) with the per-iteration losses; evaluation gives the last
    iteration's SR."""
    jh, js, th = _dan_pair()
    batch = _dan_batch(10 + epoch)
    state = th._own_state()
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(batch["lr"])}))
    _close(th.run_eval(state, {"lr": batch["lr"]}).numpy(), want)
    jh.set_epoch(epoch)
    th.set_epoch(epoch)
    if epoch == 0:
        before = jax.tree_util.tree_map(np.copy,
                                        jax_tree_from_state_dict(state.params, th.module))
        js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
        state2, tl = th.train_batch(state, batch)
        _assert_losses(tl, jl)
        _assert_moves(th.module.generator,
                      {k[len("generator."):]: v for k, v in state2.params.items()
                       if k.startswith("generator.")}, before["generator"],
                      js2.params["generator"])
    else:
        tl = _assert_gan_step(jh, js, th, batch)
    assert {f"image-loss-iter-{i}" for i in range(2)} <= set(tl)
    # back to the JAX weights for the next case
    th.module.load_state_dict(state_dict_from_jax(
        _np(js.params), th.module,
        batch_stats={"discriminator": _np(js.extra["d_vars"]["batch_stats"])}))


BOBW_Q = dict(scale=2, nf=16, nb=2, gc=8, **SGD)


def test_contrastiveblindqrealesrgan_matches_jax():
    """QRRDBNet behind the frozen DASR encoder: the eval forward and one
    L1 step (the encoder's batch statistics, the generator's update)."""
    jh = jax_model("contrastiveblindqrealesrgan")(**BOBW_Q)
    js = jh.init_state()
    params = _jitter(js.params, 11)
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    th = torch_model("contrastiveblindqrealesrgan")(device="cpu", **BOBW_Q)
    full = {**params, "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    state = th._own_state()
    rng = np.random.default_rng(12)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    _close(th.run_eval(state, {"lr": x}).numpy(), jh.run_eval(js, {"lr": jnp.asarray(x)}))
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    before = jax_tree_from_state_dict(state.params, th.module)["generator"]
    before = jax.tree_util.tree_map(np.copy, before)
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    _assert_moves(th.module.generator,
                  {k[len("generator."):]: v for k, v in state2.params.items()
                   if k.startswith("generator.")}, before, js2.params["generator"])


# -- feature extractors and the perceptual loss ---------------------------------------

@pytest.mark.parametrize("tap", ["conv1_1", "relu2_2", "pool3", "conv54", "conv5_4"])
def test_vgg19_taps_match_jax(tap, vgg_npz):
    """Each tap (pre-activation at a conv, both spellings), only the layers
    up to it built, ImageNet normalisation, from the seeded npz."""
    x = np.random.default_rng(6).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jfe.VGG19Features(tap=tap).apply(
        {"params": jfe.load_extractor_params(vgg_npz)}, jnp.asarray(x)))
    tm = tfe.VGG19Features.from_npz(vgg_npz, tap=tap, device="cpu")
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    n_convs = sum(1 for s in tm.plan if isinstance(s, int))
    assert len(tm.convs) == n_convs
    _close(got, want)


def test_perceptual_mechanism_matches_jax(vgg_npz):
    rng = np.random.default_rng(7)
    sr, y = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = float(jlosses.PerceptualMechanism(weights_path=vgg_npz)(jnp.asarray(sr),
                                                                   jnp.asarray(y)))
    mech = tlosses.PerceptualMechanism(weights_path=vgg_npz, device="cpu")
    got = float(mech(torch.from_numpy(sr), torch.from_numpy(y)))
    assert abs(got - want) <= F32_REL * abs(want)
    feats = tfe.perceptual_loss_mechanism("vgg", weights=vgg_npz, device="cpu")(
        torch.from_numpy(sr))
    _close(feats.detach().numpy(), jfe.perceptual_loss_mechanism("vgg", weights=vgg_npz)(
        jnp.asarray(sr)))


def test_perceptual_paths_raise_without_weights():
    """No weights, no extractor: both packages raise NotImplementedError,
    and a GAN handler without ``vgg_weights`` drops the content term."""
    for mod in (jlosses, tlosses):
        with pytest.raises(NotImplementedError, match="weights"):
            mod.PerceptualMechanism()
    for mod in (jfe, tfe):
        with pytest.raises(NotImplementedError, match="weights"):
            mod.perceptual_loss_mechanism("vgg")
    th = torch_model("esrgan")(device="cpu", **SMALL)
    assert th.lambda_vgg == 0.0 and th.vgg_module is None


def test_convert_torch_vgg19_writes_the_npz_both_packages_read(tmp_path):
    """A torchvision-layout state dict converts to the same npz in both
    packages, which the port's extractor loads."""
    rng = np.random.default_rng(8)
    sd, cin, idx = {}, 3, 0
    for spec in jfe.VGG19_CFG:
        if spec == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((spec, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.standard_normal(spec).astype(np.float32))
        cin, idx = spec, idx + 2
    a = tfe.convert_torch_vgg19(sd, str(tmp_path / "port.npz"))
    b = jfe.convert_torch_vgg19({k: v.numpy() for k, v in sd.items()}, str(tmp_path / "jax.npz"))
    pa, pb = tfe.load_extractor_params(a), jfe.load_extractor_params(b)
    assert set(pa) == set(pb) == {f"Conv_{i}" for i in range(16)}
    for k in pa:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(pa[k][leaf], np.asarray(pb[k][leaf]))
    tfe.VGG19Features.from_npz(a, tap="relu1_1", device="cpu")


# -- checkpoints and the CLIs -----------------------------------------------------------

def test_jax_written_gan_checkpoint_scores_the_same(tmp_path):
    """A realesrgan checkpoint the JAX package wrote (``params`` generator
    and discriminator, the spectral-norm state in ``extra.d_vars``) loads
    through ``load_model`` and scores as the JAX handler does; the
    discriminator's ``u`` and ``sigma`` come with it."""
    jh, js, _ = _gan_pair("lsgan")
    jh.save_model(js, str(tmp_path / "saved_models"), epoch=0)
    th = torch_model("realesrgan")(device="cpu", **SMALL)
    state, _ = th.load_model(str(tmp_path / "saved_models"), "last", skip_optimizer_load=True)
    x = np.random.default_rng(13).random((1, 9, 11, 3)).astype(np.float32)
    _close(th.run_eval(state, {"lr": x}).numpy(), jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = jax_tree_from_state_dict(state.params, th.module, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(got["discriminator"]),
                    jax.tree_util.tree_leaves(_np(js.extra["d_vars"]["batch_stats"]))):
        np.testing.assert_array_equal(g, w)


def _write_sets(tmp_path, rng):
    hr_dir, lr_dir, ehr_dir = tmp_path / "hr", tmp_path / "elr", tmp_path / "ehr"
    for d in (hr_dir, lr_dir, ehr_dir):
        os.makedirs(d)
    for k in range(4):
        np.save(hr_dir / f"h{k}.npy", rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
    for k in range(2):
        hr = rng.integers(0, 256, (32, 28, 3), dtype=np.uint8)
        np.save(ehr_dir / f"e{k}.npy", hr)
        np.save(lr_dir / f"e{k}.npy", np.ascontiguousarray(hr[::4, ::4]))
    return hr_dir, lr_dir, ehr_dir


def test_realesrgan_trains_resumes_and_scores_through_the_clis(tmp_path):
    """A tiny realesrgan on examples/train_rcan_blind_x4.toml's chain
    through cli.train_sisr --device cpu: one pre-train epoch, then the
    adversarial epochs, validating each; a resume from epoch 1 reaches the
    same weights, discriminator state and optimizer states bit for bit;
    then cli.eval_sisr on the run."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.utils.checkpoint import checkpoint_path, load_checkpoint
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "examples", "train_rcan_blind_x4.toml")).as_plain()
    hr_dir, lr_dir, ehr_dir = _write_sets(tmp_path, np.random.default_rng(14))
    cfg["experiment"] = "realesrgan_tiny"
    cfg["experiment_save_loc"] = str(tmp_path / "Results")
    cfg["model"] = {"name": "realesrgan", "internal_params": dict(
        nf=8, nb=1, gc=4, d_nf=4, pretrain_epochs=1, lr=1e-4)}
    cfg["data"].pop("dataset", None)
    cfg["data"].pop("split", None)
    cfg["data"].update(crop=8, dataloader_threads=1)
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": str(lr_dir), "hr_dir": str(ehr_dir)}}
    cfg["training"].update(num_epochs=3, batch_size=2)
    dump_toml(cfg, str(tmp_path / "gan.toml"))
    stats = train_sisr.main(["-p", str(tmp_path / "gan.toml"), "--device", "cpu"])
    assert sorted(stats) == [0, 1, 2]
    assert stats[0]["gan-loss"] == 0.0 and stats[2]["gan-loss"] > 0.0
    assert np.isfinite([stats[e][k] for e in stats for k in ("train-loss", "val-PSNR")]).all()
    saved = str(tmp_path / "Results" / "realesrgan_tiny" / "saved_models")
    full = load_checkpoint(checkpoint_path(saved, 2))
    assert set(full["optimizer"]["optimizers"]) == {"generator_pre", "generator",
                                                     "discriminator"}
    assert full["optimizer"]["counts"] == {"generator_pre": 2, "generator": 4,
                                           "discriminator": 4}

    cfg["training"].update(continue_from_epoch=1, num_epochs=1)
    cfg["experiment"] = "realesrgan_tiny"
    dump_toml(cfg, str(tmp_path / "resume.toml"))
    train_sisr.main(["-p", str(tmp_path / "resume.toml"), "--device", "cpu"])
    resumed = load_checkpoint(checkpoint_path(saved, 2))
    for k, v in full["network"].items():
        assert torch.equal(v, resumed["network"][k]), k
    for name, sd in full["optimizer"]["optimizers"].items():
        got = resumed["optimizer"]["optimizers"][name]["state"]
        for i, st in sd["state"].items():
            for key, val in st.items():
                assert torch.equal(val, got[i][key]), (name, i, key)

    out = tmp_path / "scores"
    eval_sisr.main(["--model_loc", str(tmp_path / "Results"), "--out_loc", str(out),
                    "--lr_dir", str(lr_dir), "--hr_dir", str(ehr_dir), "--scale", "4",
                    "-me", "realesrgan_tiny", "last", "--device", "cpu"])
    assert os.path.isfile(out / "individual_metrics.csv")


def test_bobw_example_widths_and_sft_mode_fail_for_qrrdbnet_in_both():
    """Found in both packages: the BoBW example's QRCAN widths (n_feats,
    n_resgroups, n_resblocks) are no QRRDBNet arguments, and sft_mode hands
    QRRDBNet a third argument it does not take: both raise TypeError."""
    kw = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=2, block_encoder_loading=True)
    with pytest.raises(TypeError):
        jax_model("contrastiveblindqrealesrgan")(**kw).init_state()
    with pytest.raises(TypeError):
        torch_model("contrastiveblindqrealesrgan")(device="cpu", **kw)
    kw = dict(scale=2, nf=8, nb=1, gc=4, sft_mode=True, block_encoder_loading=True)
    with pytest.raises(TypeError):
        jax_model("contrastiveblindqrealesrgan")(**kw).init_state()
    th = torch_model("contrastiveblindqrealesrgan")(device="cpu", **kw)
    with pytest.raises(TypeError):
        th.run_eval(th.init_state(), {"lr": np.zeros((1, 4, 4, 3), np.float32)})
