"""WaveletSRNet and WaveletSRGAN in the port, on the CPU, against the JAX
package (``rumpy_tpu/models/wavelet.py``): the packet basis and
``wavelet_dec`` / ``wavelet_rec`` at ks 2, 4 and 8; the loss variants and
the handler's loss mix; WaveletSRNet (its fixed 64-1024 trunk, one residual
block a width, wavelet_c 2, x4) and the wavelet discriminator in eval mode
and in train mode with their BatchNorm statistics; the WaveletSRNet
handler's train-mode losses; WaveletSRGAN's two phases (bands only, then
adversarial) at x2, and its LightCNN identity term from a seeded npz; the
identity input's cubic resize (Keys a = -0.5,
antialiased down) at 192 -> 128 and 96 -> 128; and the handlers' refusals
and aliases.

Weights come from the port's seeded init, jittered, and reach flax through
the weight bridge, whose tree is checked against ``jax.eval_shape`` of the
flax init and which gives params and statistics back bit for bit. Inputs
come from a numpy seed. Tolerances: float32 forwards and the identity term
within 2e-5 of the largest entry; everything that runs BatchNorm in train
mode (the train-mode forwards, the losses and the steps) in float64 in both
packages (flax's BatchNorm and the JAX module's float32 casts made float64
by stand-ins), within 1e-9 of the largest entry, or of each parameter's
largest move; the transforms and the resize within 1e-6 of the largest
entry.
"""

import functools
import types
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import wavelet as jw
from rumpy_tpu.models.base import TrainState
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import wavelet as tw
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, F64_REL, EXACT_REL = 2e-5, 1e-9, 1e-6
NET = dict(scale=4, num_layers_res=1, wavelet_c=2)
SGD = dict(optimizer_type="sgd", lr=1.0)
LR_SIDE = 8


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _seeded(module, seed):
    """``module`` at its seeded init, every parameter and statistic then
    jittered off it (variances kept positive)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            t.add_(0.02 * torch.rand(t.shape, generator=gen) if "running_var" in name
                   else 0.02 * torch.randn(t.shape, generator=gen))
    return module


def _variables(module):
    return {"params": jax_tree_from_state_dict(module.state_dict(), module),
            "batch_stats": jax_tree_from_state_dict(module.state_dict(), module, "batch_stats")}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _float64_stand_ins(mp):
    """flax's BatchNorm and the JAX module's float32 casts made float64 (the
    JAX module fixes both to float32)."""
    def batch_norm(**kw):
        return fnn.BatchNorm(**dict(kw, dtype=jnp.float64, param_dtype=jnp.float64))

    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("_")}
    mp.setattr(jw, "nn", types.SimpleNamespace(**dict(names, BatchNorm=batch_norm)))
    mp.setattr(jw, "jnp", types.SimpleNamespace(**dict(
        {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("_")}, float32=jnp.float64)))


def _port_float64(mp, *modules):
    """Modules in float64, every ``Tensor.float()`` widened to float64."""
    mp.setattr(torch.Tensor, "float", torch.Tensor.double)
    for module in modules:
        module.double()
        for m in module.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float64


@functools.lru_cache(maxsize=None)
def _net(scale=4):
    """The port WaveletSRNet, seeded, with its flax variables, checked
    against the flax init's tree."""
    net = dict(NET, scale=scale)
    tm = _seeded(tw.WaveletSRNet(**net), 1)
    variables = _variables(tm)
    shapes = jax.eval_shape(jw.WaveletSRNet(**net).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LR_SIDE, LR_SIDE, 3)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(variables)
    assert [s.shape for s in _leaves(shapes)] == [a.shape for a in _leaves(variables)]
    return tm, variables


@functools.lru_cache(maxsize=None)
def _disc(scale=4):
    td = _seeded(tw.WaveletDiscriminator(scale=scale), 2)
    variables = _variables(td)
    shapes = jax.eval_shape(functools.partial(jw.WaveletDiscriminator(scale=scale).init,
                                              train=True),
                            jax.random.PRNGKey(0), jnp.zeros((1, LR_SIDE, LR_SIDE,
                                                              3 * scale * scale)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(variables)
    return td, variables


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# -- the transforms and losses ---------------------------------------------------------

@pytest.mark.parametrize("ks", [2, 4, 8])
def test_wavelet_transforms_match_jax(ks):
    """The analytic basis bit for bit; decomposition and reconstruction
    (filter-major channels) against the JAX einsums; rec inverts dec."""
    np.testing.assert_array_equal(tw.wavelet_basis(ks), jw.wavelet_basis(ks))
    x = _rand((2, 16, 24, 3), ks)
    want = np.asarray(jw.wavelet_dec(jnp.asarray(x), ks))
    got = tw.wavelet_dec(torch.from_numpy(x), ks).numpy()
    assert got.shape == want.shape == (2, 16 // ks, 24 // ks, 3 * ks * ks)
    _close(got, want, EXACT_REL)
    c = want + np.random.default_rng(9).standard_normal(want.shape).astype(np.float32)
    _close(tw.wavelet_rec(torch.from_numpy(c), ks).numpy(),
           np.asarray(jw.wavelet_rec(jnp.asarray(c), ks)), EXACT_REL)
    _close(tw.wavelet_rec(torch.from_numpy(got), ks).numpy(), x, EXACT_REL)


def test_wavelet_losses_match_jax():
    """Both loss_mse_ref variants, the texture hinge and the handler's mix
    of the four terms."""
    a, b = _rand((2, 4, 4, 48), 3), _rand((2, 4, 4, 48), 4)
    for size_average in (True, False):
        _close(float(tw.loss_mse_ref(torch.from_numpy(a), torch.from_numpy(b), size_average)),
               float(jw.loss_mse_ref(jnp.asarray(a), jnp.asarray(b), size_average)), 1e-6)
    _close(float(tw.loss_textures(torch.from_numpy(a), torch.from_numpy(b))),
           float(jw.loss_textures(jnp.asarray(a), jnp.asarray(b))), 1e-6)
    out, y = _rand((2, 16, 16, 3), 5), _rand((2, 16, 16, 3), 6)
    want = jw._WaveletLossMixin._wavelet_losses(types.SimpleNamespace(scale=4), jnp.asarray(a),
                                                jnp.asarray(out), jnp.asarray(y))
    got = tw.wavelet_losses(torch.from_numpy(a), torch.from_numpy(out), torch.from_numpy(y), 4)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-6)


# -- the networks ----------------------------------------------------------------------

def test_waveletsrnet_matches_jax(monkeypatch):
    """Eval mode in float32; train mode (coefficients, image and every
    BatchNorm statistic) in float64; the bridge both ways."""
    tm, variables = _net()
    x = _rand((2, LR_SIDE, LR_SIDE, 3), 7)
    jm = jw.WaveletSRNet(**NET)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, 4 * LR_SIDE, 4 * LR_SIDE, 3)
    _close(got, want, F32_REL)
    fresh = tw.WaveletSRNet(**NET)
    fresh.load_state_dict(state_dict_from_jax(variables["params"], fresh,
                                              batch_stats=variables["batch_stats"]))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in fresh.state_dict().items())
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jm = jw.WaveletSRNet(**NET, dtype=jnp.float64)
            (wav, img), mut = jax.jit(functools.partial(
                jm.apply, train=True, return_wavelets=True, mutable=["batch_stats"]))(
                _f64(variables), jnp.asarray(x, jnp.float64))
            want = [np.asarray(wav), np.asarray(img)] + _leaves(
                jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        _port_float64(mp, fresh)
        pw, pimg = fresh(_nchw(x).double(), train=True, return_wavelets=True)
        got = [_nhwc(pw), _nhwc(pimg)] + _leaves(
            jax_tree_from_state_dict(fresh.state_dict(), fresh, "batch_stats"))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        _close(g, w, F64_REL)


def test_wavelet_discriminator_matches_jax(monkeypatch):
    """Eval mode in float32; train mode with its statistics in float64."""
    td, variables = _disc()
    x = np.random.default_rng(8).standard_normal((2, LR_SIDE, LR_SIDE, 48)).astype(np.float32)
    jd = jw.WaveletDiscriminator(scale=4)
    want = np.asarray(jax.jit(jd.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(td(_nchw(x)))
    assert got.shape == want.shape == (2, LR_SIDE // 2, LR_SIDE // 2, 1)
    _close(got, want, F32_REL)
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jd = jw.WaveletDiscriminator(scale=4, dtype=jnp.float64)
            out, mut = jax.jit(functools.partial(jd.apply, train=True, mutable=["batch_stats"]))(
                _f64(variables), jnp.asarray(x, jnp.float64))
            want = [np.asarray(out)] + _leaves(jax.tree_util.tree_map(np.asarray,
                                                                      mut["batch_stats"]))
        fresh = tw.WaveletDiscriminator(scale=4)
        fresh.load_state_dict(td.state_dict())
        _port_float64(mp, fresh)
        got = [_nhwc(fresh(_nchw(x).double(), train=True))] + _leaves(
            jax_tree_from_state_dict(fresh.state_dict(), fresh, "batch_stats"))
    for g, w in zip(got, want):
        _close(g, w, F64_REL)


# -- the handlers ----------------------------------------------------------------------

def _batch(seed, n=2, scale=4):
    return {"lr": _rand((n, LR_SIDE, LR_SIDE, 3), seed),
            "hr": _rand((n, scale * LR_SIDE, scale * LR_SIDE, 3), seed + 1)}


def _assert_step(got_tree, want_tree, before_tree):
    """Each leaf within 1e-9 of its largest move or of its largest entry,
    whichever is larger (a conv bias before a BatchNorm moves by rounding
    residue alone: its gradient is zero)."""
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                               _leaves(got_tree), _leaves(before_tree)):
        scale = max(np.abs(w - b).max(), np.abs(w).max())
        assert np.abs(g - w).max() <= F64_REL * scale, jax.tree_util.keystr(path)


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= F64_REL * max(abs(float(w)), 1e-12), k


def test_waveletsrnet_losses_match_jax_in_float64(monkeypatch):
    """The handler's train-mode forward and loss mix (0.99 SR bands, 0.01
    LR band, 0.1 image, the texture hinge) in float64: the six losses and
    every statistic the forward advanced. (A generator step with its
    BatchNorm is held in ``test_waveletsrgan_step_matches_jax_in_float64``.)"""
    tm, variables = _net()
    batch = _batch(10)
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jh = jax_model("waveletsrnet")(**NET)
            jh.module = jh.module.clone(dtype=jnp.float64)
            v = _f64(variables)

            def losses(b):
                out, aux, extra = jh.apply(v["params"], b, train=True,
                                           extra={"vars": {"batch_stats": v["batch_stats"]}})
                return jh.compute_losses(out, b, aux), extra["vars"]["batch_stats"]

            jl, stats = jax.jit(losses)({k: jnp.asarray(a, jnp.float64) for k, a in batch.items()})
            want_stats = jax.tree_util.tree_map(np.asarray, stats)
        th = torch_model("waveletsrnet")(device="cpu", **NET)
        th.module.load_state_dict(tm.state_dict())
        _port_float64(mp, th.module)
        tb = {k: torch.from_numpy(a).double() for k, a in batch.items()}
        with torch.no_grad():
            out, aux, _ = th.apply(th._own_state().params, tb, train=True)
            tl = th.compute_losses(out, tb, aux)
        got_stats = jax_tree_from_state_dict(th.module.state_dict(), th.module, "batch_stats")
    _assert_losses(tl, jl)
    _assert_step(got_stats, want_stats, variables["batch_stats"])


def _lightcnn_npz(path, seed=11):
    """LightCNN weights for a grey input in the npz layout both packages
    read, He-scaled normal draws from a seed."""
    from rumpy_tpu_torch.models.feature_extractors import LightCNNFeatures
    rng = np.random.default_rng(seed)
    out, cin = {}, 1
    for i, (f, k, _) in enumerate(LightCNNFeatures.SPEC):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, cin, 2 * f))
                                   * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        out[f"Conv_{i}/bias"] = (0.01 * rng.standard_normal(2 * f)).astype(np.float32)
        cin = f
    np.savez(path, **out)
    return str(path)


# the epoch: training_switch 1 makes epoch 1 adversarial
GAN_SCALE = 2  # two heads; the trunk is the same
GAN_CASES = {"bands": 0, "adversarial": 1}


@pytest.mark.parametrize("case", list(GAN_CASES))
def test_waveletsrgan_step_matches_jax_in_float64(case, monkeypatch):
    """One step from the same state in both packages, in float64: epoch 0
    (training_switch 1) trains on the bands' MSE alone and leaves the
    discriminator as it was; epoch 1 adds the adversarial term and updates
    the discriminator (the identity term is held on its own in
    ``test_identity_term_matches_jax``: LightCNN at 128² in float64 would
    double this file's time). The losses, both networks and both networks'
    statistics."""
    epoch, n = GAN_CASES[case], 2
    tg, gvars = _net(GAN_SCALE)
    td, dvars = _disc(GAN_SCALE)
    kw = dict(NET, scale=GAN_SCALE, training_switch=1, include_id_loss=False, **SGD)
    before = {"generator": gvars["params"], "discriminator": dvars["params"]}
    before_stats = {"generator": gvars["batch_stats"], "discriminator": dvars["batch_stats"]}
    batch = _batch(20 + epoch, n, GAN_SCALE)
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jh = jax_model("waveletsrgan")(**kw)
            jh.module = jh.module.clone(dtype=jnp.float64)
            jh.discriminator = jw.WaveletDiscriminator(scale=GAN_SCALE, dtype=jnp.float64)
            params = _f64(before)
            js = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state={"generator": jh.tx.init(params["generator"]),
                                       "discriminator": jh.d_tx.init(params["discriminator"])},
                            extra={"g_bstats": _f64(gvars["batch_stats"]),
                                   "d_bstats": _f64(dvars["batch_stats"])},
                            rng=jax.random.PRNGKey(0))
            jh.set_epoch(epoch)
            js, jl = jh.train_batch(js, {k: jnp.asarray(a, jnp.float64) for k, a in batch.items()})
            want = jax.tree_util.tree_map(np.asarray, js.params)
            want_stats = jax.tree_util.tree_map(np.asarray, {
                "generator": js.extra["g_bstats"], "discriminator": js.extra["d_bstats"]})
        th = torch_model("waveletsrgan")(device="cpu", **kw)
        th.module.generator.load_state_dict(tg.state_dict())
        th.discriminator.load_state_dict(td.state_dict())
        _port_float64(mp, th.module)
        th.set_epoch(epoch)
        state, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(a).double()
                                                     for k, a in batch.items()})
        got = jax_tree_from_state_dict(state.params, th.module)
        got_stats = jax_tree_from_state_dict(state.params, th.module, "batch_stats")
    _assert_losses(tl, jl)
    assert float(tl["id_loss"]) == 0
    assert (float(tl["discrim_loss"]) > 0) == (epoch == 1)
    _assert_step(got, want, before)
    _assert_step(got_stats, want_stats, before_stats)
    d_moved = [not np.array_equal(a, b) for a, b in zip(_leaves(got["discriminator"]),
                                                        _leaves(before["discriminator"]))]
    assert all(d_moved) if epoch else not any(d_moved)


def test_identity_term_matches_jax(tmp_path):
    """WaveletSRGAN's identity term from a seeded LightCNN npz (the grey
    128 x 128 resize of the HR image and of the output, LightCNN features,
    their L1 over the features an image), in float32, and a gradient from
    it reaches the output. (Its gradient is autograd's of this value; held
    against JAX's it would need float64, where XLA's CPU convs take 15 s.)"""
    kw = dict(NET, scale=GAN_SCALE, identity_weights=_lightcnn_npz(tmp_path / "lightcnn.npz"))
    jh = jax_model("waveletsrgan")(**kw)
    th = torch_model("waveletsrgan")(device="cpu", **kw)
    y, out = _rand((2, 48, 40, 3), 12), _rand((2, 48, 40, 3), 13)
    want = jax.jit(lambda o: jh._identity_loss_p(jh._identity_params, jnp.asarray(y), o))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    got = th.identity_loss(torch.from_numpy(y), o)
    got.backward()
    assert float(want) > 0 and bool(o.grad.abs().sum() > 0)
    assert not any(p.requires_grad for p in th.identity_module.parameters())
    _close(float(got), float(want), F32_REL)


@pytest.mark.parametrize("sides", [(192, 176), (96, 128), (128, 128)])
def test_identity_preprocess_matches_jax_resize(sides):
    """LightCNN's input: ``jax.image.resize(..., "cubic")`` to 128 x 128
    (Keys a = -0.5, half-pixel, antialiased when downscaling; a side at 128
    untouched), then BT.601 grey."""
    x = _rand((2, *sides, 3), sides[0])
    want = np.asarray(jax.jit(lambda a: jw.WaveletSRGANHandler._identity_preprocess(None, a))(
        jnp.asarray(x)))
    got = tw.identity_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 128, 1)
    _close(got, want, EXACT_REL)
    if sides[0] != 128:
        w = tw.cubic_resize_matrix(sides[0], 128)
        assert np.allclose(w.sum(1), 1.0) and w.shape == (128, sides[0])


def test_handler_refusals_and_aliases_match_jax():
    """waveletsrgan refuses to build without identity weights unless the
    term is off; waveletnet ignores nf/nb with a warning; eval runs the
    generator alone."""
    for make in (jax_model, lambda n: (lambda **kw: torch_model(n)(device="cpu", **kw))):
        with pytest.raises(ValueError, match="identity_weights"):
            make("waveletsrgan")(**NET)
        with pytest.warns(UserWarning, match="nf/nb"):
            make("waveletnet")(nf=8, nb=2, **NET)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make("waveletnet")(**NET)
    th = torch_model("waveletsrgan")(device="cpu", include_id_loss=False, **NET)
    assert th.identity_module is None and th.training_switch == 10
    out = th.run_eval(th.init_state(), {"lr": np.full((1, 8, 8, 3), 0.5, np.float32)})
    assert tuple(out.shape) == (1, 32, 32, 3) and bool(torch.isfinite(out).all())
