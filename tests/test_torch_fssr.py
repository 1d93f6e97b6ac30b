"""The FSSR family in the port, on the CPU, against the JAX package
(``rumpy_tpu/models/fssr.py``): ``filter_low`` and ``filter_high`` with each
padding flag; the DSGAN generator and the high-pass discriminator (eval
mode, and train mode with its BatchNorm statistics); an ESRGAN-FS
adversarial step (low-pass pixel term, high-band discriminator); an
FSSR-DSGAN step with LPIPS on a 32-pixel image and the epoch-linear factor
at 2/3; ``_lr_factor`` over the epochs; the refusals and aliases.

Weights come from the port's seeded init, jittered, through the weight
bridge (flax's eager init of the GAN pair is the slow part here), which gives
params and statistics back bit for bit; inputs from a numpy seed.
Tolerances: the filters within 1e-6 of the largest entry; float32
forwards within 2e-5; the ESRGAN-FS step (a U-Net spectral-norm
discriminator) under SGD at lr 1 in float64 (the relativistic gradient of
the discriminator's last bias is float32 rounding residue); the DSGAN
discriminator's train mode and the FSSR-DSGAN step (BatchNorm in train
mode) in float64; every float64 result in both packages within 1e-9 of
each leaf's largest move or entry.
"""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import fssr as jfssr
from rumpy_tpu.models.base import TrainState
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.utils import lpips_jax
from rumpy_tpu_torch.models import fssr as tfssr
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.lpips import ALEX_CFG
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, F64_REL, FILTER_REL = 2e-5, 1e-9, 1e-6
SGD = dict(optimizer_type="sgd", lr=1.0)
SIDE = 32


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _seeded(module, seed):
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
    out = {"params": jax_tree_from_state_dict(module.state_dict(), module)}
    stats = jax_tree_from_state_dict(module.state_dict(), module, "batch_stats")
    if stats:
        out["batch_stats"] = stats
    return out


def _float64_stand_ins(mp):
    """flax's BatchNorm and the JAX module's float32 casts made float64."""
    def batch_norm(**kw):
        return fnn.BatchNorm(**dict(kw, dtype=jnp.float64, param_dtype=jnp.float64))

    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("_")}
    mp.setattr(jfssr, "nn", types.SimpleNamespace(**dict(names, BatchNorm=batch_norm)))
    mp.setattr(jfssr, "jnp", types.SimpleNamespace(**dict(
        {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("_")}, float32=jnp.float64)))


def _port_float64(mp, *modules):
    mp.setattr(torch.Tensor, "float", torch.Tensor.double)
    for module in modules:
        module.double()
        for m in module.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float64


@functools.lru_cache(maxsize=None)
def _dsgan():
    """The port's DSGAN generator (2 blocks) and discriminator, seeded,
    with their flax variables, checked against the flax inits' trees."""
    tg = _seeded(tfssr.DSGANGenerator(2), 1)
    td = _seeded(tfssr.DSGANDiscriminator(), 2)
    gv, dv = _variables(tg), _variables(td)
    x = jnp.zeros((1, 16, 16, 3))
    for jm, v, kw in ((jfssr.DSGANGenerator(n_res_blocks=2), gv, {}),
                      (jfssr.DSGANDiscriminator(), dv, {"train": True})):
        shapes = jax.eval_shape(functools.partial(jm.init, **kw), jax.random.PRNGKey(0), x)
        assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(v)
        assert [s.shape for s in _leaves(shapes)] == [a.shape for a in _leaves(v)]
    return tg, td, gv, dv


# -- filters ---------------------------------------------------------------------------

FILTER_CASES = {"pad_counted": (True, True), "pad_not_counted": (True, False),
                "no_pad": (False, True)}


@pytest.mark.parametrize("case", list(FILTER_CASES))
@pytest.mark.parametrize("k", [5, 3])
def test_filters_match_jax(case, k):
    """filter_low with zero padding counted in the mean, not counted, or
    none (the map shrinks by k - 1); filter_high on the padded forms,
    normalised and not."""
    padding, include_pad = FILTER_CASES[case]
    x = _rand((2, 11, 13, 3), k)
    want = np.asarray(jfssr.filter_low(jnp.asarray(x), k, padding, include_pad))
    got = tfssr.filter_low(torch.from_numpy(x), k, padding, include_pad).numpy()
    side = 0 if padding else k - 1
    assert got.shape == want.shape == (2, 11 - side, 13 - side, 3)
    _close(got, want, FILTER_REL)
    if padding:
        for normalize in (True, False):
            _close(tfssr.filter_high(torch.from_numpy(x), k, include_pad, normalize).numpy(),
                   np.asarray(jfssr.filter_high(jnp.asarray(x), k, include_pad, normalize)),
                   FILTER_REL)


# -- DSGAN networks ------------------------------------------------------------------------

def test_dsgan_networks_match_jax(monkeypatch):
    """The generator and the discriminator in eval mode (float32); the
    discriminator in train mode with its statistics (float64); the bridge
    back bit for bit."""
    tg, td, gv, dv = _dsgan()
    x = _rand((2, 16, 20, 3), 3)
    want = np.asarray(jax.jit(jfssr.DSGANGenerator(n_res_blocks=2).apply)(gv, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tg(_nchw(x)))
    assert got.shape == want.shape == x.shape
    _close(got, want, F32_REL)
    want = np.asarray(jax.jit(jfssr.DSGANDiscriminator().apply)(dv, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(td(_nchw(x)))
    assert got.shape == want.shape == (2, 16, 20, 1)
    _close(got, want, F32_REL)
    fresh = tfssr.DSGANDiscriminator()
    fresh.load_state_dict(state_dict_from_jax(dv["params"], fresh, batch_stats=dv["batch_stats"]))
    assert all(torch.equal(v, td.state_dict()[k]) for k, v in fresh.state_dict().items())
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jd = jfssr.DSGANDiscriminator(dtype=jnp.float64)
            out, mut = jax.jit(functools.partial(jd.apply, train=True, mutable=["batch_stats"]))(
                _f64(dv), jnp.asarray(x, jnp.float64))
            want = [np.asarray(out)] + _leaves(jax.tree_util.tree_map(np.asarray,
                                                                      mut["batch_stats"]))
        _port_float64(mp, fresh)
        got = [_nhwc(fresh(_nchw(x).double(), train=True))] + _leaves(
            jax_tree_from_state_dict(fresh.state_dict(), fresh, "batch_stats"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w, F64_REL)


# -- ESRGAN-FS -----------------------------------------------------------------------------

ESRGANFS = dict(nf=8, nb=1, gc=4, d_nf=4, discriminator="unet_sn", pretrain_epochs=1,
                main_lr=1.0, d_lr=1.0, **SGD)


def test_esrganfs_step_matches_jax(monkeypatch):
    """The hooks (the low-pass pixel pair, the normalised high band as the
    discriminator's input) in float32 and one adversarial step in float64:
    the losses, both networks' updates and the spectral-norm state."""
    th = torch_model("esrganfs")(device="cpu", **ESRGANFS)
    th.init_state(4)
    _seeded(th.module.generator, 4)
    with torch.no_grad():  # off the zero biases, keeping the spectral-norm state
        for p in th.discriminator.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    params = jax_tree_from_state_dict(th.module.state_dict(), th.module)
    stats = jax_tree_from_state_dict(th.module.state_dict(), th.module, "batch_stats")
    jh = jax_model("esrganfs")(**ESRGANFS)
    img = _rand((2, SIDE, SIDE, 3), 5)
    flipped = np.ascontiguousarray(img[::-1])
    for got, want in zip(th._pixel_pair(torch.from_numpy(img), torch.from_numpy(flipped)),
                         jh._pixel_pair(jnp.asarray(img), jnp.asarray(flipped))):
        _close(got.numpy(), want, FILTER_REL)
    _close(th._disc_input(torch.from_numpy(img)).numpy(), jh._disc_input(jnp.asarray(img)),
           FILTER_REL)
    batch = {"lr": _rand((2, SIDE // 4, SIDE // 4, 3), 6), "hr": _rand((2, SIDE, SIDE, 3), 7)}
    # the step in float64: the relativistic loss's gradient at the
    # discriminator's last bias is float32 rounding residue
    with monkeypatch.context() as mp, jax.enable_x64(True):
        h = jax_model("esrganfs")(**ESRGANFS)
        h.dtype = jnp.float64
        h.module = h.build_module(**h.model_kwargs)
        h.discriminator = h.build_discriminator()
        h.set_epoch(1)
        p64 = _f64(params)
        js = TrainState(step=jnp.zeros((), jnp.int32), params=p64,
                        opt_state={"generator": h.main_tx.init(p64["generator"]),
                                   "discriminator": h.d_tx.init(p64["discriminator"]),
                                   "generator_pre": h.tx.init(p64["generator"])},
                        extra={"d_vars": {"batch_stats": _f64(stats["discriminator"])}},
                        rng=jax.random.PRNGKey(0))
        js, jl = h.train_batch(js, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        want = jax.tree_util.tree_map(np.asarray, js.params)
        want_stats = jax.tree_util.tree_map(np.asarray, js.extra["d_vars"]["batch_stats"])
        th.set_epoch(1)
        _port_float64(mp, th.module)
        state, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(v).double()
                                                     for k, v in batch.items()})
        got = jax_tree_from_state_dict(state.params, th.module)
        got_stats = jax_tree_from_state_dict(state.params, th.module, "batch_stats")
    assert set(tl) == set(jl)
    for k, w in jl.items():
        assert abs(float(tl[k]) - float(w)) <= F64_REL * max(abs(float(w)), 1e-12), k
    for part in ("generator", "discriminator"):
        _assert_f64_step(got[part], want[part], params[part])
    for g, w in zip(_leaves(got_stats["discriminator"]), _leaves(want_stats)):
        _close(g, w, F64_REL)


def _assert_f64_step(got_after, want_after, before):
    """Each leaf within 1e-9 of its largest move or of its largest entry,
    whichever is larger, and moved."""
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want_after)[0],
                               _leaves(got_after), _leaves(before)):
        scale = max(np.abs(w - b).max(), np.abs(w).max())
        assert np.abs(g - w).max() <= F64_REL * scale, jax.tree_util.keystr(path)
        assert not np.array_equal(w, b), jax.tree_util.keystr(path)


# -- FSSR-DSGAN ----------------------------------------------------------------------------

def _lpips_npz(path, seed=8):
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, (f, k, _, _) in enumerate(ALEX_CFG):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, cin, f))
                                   * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        out[f"Conv_{i}/bias"] = (0.01 * rng.standard_normal(f)).astype(np.float32)
        cin = f
    for i, (f, _, _, _) in enumerate(ALEX_CFG):
        out[f"lin{i}"] = (0.1 * rng.random((f, 1))).astype(np.float32)
    np.savez(path, **out)
    return str(path)


DSGAN = dict(n_res_blocks=2, **SGD)


def test_fssrdsgan_step_matches_jax_in_float64(tmp_path, monkeypatch):
    """One step at epoch 200 (the factor 1 - 50 / 150 on both updates): the
    discriminator on real and detached fake images (train mode, statistics
    chained), then the generator through the updated discriminator (eval
    mode) with the colour, texture and LPIPS terms against its own input.
    Both packages in float64 from the same state: the six losses, both
    networks and the statistics."""
    tg, td, gv, dv = _dsgan()
    kw = dict(DSGAN, lpips_weights=_lpips_npz(tmp_path / "lpips.npz"))
    batch = {"lr": _rand((1, SIDE, SIDE, 3), 9), "hr": _rand((1, SIDE, SIDE, 3), 10)}
    before = {"generator": gv["params"], "discriminator": dv["params"]}
    with monkeypatch.context() as mp:
        _float64_stand_ins(mp)
        with jax.enable_x64(True):
            jh = jax_model("fssrdsgan")(**kw)
            jh.module = jh.module.clone(dtype=jnp.float64)
            jh.discriminator = jfssr.DSGANDiscriminator(dtype=jnp.float64)
            jh._lpips.backbone = lpips_jax.AlexFeatures(dtype=jnp.float64)
            jh._lpips.params, jh._lpips.lins = _f64(jh._lpips.params), _f64(jh._lpips.lins)
            params = _f64(before)
            js = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state={"generator": jh.tx.init(params["generator"]),
                                       "discriminator": jh.d_tx.init(params["discriminator"])},
                            extra={"d_bstats": _f64(dv["batch_stats"])},
                            rng=jax.random.PRNGKey(0))
            jh.set_epoch(200)
            js, jl = jh.train_batch(js, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
            want = jax.tree_util.tree_map(np.asarray, js.params)
            want_stats = jax.tree_util.tree_map(np.asarray, js.extra["d_bstats"])
        th = torch_model("fssrdsgan")(device="cpu", **kw)
        th.module.generator.load_state_dict(tg.state_dict())
        th.discriminator.load_state_dict(td.state_dict())
        _port_float64(mp, th.module, th.lpips)
        th.set_epoch(200)
        assert th._lr_factor() == jh._lr_factor() == 1.0 - 50 / 150
        state, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(v).double()
                                                     for k, v in batch.items()})
        got = jax_tree_from_state_dict(state.params, th.module)
        got_stats = jax_tree_from_state_dict(state.params, th.module, "batch_stats")
    assert set(tl) == set(jl) == {"train-loss", "generator-loss", "discriminator-loss",
                                  "color-loss", "texture-loss", "perceptual-loss"}
    for k, w in jl.items():
        assert abs(float(tl[k]) - float(w)) <= F64_REL * abs(float(w)), k
    assert float(tl["perceptual-loss"]) > 0
    for part in ("generator", "discriminator"):
        _assert_f64_step(got[part], want[part], before[part])
    for g, w in zip(_leaves(got_stats["discriminator"]), _leaves(want_stats)):
        _close(g, w, F64_REL)


def test_lr_factor_matches_jax():
    """1 until ds_epochs - decay_epochs, then linear to 0 at ds_epochs; 1
    throughout without the custom scheduler."""
    for kw in ({}, dict(ds_epochs=10, decay_epochs=4), dict(global_scheduler=None)):
        jh = jax_model("fssrdsgan")(use_perceptual_loss=False, n_res_blocks=1, **kw)
        th = torch_model("fssrdsgan")(device="cpu", use_perceptual_loss=False, n_res_blocks=1,
                                      **kw)
        for epoch in (0, 5, 6, 8, 10, 149, 150, 200, 299, 300):
            jh.set_epoch(epoch)
            th.set_epoch(epoch)
            assert th._lr_factor() == jh._lr_factor(), (kw, epoch)


def test_refusals_and_aliases_match_jax():
    """fssrdsgan refuses to build without LPIPS weights unless the term is
    off, runs at scale 1 on the unmodified input; fssr is esrganfs."""
    for make in (jax_model, lambda n: (lambda **kw: torch_model(n)(device="cpu", **kw))):
        with pytest.raises(ValueError, match="lpips_weights"):
            make("fssrdsgan")(n_res_blocks=1)
        h = make("fssrdsgan")(n_res_blocks=1, use_perceptual_loss=False)
        assert h.scale == 1 and h.im_input == "unmodified" and (h.w_col, h.w_tex, h.w_per) == \
            (1.0, 0.005, 0.01)
        assert make("fssr")(nf=8, nb=1, gc=4, d_nf=4).use_filters
        assert not make("esrganfs")(nf=8, nb=1, gc=4, d_nf=4, use_filters=False).use_filters
    th = torch_model("fssrdsgan")(device="cpu", n_res_blocks=1, use_perceptual_loss=False)
    out = th.run_eval(th.init_state(), {"lr": np.full((1, 16, 16, 3), 0.5, np.float32)})
    assert tuple(out.shape) == (1, 16, 16, 3) and bool(((out > 0) & (out < 1)).all())
