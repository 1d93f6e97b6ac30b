"""The GAN group's handler in the port, on the CPU, against the JAX
package (``rumpy_tpu/models/gan_models.py``): one pre-train step and one
adversarial step for each ``gan_mode`` against ``_pretrain_step_impl`` and
``_gan_step_impl`` (losses, generator and discriminator parameters, the
discriminator's state after its four updates), the VGG-19 content term
included; the discriminator without gradient from the generator loss and
its state advancing four times a step. The networks, the feature
extractors, the conjugations, the checkpoints and the CLIs are in
``test_torch_gan.py``, whose helpers this file takes.

Flax params are carried over by the weight bridge (biases jittered off
zero), inputs come from a numpy seed. Tolerances: a train step under SGD at
lr 1 (a parameter moves by its gradient) within 1e-4 of each leaf's
largest move plus two float32 ulps, losses within 1e-5 of their value,
BatchNorm statistics within 1e-6; the relativistic step's updates in
float64 in both packages within 1e-9 of each move.
"""



import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import feature_extractors as jfe
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import gan_models as tgan
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict

from test_torch_gan import (STEP_CASES, _assert_gan_step, _assert_losses, _assert_moves, _gan_batch,
                            _gan_kwargs, _gan_pair, _jnp, _nchw, _np, vgg_npz)
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)


# -- the GAN handler ---------------------------------------------------------------

def _jax_f64_step(name, mode, kw, js, batch):
    """The JAX handler's adversarial step in float64 from the same state:
    its modules rebuilt with dtype float64 (flax casts params and inputs to
    it). Returns the params after it, in float64."""
    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
    with jax.enable_x64(True):
        h = jax_model(name)(**kw)
        h.gan_mode = mode
        h.set_epoch(1)
        h.dtype = jnp.float64
        h.module = h.build_module(**h.model_kwargs)
        h.discriminator = h.build_discriminator()
        if h.vgg_module is not None:
            h.vgg_module = jfe.VGG19Features(tap=h.vgg_module.tap, dtype=jnp.float64)
            h._vgg_params = f64(h._vgg_params)
        params = f64(_np(js.params))
        opt = {"generator": h.main_tx.init(params["generator"]),
               "discriminator": h.d_tx.init(params["discriminator"])}
        state = jax.tree_util.tree_map(jnp.copy, js).replace(
            params=params, opt_state=opt, extra={"d_vars": f64(_np(js.extra["d_vars"]))})
        out, _ = h.train_batch(state, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        return _np(out.params)


def _port_f64_step(th, batch, monkeypatch):
    """The port handler's step in float64 from its current state: its
    modules in float64 and every ``Tensor.float()`` (the losses' and
    BatchNorm's float32 statistics) widened to float64. Returns the
    params before and after it, in flax's tree, in float64."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    th.module.double()
    for m in th.module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    th._optimizers = {}
    state = th._own_state()
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, _ = th.train_batch(state, {k: torch.from_numpy(v).double() for k, v in batch.items()})
    return before, jax_tree_from_state_dict(state2.params, th.module)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pretrain_step_matches_jax(case):
    """Epoch 0 of 1 pre-training epoch: the L1 step on the pre-train
    optimizer, the discriminator untouched, the loss keys of the JAX step."""
    jh, js, th = _gan_pair(case)
    state = th._own_state()
    batch = _gan_batch(case, 1)
    jh.set_epoch(0)
    th.set_epoch(0)
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    state2, tl = th.train_batch(state, batch)
    _assert_losses(tl, jl)
    _assert_moves(th.module.generator, {k[len("generator."):]: v for k, v in
                                        state2.params.items() if k.startswith("generator.")},
                  before["generator"], js2.params["generator"])
    d_after = jax_tree_from_state_dict(state2.params, th.module)["discriminator"]
    for g, b in zip(jax.tree_util.tree_leaves(d_after),
                    jax.tree_util.tree_leaves(before["discriminator"])):
        np.testing.assert_array_equal(g, b)
    assert set(th._optimizers) == {"generator_pre"}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_gan_step_matches_jax(case, monkeypatch):
    """Past pre-training: one adversarial step per gan_mode (lsgan, bce
    against the U-Net SN discriminator; relativistic against VGG-128): the
    losses, both networks' updates and the discriminator's state after its
    four train-mode calls.

    VGG-128's last BatchNorms normalise 2 x 4 x 4 values a channel by
    E[x^2] - E[x]^2, on the generator's near-flat output too, which
    amplifies float32 rounding: JAX's float32 step stands percents of a
    move off its float64 step in the discriminator, the port's in the
    generator's tail (the test prints both). So for relativistic the
    float32 step holds the losses and the statistics, and both packages'
    steps in float64 hold the updates: within 1e-9 of each move."""
    jh, js, th = _gan_pair(case)
    jh.set_epoch(1)
    th.set_epoch(1)
    batch = _gan_batch(case, 2)
    tl = _assert_gan_step(jh, js, th, batch, moves=case != "relativistic")
    assert set(tl) == {"train-loss", "l1-loss", "gan-loss", "vgg-loss", "d-loss-real",
                       "d-loss-fake"}
    assert float(tl["vgg-loss"]) == 0.0
    assert set(th._optimizers) == {"generator", "discriminator"}
    if case == "relativistic":
        name, mode, _ = STEP_CASES[case]
        truth = _jax_f64_step(name, mode, _gan_kwargs(), js, batch)
        js32, _ = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
        port32 = jax_tree_from_state_dict(th._own_state().params, th.module)
        _, _, th = _gan_pair(case)
        th.set_epoch(1)
        before, after = _port_f64_step(th, batch, monkeypatch)
        for part in ("generator", "discriminator"):
            off = {"jax f32": 0.0, "port f32": 0.0, "port f64": 0.0}
            for (path, w), g, b, j32, p32 in zip(
                    jax.tree_util.tree_flatten_with_path(truth[part])[0],
                    *(jax.tree_util.tree_leaves(t[part]) for t in (
                        after, before, _np(js32.params), port32))):
                move = np.abs(w - b).max()
                err = np.abs(g - w).max()
                assert move > 0 and err <= 1e-9 * move, jax.tree_util.keystr(path)
                for k, v in (("jax f32", j32), ("port f32", p32), ("port f64", g)):
                    off[k] = max(off[k], float(np.abs(v - w).max() / move))
            print(f"{part}: largest distance from JAX's float64 step, in moves: {off}")


def test_vgg_content_term_matches_jax(vgg_npz, monkeypatch):
    """ESRGAN with the VGG-19 conv5_4 content term from the seeded npz: the
    step's losses (``vgg-loss`` among them) against JAX's; the term's
    gradient with respect to SR in float64 in both packages, within 1e-9 of
    its largest entry. In float32 that gradient passes 16 ReLUs and 4 max
    pools whose masks the rounding of CPU conv algorithms flips: the port's
    stands about 4e-3 in relative L2 off the float64 one (the test prints
    both packages'); it is
    held within 1e-2."""
    jh, js, th = _gan_pair("relativistic", vgg=vgg_npz)
    jh.set_epoch(1)
    th.set_epoch(1)
    batch = _gan_batch("relativistic", 2)
    _, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    _, tl = th.train_batch(th._own_state(), batch)
    _assert_losses(tl, jl)
    assert float(tl["vgg-loss"]) > 0
    sr, hr = (np.random.default_rng(s).random((2, 128, 128, 3)).astype(np.float32)
              for s in (15, 16))
    params = jfe.load_extractor_params(vgg_npz)

    def content(s, dtype):
        m = jfe.VGG19Features(tap="conv5_4", dtype=dtype)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        real = jax.lax.stop_gradient(m.apply({"params": p}, jnp.asarray(hr, dtype)))
        return jnp.mean(jnp.abs(m.apply({"params": p}, s) - real))

    with jax.enable_x64(True):
        g64 = np.asarray(jax.grad(lambda v: content(v, jnp.float64))(
            jnp.asarray(sr, jnp.float64)))

    def port_grad(module, dtype):
        x = torch.from_numpy(sr).to(dtype).requires_grad_(True)
        gen = module(x.permute(0, 3, 1, 2))
        with torch.no_grad():
            real = module(_nchw(hr).to(dtype))
        (gen - real).abs().mean().backward()
        return x.grad.numpy()

    g32 = port_grad(th.vgg_module, torch.float32)
    with jax.enable_x64(False):
        jax32 = np.asarray(jax.grad(lambda v: content(v, jnp.float32))(jnp.asarray(sr)))
    rel = lambda g: float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
    print(f"content gradient, relative L2 from float64: port f32 {rel(g32):.3g}, "
          f"JAX f32 {rel(jax32):.3g}")
    assert rel(g32) <= 1e-2
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    vgg = th.vgg_module.double()
    for m in vgg.convs:
        m.dtype = torch.float64
    assert np.abs(port_grad(vgg, torch.float64) - g64).max() <= 1e-9 * np.abs(g64).max()


def test_discriminator_takes_no_gradient_from_the_generator_loss(monkeypatch):
    """At the generator update every discriminator parameter's ``.grad`` is
    None; the discriminator's own update sees only its loss's gradients,
    which equal a fresh backward of that loss alone."""
    _, _, th = _gan_pair("lsgan")
    th.set_epoch(1)
    seen = {}
    real = tgan.BaseGANHandler._update

    def spy(self, name, loss):
        real(self, name, loss)
        if name == "generator":
            seen["d_grads"] = [p.grad for p in self.discriminator.parameters()]
            seen["d_requires_grad"] = [p.requires_grad for p in self.discriminator.parameters()]
        else:
            seen["d_update_grads"] = [p.grad.clone() for p in self.discriminator.parameters()]

    monkeypatch.setattr(tgan.BaseGANHandler, "_update", spy)
    th.train_batch(th._own_state(), _gan_batch("lsgan", 3))
    assert seen["d_grads"] and all(g is None for g in seen["d_grads"])
    assert not any(seen["d_requires_grad"])
    assert all(p.requires_grad for p in th.discriminator.parameters())
    assert any(float(g.abs().max()) > 0 for g in seen["d_update_grads"])


def test_discriminator_state_advances_four_times_a_step():
    """Every spectral-norm ``u`` is written by the two generator-pass and
    the two discriminator-pass calls: four writes a step."""
    _, _, th = _gan_pair("lsgan")
    th.set_epoch(1)
    writes = []
    hooks = [m.register_forward_hook(lambda m, a, o: writes.append(m))
             for m in th.discriminator.sn]
    th.train_batch(th._own_state(), _gan_batch("lsgan", 4))
    for h in hooks:
        h.remove()
    assert len(writes) == 4 * len(th.discriminator.sn)
