"""The attribute-conditioned face GANs' networks in the port, on the CPU,
against the JAX package (``rumpy_tpu/models/face_attribute_gans.py``):
the STN's ``affine_grid`` (its base row bit for bit against the jitted
``jnp.linspace`` at 32 and 64, and the whole grid at the identity) and
``grid_sample`` (forward off the pixel grid, zero outside; the gradient with
respect to theta at the identity and at a random theta against
``jax.grad``), ``Conv2dSame`` at odd and even sizes, a dilated ``TConv``,
and every network of the module: the FaceSR-Attributes generator and
discriminator (eval mode, and train mode with the JAX side's dropout
masks), AGA-GAN's generator, discriminator and U-Net, FMFNet's generator,
discriminator and attribute discriminator, and the options their
handlers leave at the defaults (FaceSR without STNs and with the attribute
encoder, AGA-GAN's conv up-layer, FMFNet without meta-attention, its
discriminator's logits).

Weights come from the port's seeded init, jittered, through the weight
bridge (flax's eager init of these networks takes seconds to half a
minute, so each JAX network's tree is checked against ``jax.eval_shape``
of its init instead, once a module); inputs come from a numpy seed.
Tolerances: forwards within 1e-5 of the largest output; theta-gradients
within 2e-5 of the largest entry (float32 sums over the grid in another
order); grids bit for bit.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rumpy_tpu.models import face_attribute_gans as jfag
from rumpy_tpu_torch.models import face_attribute_gans as tfag
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_REL, GRAD_REL = 1e-5, 2e-5
NA = 8  # attributes at the narrow widths


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            t.add_(0.02 * torch.rand(t.shape, generator=gen) if "running_var" in name
                   else 0.02 * torch.randn(t.shape, generator=gen))
    return module.eval()


def _variables(module):
    out = {"params": jax_tree_from_state_dict(module.state_dict(), module)}
    stats = jax_tree_from_state_dict(module.state_dict(), module, "batch_stats")
    if stats:
        out["batch_stats"] = stats
    return out


# name: (JAX module, port module, input NHWC shape, takes metadata)
NETWORKS = {
    "facesr_generator": (lambda: jfag.FaceSRAttributesGenerator(n_feats=4, n_attributes=NA),
                         lambda: tfag.FaceSRAttributesGenerator(4, NA), (16, 16, 3), True),
    "facesr_discriminator": (
        lambda: jfag.FaceSRAttributesDiscriminator(n_feats=4, n_attributes=NA),
        lambda: tfag.FaceSRAttributesDiscriminator(4, NA), (128, 128, 3), True),
    "agagan_generator": (lambda: jfag.AGAGANGenerator(n_feats=8, n_attributes=NA),
                         lambda: tfag.AGAGANGenerator(8, NA), (16, 16, 3), True),
    "agagan_discriminator": (lambda: jfag.AGAGANDiscriminator(n_feats=4, n_attributes=NA),
                             lambda: tfag.AGAGANDiscriminator(4, NA), (128, 128, 3), True),
    "agagan_unet": (lambda: jfag.AGAGANUNet(n_feats=4), lambda: tfag.AGAGANUNet(4),
                    (32, 32, 6), False),
    "fmf_generator": (lambda: jfag.FMFResidualDenseNet(n_feats=8, n_attributes=NA),
                      lambda: tfag.FMFResidualDenseNet(NA, 8), (16, 16, 3), True),
    "fmf_discriminator": (lambda: jfag.FMFDiscriminator(n_feats=4),
                          lambda: tfag.FMFDiscriminator(4), (128, 128, 3), False),
    "fmf_attribute_discriminator": (
        lambda: jfag.FMFAttributeDiscriminator(n_feats=4, n_attributes=NA),
        lambda: tfag.FMFAttributeDiscriminator(4, NA), (128, 128, 3), False),
    # the options the handlers leave at their defaults
    "facesr_generator_no_stn_attribute_encoder": (
        lambda: jfag.FaceSRAttributesGenerator(n_feats=4, n_attributes=NA, remove_stn=True,
                                               use_attribute_encoder=True),
        lambda: tfag.FaceSRAttributesGenerator(4, NA, remove_stn=True,
                                               use_attribute_encoder=True), (16, 16, 3), True),
    "facesr_discriminator_attribute_encoder": (
        lambda: jfag.FaceSRAttributesDiscriminator(n_feats=4, n_attributes=NA,
                                                   use_attribute_encoder=True),
        lambda: tfag.FaceSRAttributesDiscriminator(4, NA, use_attribute_encoder=True),
        (128, 128, 3), True),
    "agagan_generator_conv_up": (
        lambda: jfag.AGAGANGenerator(n_feats=8, n_attributes=NA, use_transpose=False),
        lambda: tfag.AGAGANGenerator(8, NA, use_transpose=False), (16, 16, 3), True),
    "fmf_generator_no_meta_attention": (
        lambda: jfag.FMFResidualDenseNet(n_feats=8, n_attributes=NA, use_meta_attention=False),
        lambda: tfag.FMFResidualDenseNet(NA, 8, use_meta_attention=False), (16, 16, 3), True),
    "fmf_discriminator_logits": (lambda: jfag.FMFDiscriminator(n_feats=4, use_sigmoid=False),
                                 lambda: tfag.FMFDiscriminator(4, use_sigmoid=False),
                                 (128, 128, 3), False),
}


@functools.lru_cache(maxsize=None)
def _network(name):
    """The JAX module, the port's seeded module and its flax variables,
    whose tree (names, nesting, shapes) is the flax init's."""
    make_jax, make_port, shape, meta = NETWORKS[name]
    jm, tm = make_jax(), _seeded(make_port(), sum(map(ord, name)))
    variables = _variables(tm)
    args = [jnp.zeros((1,) + shape)] + ([jnp.zeros((1, NA))] if meta else [])
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    init = jax.eval_shape(lambda *a: jm.init(rngs, *a), *args)
    assert (jax.tree_util.tree_structure(init)
            == jax.tree_util.tree_structure(variables)), name
    assert ([a.shape for a in jax.tree_util.tree_leaves(init)]
            == [a.shape for a in jax.tree_util.tree_leaves(variables)]), name
    return jm, tm, variables


def _inputs(name, seed):
    _, _, shape, meta = NETWORKS[name]
    rng = np.random.default_rng(seed)
    x = rng.random((2,) + shape).astype(np.float32)
    m = (rng.random((2, NA)) > 0.5).astype(np.float32) if meta else None
    return x, m


# -- the STN's grid ----------------------------------------------------------------

@pytest.mark.parametrize("n", [32, 64])
def test_base_grid_is_jitted_jnp_linspace_bit_for_bit(n):
    """The base row against ``jnp.linspace(-1, 1, n)`` under jit (how the
    JAX networks compute it: XLA turns the division by n - 1 into a product
    by its reciprocal; an eager call rounds a few values otherwise), and
    the whole identity grid against the JAX ``affine_grid`` under jit, in
    float32 and float64."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n))())
    got = tfag._linspace(n, torch.zeros(())).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got != torch.linspace(-1, 1, n).numpy()).sum() > n // 4  # torch's own differs
    ident = np.array([[[1, 0, 0], [0, 1, 0]]] * 2, np.float32)
    want = np.asarray(jax.jit(lambda t: jfag.affine_grid(t, n, n))(jnp.asarray(ident)))
    got = tfag.affine_grid(torch.from_numpy(ident), n, n).numpy()
    assert got.shape == (2, n, n, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n))())
    got = tfag._linspace(n, torch.zeros((), dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_grid_sample_matches_jax_off_the_grid():
    """Bilinear samples at random points, some outside the image (zeros
    there), on a 2 x 9 x 11 x 3 input."""
    x = _rand((2, 9, 11, 3), 1)
    grid = (_rand((2, 7, 5, 2), 2) * 2.6 - 1.3).astype(np.float32)
    want = np.asarray(jfag.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = tfag.grid_sample(torch.from_numpy(x), torch.from_numpy(grid)).numpy()
    assert got.shape == (2, 7, 5, 3)
    _close(got, want, F32_REL)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("at", ["identity", "random"])
def test_stn_theta_gradient_matches_jax_grad(n, at):
    """The gradient of a probe of ``grid_sample(x, affine_grid(theta))``
    with respect to theta against ``jax.grad`` under jit, at the identity
    (every sample on a pixel: which side ``floor`` lands decides it) and at
    a random theta. At the identity torch's own ``F.affine_grid`` /
    ``F.grid_sample`` give another gradient (their grid rounds otherwise):
    the port does not use them."""
    rng = np.random.default_rng(n)
    x = rng.random((2, n, n, 4)).astype(np.float32)
    probe = rng.standard_normal((2, n, n, 4)).astype(np.float32)
    theta = np.array([[[1, 0, 0], [0, 1, 0]]] * 2, np.float32)
    if at == "random":
        theta = theta + 0.05 * rng.standard_normal((2, 2, 3)).astype(np.float32)

    def loss(t):
        return (jfag.grid_sample(jnp.asarray(x), jfag.affine_grid(t, n, n)) * probe).sum()

    want_v, want = jax.jit(jax.value_and_grad(loss))(jnp.asarray(theta))
    t = torch.from_numpy(theta.copy()).requires_grad_(True)
    got_v = (tfag.grid_sample(torch.from_numpy(x), tfag.affine_grid(t, n, n))
             * torch.from_numpy(probe)).sum()
    got_v.backward()
    _close(got_v.detach().numpy(), want_v, F32_REL)
    _close(t.grad.numpy(), want, GRAD_REL)
    if at == "identity":
        t2 = torch.from_numpy(theta.copy()).requires_grad_(True)
        grid = F.affine_grid(t2, (2, 4, n, n), align_corners=True)
        out = F.grid_sample(_nchw(x), grid, align_corners=True)
        (out.permute(0, 2, 3, 1) * torch.from_numpy(probe)).sum().backward()
        want = np.asarray(want)
        assert np.abs(t2.grad.numpy() - want).max() > 0.1 * np.abs(want).max()


# -- the torch-semantics convs --------------------------------------------------------

@pytest.mark.parametrize("side", [15, 16])
@pytest.mark.parametrize("k", [4, 2])
def test_conv2d_same_matches_jax(side, k):
    """Conv2dSame at stride 2 (the odd padding pixel at the end) on an odd
    and an even side."""
    x = _rand((2, side, side + 3, 5), k + side)
    jm = jfag.Conv2dSame(6, k, 2)
    tm = _seeded(tfag._conv_same(5, 6, k, 2), k)
    params = jax_tree_from_state_dict(tm.state_dict(), tm)
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    assert init["params"]["TConv_0"]["kernel"].shape == params["kernel"].shape
    want = np.asarray(jm.apply({"params": {"TConv_0": params}}, jnp.asarray(x)))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, -(-side // 2), -(-(side + 3) // 2), 6)
    _close(got, want, F32_REL)


def test_dilated_tconv_matches_jax():
    """TConv(3, 1, pad 3, dilation 3): FMFNet's dilated encoders."""
    x = _rand((2, 16, 16, 5), 3)
    jm = jfag.TConv(6, 3, 1, 3, 3)
    tm = _seeded(tfag._tconv(5, 6, 3, 1, 3, 3), 3)
    want = np.asarray(jm.apply({"params": {"TConv_0": jax_tree_from_state_dict(
        tm.state_dict(), tm)}}, jnp.asarray(x)))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, 16, 16, 6)
    _close(got, want, F32_REL)


# -- the networks -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(NETWORKS))
def test_network_matches_jax(name):
    """Eval-mode forward (the generators' BatchNorm on running statistics,
    the discriminators without dropout), and the bridge back bit for bit."""
    jm, tm, variables = _network(name)
    x, m = _inputs(name, 7)
    args = [jnp.asarray(x)] + ([jnp.asarray(m)] if m is not None else [])
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    targs = [_nchw(x)] + ([torch.from_numpy(m)] if m is not None else [])
    with torch.no_grad():
        got = tm(*targs)
    got = _nhwc(got) if got.dim() == 4 else got.numpy()
    assert got.shape == want.shape
    _close(got, want, F32_REL)
    back = state_dict_from_jax(variables["params"], tm,
                               batch_stats=variables.get("batch_stats"))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in back.items())
    assert set(back) == set(tm.state_dict())


def _dropout_masks(jm, variables, key, x, m):
    """The keep masks flax's three Dropouts draw from ``key`` in a
    train-mode call of the FaceSR discriminator: each dropout's input
    replaced by ones, its output is nonzero where kept. (N, C) for the two
    channel dropouts, (N, 1024) for the dense one."""
    taken = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            mask = np.asarray(out) != 0
            taken.append(mask[:, 0, 0, :] if mask.ndim == 4 else mask)
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jm.apply(variables, x, m, train=True, rngs={"dropout": key})
    return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in taken)


def test_facesr_discriminator_train_mode_matches_jax_with_its_masks():
    """Train mode with the JAX call's dropout masks injected: two channel
    dropouts at 0.2 (whole maps) and a dense one at 0.5."""
    jm, tm, variables = _network("facesr_discriminator")
    x, m = _inputs("facesr_discriminator", 8)
    key = jax.random.PRNGKey(4)
    keep = _dropout_masks(jm, variables, key, jnp.asarray(x), jnp.asarray(m))
    assert [tuple(k.shape) for k in keep] == tm.mask_shapes(2)
    assert all(0 < float(k.float().mean()) < 1 for k in keep)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(m), train=True,
                               rngs={"dropout": key}))
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(m), train=True, keep=keep).numpy()
        evals = tm(_nchw(x), torch.from_numpy(m)).numpy()
    _close(got, want, F32_REL)
    assert not np.allclose(got, evals)
