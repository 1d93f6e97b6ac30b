"""The port's QRCAB (rumpy_tpu_torch.models.attention_manipulators) and the
fused RCAB kernel's per-image gate inputs, against the JAX package's QRCAB,
QCALayer and ParaCALayer, on the CPU: flax params carried over by the
weight bridge, inputs from a numpy seed. On the CPU the kernel wrapper runs
its plain version, ``rcab_reference`` / ``rcab_backward_reference``, which
these tests hold to flax's block and to ``jax.grad``.

Tolerances: f32 forward within 2e-5 of flax (the same f32 products summed
in another order); f32 gradients within 1e-4 of each gradient's largest
entry. bf16: flax rounds every op's output to bf16, the port only h1 and the
block's output (its gate inputs are float32), so they differ by bf16
rounding: the forward within 2**-7 of the largest output (measured up to
4.3e-3) and the gradients within 2**-4 of the largest entry of each
(measured up to 3.7e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import attention_manipulators as jam
from rumpy_tpu_torch.models import attention_manipulators as tam
from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

C, R = 16, 4
SHAPE = (2, 9, 11, C)
F32_ATOL, F32_GRAD_REL = 2e-5, 1e-4
BF16_REL, BF16_GRAD_REL = 2.0 ** -7, 2.0 ** -4

# (style, q_layer, metadata width): both ParaCALayer sizing branches (M > 15
# and M <= 15); modulate multiplies the gate by the metadata, so M = C.
CASES = [("standard", True, 24), ("standard", False, 5), ("max_concat", True, 24),
         ("max_concat", False, 5), ("mini_concat", True, 5), ("mini_concat", False, 24),
         ("modulate", True, C), ("modulate", False, C)]
IDS = [f"{s}-{'q' if q else 'noq'}-m{m}" for s, q, m in CASES]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    meta = rng.random((SHAPE[0], m)).astype(np.float32)
    cot = rng.standard_normal(SHAPE).astype(np.float32)
    return x, meta, cot


def _pair(style, q_layer, m, dtype="float32", seed=0):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jm = jam.QRCAB(C, R, style, q_layer=q_layer, num_metadata=m, dtype=jdt)
    x, meta, cot = _inputs(m, seed)
    params = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(meta))["params"])
    # move the zero-initialised biases off zero, so that each reaches the output
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    tm = tam.QRCAB(C, R, style, q_layer=q_layer, num_metadata=m, dtype=tdt)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    return jm, params, tm, x, meta, cot


def _port_forward(tm, x, meta, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    return tm(xt, torch.from_numpy(meta)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("style,q_layer,m", CASES, ids=IDS)
def test_qrcab_forward_matches_flax(style, q_layer, m):
    jm, params, tm, x, meta, _ = _pair(style, q_layer, m)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(meta)))
    with torch.inference_mode():
        got = _port_forward(tm, x, meta).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("style,q_layer,m", CASES, ids=IDS)
def test_qrcab_gradients_match_jax_grad(style, q_layer, m):
    """All parameters', the input's and the metadata's gradients: the
    kernel's plain backward (per-image bd/bu/scale gradients) and autograd
    of the small metadata ops before it, against jax.grad of flax's block."""
    jm, params, tm, x, meta, cot = _pair(style, q_layer, m, seed=1)

    def loss(p, xv, mv):
        return jnp.sum(jm.apply({"params": p}, xv, mv) * cot)

    gp, gx, gm = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(meta))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    mt = torch.from_numpy(meta).requires_grad_(True)
    out = tm(xt, mt).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = jax_tree_from_state_dict({k: p.grad for k, p in tm.named_parameters()}, tm)
    pairs = [("x", xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)),
             ("metadata", np.zeros_like(meta) if mt.grad is None else mt.grad.numpy(),
              np.asarray(gm))]  # standard without a q-layer ignores the metadata
    flat_want = jax.tree_util.tree_flatten_with_path(_np(gp))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(flat_want) == len(flat_got)
    pairs += [(jax.tree_util.keystr(k), flat_got[k], v) for k, v in flat_want]
    for name, got, want in pairs:
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= F32_GRAD_REL * scale, name


@pytest.mark.parametrize("style,q_layer,m", [CASES[2], CASES[4], CASES[6]],
                         ids=[IDS[2], IDS[4], IDS[6]])
def test_qrcab_bf16_matches_flax_bf16(style, q_layer, m):
    jm, params, tm, x, meta, cot = _pair(style, q_layer, m, dtype="bf16", seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jm.apply({"params": params}, xb, jnp.asarray(meta)).astype(jnp.float32))
    with torch.inference_mode():
        got = _port_forward(tm, x, meta, torch.bfloat16).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()

    def loss(p):
        out = jm.apply({"params": p}, xb, jnp.asarray(meta)).astype(jnp.float32)
        return jnp.sum(out * cot)

    gp = _np(jax.grad(loss)(params))
    out = _port_forward(tm, x, meta, torch.bfloat16).float()
    (out * torch.from_numpy(cot)).sum().backward()
    grads = jax_tree_from_state_dict({k: p.grad for k, p in tm.named_parameters()}, tm)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for k, want in jax.tree_util.tree_flatten_with_path(gp)[0]:
        got = flat_got[k]
        assert np.abs(got - want).max() <= BF16_GRAD_REL * np.abs(want).max(), \
            jax.tree_util.keystr(k)


@pytest.mark.parametrize("style", tam.KERNEL_STYLES)
def test_qcalayer_kernel_inputs_give_flax_attention(style):
    """Each style's per-image kernel inputs, put through the gate the kernel
    computes, give the attention flax's QCALayer sows."""
    m = C if style == "modulate" else 7
    rng = np.random.default_rng(3)
    h2 = rng.standard_normal((3, 5, 6, C)).astype(np.float32)
    meta = rng.random((3, m)).astype(np.float32)
    jl = jam.QCALayer(C, style, R, m)
    params = _np(jl.init(jax.random.PRNGKey(4), jnp.asarray(h2), jnp.asarray(meta))["params"])
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    _, inter = jl.apply({"params": params}, jnp.asarray(h2), jnp.asarray(meta),
                        mutable=["intermediates"])
    want = np.asarray(inter["intermediates"]["attention"][0]).reshape(3, C)

    tl = tam.QCALayer(C, style, R, m)
    tl.load_state_dict(state_dict_from_jax(params, tl))
    wd, bd = tl.down.weight.flatten(1).t(), tl.down.bias
    wu, bu = tl.up.weight.flatten(1).t(), tl.up.bias
    wd, bd, wu, bu, scale = tl.kernel_inputs(wd, bd, wu, bu, torch.from_numpy(meta))
    gap = torch.from_numpy(h2).mean(dim=(1, 2))
    u = torch.sigmoid(torch.relu(gap @ wd + bd) @ wu + bu)
    got = (u if scale is None else u * scale).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m", [256, 24, 5])
def test_paracalayer_matches_flax(m):
    """Widths by Python floor division of a negative number ((64 - 256) //
    2 + 256 = 160 at full width) and the gate on the feature map."""
    assert tam.para_ca_widths(64, 256) == (160, 64)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((2, 4, 5, C)).astype(np.float32)
    meta = rng.random((2, m)).astype(np.float32)
    jl = jam.ParaCALayer(C, m)
    params = _np(jl.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(meta))["params"])
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(meta)))
    tl = tam.ParaCALayer(C, m)
    assert [c.weight.shape[0] for c in tl.convs] == list(tam.para_ca_widths(C, m))
    tl.load_state_dict(state_dict_from_jax(params, tl))
    with torch.inference_mode():
        got = tl(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(meta)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


UNFOLDABLE = [(dict(style="softmax"), dict(style="softmax")),
              (dict(style="extended_attention"), dict(style="extended_attention")),
              (dict(pa=True), dict(include_pixel_attention=True)),
              (dict(sft_layer=True), dict(include_sft_layer=True))]


@pytest.mark.parametrize("block_kw,net_kw", UNFOLDABLE,
                         ids=["softmax", "extended_attention", "pa", "sft_layer"])
def test_unfoldable_options_raise(block_kw, net_kw):
    """The options the fused kernel cannot absorb, which raised before they
    were ported, now build the plain route: a QRCAB with one of them (and
    a q-layer) against flax's block, forward and every gradient, and a
    QRCAN with it against flax's network."""
    m = 5
    kw = {"style": "max_concat", **block_kw}
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    meta = rng.random((SHAPE[0], m)).astype(np.float32)
    maps = np.broadcast_to(meta[:, None, None, :], SHAPE[:3] + (m,)).copy()
    cot = rng.standard_normal(SHAPE).astype(np.float32)
    jm = jam.QRCAB(C, R, q_layer=True, num_metadata=m, **kw)
    args = (jnp.asarray(x), jnp.asarray(meta), jnp.asarray(maps))
    params = _np(jm.init(jax.random.PRNGKey(7), *args)["params"])
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    tm = tam.QRCAB(C, R, q_layer=True, num_metadata=m, **kw)
    assert not tm.fused
    tm.load_state_dict(state_dict_from_jax(params, tm))
    want = np.asarray(jm.apply({"params": params}, *args))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = tm(xt, torch.from_numpy(meta), torch.from_numpy(maps).permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    gp, gx = jax.grad(lambda p, xv: jnp.sum(jm.apply({"params": p}, xv, *args[1:]) * cot),
                      argnums=(0, 1))(params, args[0])
    (out * torch.from_numpy(cot)).sum().backward()
    grads = jax_tree_from_state_dict({k: p.grad for k, p in tm.named_parameters()}, tm)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    pairs = [("x", xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx))]
    pairs += [(jax.tree_util.keystr(k), flat_got[k], v)
              for k, v in jax.tree_util.tree_flatten_with_path(_np(gp))[0]]
    for name, got, w in pairs:
        assert np.abs(got - w).max() <= F32_GRAD_REL * max(np.abs(w).max(), 1e-6), name

    net = dict(n_feats=C, n_resgroups=1, n_resblocks=2, reduction=R, num_metadata=m,
               include_q_layer=True, scale=2, **{"style": "max_concat", **net_kw})
    jn = jam.QRCAN(**net)
    xi = rng.random((2, 6, 7, 3)).astype(np.float32)
    nmaps = np.broadcast_to(meta[:, None, None, :], (2, 6, 7, m)).copy()
    nargs = (jnp.asarray(xi), jnp.asarray(meta), jnp.asarray(nmaps))
    nparams = _np(jn.init(jax.random.PRNGKey(8), *nargs)["params"])
    tn = tam.QRCAN(**net)
    tn.load_state_dict(state_dict_from_jax(nparams, tn))
    with torch.inference_mode():
        got = tn(torch.from_numpy(xi).permute(0, 3, 1, 2), torch.from_numpy(meta),
                 torch.from_numpy(nmaps).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jn.apply({"params": nparams}, *nargs)),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("per_image", ["bd", "bu", "scale", "all"])
def test_wrapper_per_image_inputs_shapes_and_reference(per_image):
    """Per-image bd (N, R), bu (N, C) and scale (N, C) run the plain version
    on CPU tensors, give gradients of their inputs' shapes, and a shared
    vector repeated per image gives the shared form's output."""
    rng = np.random.default_rng(6)
    n, h, w = 3, 5, 7
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
    args = [t(n, h, w, C), t(9, C, C), t(C), t(9, C, C), t(C), t(C, R), t(R), t(R, C), t(C)]
    shared = rcab.rcab_reference(*args, res_scale=0.5)
    pe = list(args)
    scale = 0.5
    if per_image in ("bd", "all"):
        pe[6] = args[6].expand(n, R).clone()
    if per_image in ("bu", "all"):
        pe[8] = args[8].expand(n, C).clone()
    if per_image in ("scale", "all"):
        scale = torch.full((n, C), 0.5)
    np.testing.assert_array_equal(rcab.rcab_fused(*pe, res_scale=scale).numpy(),
                                  shared.numpy())
    leaves = [a.requires_grad_(True) for a in pe]
    tensors = leaves + ([scale.requires_grad_(True)] if torch.is_tensor(scale) else [])
    out = rcab.rcab_fused(*leaves, res_scale=scale)
    grads = torch.autograd.grad(out, tensors, torch.ones_like(out))
    assert [g.shape for g in grads] == [a.shape for a in tensors]
    with pytest.raises(ValueError, match="bd has shape"):
        rcab.rcab_fused(*args[:6], t(n + 1, R), *args[7:])
    with pytest.raises(ValueError, match="res_scale has shape"):
        rcab.rcab_fused(*args, res_scale=torch.ones(n, C + 8))
