"""Gradients of the port's RCAB block (rumpy_tpu_torch.ops.cuda.rcab_fused)
against jax.grad of the JAX package's rcab_reference, on the CPU.

The Pallas kernel is forward-only, so its XLA twin is the yardstick. On the
CPU the port's autograd.Function runs the plain versions of both
directions; the CUDA backward kernel is held against them on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.ops.pallas import rcab_fused as jrcab
from rumpy_tpu_torch.models import common as tcommon
from rumpy_tpu_torch.ops.cuda import rcab_fused as trcab
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

NAMES = ["x", "w1", "b1", "w2", "b2", "wd", "bd", "wu", "bu"]


def _inputs(seed, shape=(2, 9, 7, 16), r=4):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    args = [f(n, h, w, c), f(9, c, c, sc=0.1), f(c, sc=0.1), f(9, c, c, sc=0.1),
            f(c, sc=0.1), f(c, c // r, sc=0.3), f(c // r, sc=0.1),
            f(c // r, c, sc=0.3), f(c, sc=0.1)]
    return args, f(n, h, w, c)


def _jax_grads(args, dout):
    """Gradients of sum(out * dout) for all nine inputs, float32."""
    loss = lambda *a: (jrcab.rcab_reference(*a) * jnp.asarray(dout)).sum()
    grads = jax.grad(loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))
    return [np.asarray(g) for g in grads]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("via", ["reference", "function"])
@pytest.mark.parametrize("res_scale", [1.0, 0.5])
def test_rcab_gradients_match_jax_f32(via, res_scale):
    """All nine gradients within 1e-4 of the largest gradient entry, from
    autograd of the plain version and from the autograd.Function."""
    args, dout = _inputs(0)
    want = _jax_grads(args, dout * res_scale)
    # the JAX block has no res_scale: d/dx picks up dout * (1 - res_scale)
    want[0] = want[0] + dout * (1.0 - res_scale)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    fn = trcab.rcab_reference if via == "reference" else trcab.rcab_fused
    out = fn(*targs, res_scale=res_scale)
    if via == "function":
        assert "RCABFunction" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(dout))
    for name, t, w in zip(NAMES, targs, want):
        assert _rel(t.grad.numpy(), w) < 1e-4, name


def test_backward_reference_is_autograd_of_the_forward_reference():
    args, dout = _inputs(1)
    targs = [torch.from_numpy(a) for a in args]
    got = trcab.rcab_backward_reference(torch.from_numpy(dout), *targs, res_scale=0.5)
    want = _jax_grads(args, dout * 0.5)
    want[0] = want[0] + dout * 0.5
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w) < 1e-4, name


def test_rcab_gradients_match_jax_bf16():
    """bf16 activations and conv weights, f32 accumulation, against
    jax.grad in f32 at the same bf16-valued inputs (jax.grad of the JAX
    rcab_reference does not take bf16: its transposed convolution refuses
    the mixed types). The port rounds h1, dh1 and dx to bf16, the f32
    yardstick does not, so a gradient may be off by a few bf16 ulps of its
    largest entry: within 2**-6 of it (four ulps), against 1e-4 in f32."""
    args, dout = _inputs(2)
    act = (0, 1, 3)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = [bf(a).float().numpy() if i in act else a for i, a in enumerate(args)]
    dout = bf(dout).float().numpy()
    want = _jax_grads(args, dout)
    targs = [(bf(a) if i in act else torch.from_numpy(a)).requires_grad_(True)
             for i, a in enumerate(args)]
    out = trcab.rcab_fused(*targs)
    assert out.dtype == torch.bfloat16
    out.backward(bf(dout))
    assert targs[0].grad.dtype == torch.bfloat16
    for name, t, w in zip(NAMES, targs, want):
        assert _rel(t.grad.float().numpy(), w) < 2.0 ** -6, name


def test_no_gradient_path_skips_the_function():
    args, _ = _inputs(3)
    targs = [torch.from_numpy(a) for a in args]
    assert trcab.rcab_fused(*targs).grad_fn is None
    targs[1].requires_grad_(True)
    with torch.no_grad():
        assert trcab.rcab_fused(*targs).grad_fn is None


def test_rcab_module_sends_gradients_to_its_parameters():
    """The module packs its live OIHW parameters for the kernel with
    differentiable layout ops: conv1, conv2, ca.down and ca.up all receive
    .grad, equal to those of the same block written with plain convs."""
    c, r = 16, 4
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, c, 9, 7)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    block = tcommon.RCAB(c, r, res_scale=0.5)
    gen = torch.Generator().manual_seed(0)
    for m in block.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)) * 0.05)
    dout = torch.from_numpy(rng.standard_normal((2, c, 9, 7)).astype(np.float32))
    block(x).backward(dout)
    got = {k: p.grad.clone() for k, p in block.named_parameters()}
    assert set(got) == {f"{m}.{k}" for m in ("conv1", "conv2", "ca.down", "ca.up")
                        for k in ("weight", "bias")}
    block.zero_grad()
    h = block.conv2(torch.relu(block.conv1(x)))
    (x + block.ca(h) * 0.5).backward(dout)
    for k, p in block.named_parameters():
        torch.testing.assert_close(got[k], p.grad, rtol=1e-4, atol=1e-5)
    # the eval path still caches its packed weights
    with torch.no_grad():
        block(x)
    assert block._packed[0] is not None


# --- the backward kernel's algorithm, walked tile by tile on the CPU ---------
#
# The CUDA backward never sees a whole image: it walks TH x TW tiles with a
# zero halo. These cases redo its sums with PyTorch ops only and hold them
# against rcab_backward_reference (autograd of the plain version):
#   * transposed conv: din[p] = sum_t g[p + t] . w[8 - t]^T (tap 8 - t of the
#     weights as they lie, no flipped copy);
#   * weight gradient: dw[t] = sum_p a[p + t]^T . g[p] over the tile's pixels p
#     with a on the halo, or (folded into the pass that holds g on the halo)
#     dw[t] = sum_q a[q]^T . g[q - t] over the tile's pixels q;
#   * a pixel outside the image contributes 0 without a mask.

def _tiles(t, th, tw, halo):
    """(y0, x0, tile) over an (N,H,W,C) tensor: TH x TW tiles, ragged ones
    zero-filled, with `halo` pixels of zeros or neighbours around."""
    n, h, w, c = t.shape
    ph, pw = -h % th, -w % tw
    padded = torch.nn.functional.pad(t, (0, 0, halo, halo + pw, halo, halo + ph))
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            yield y0, x0, padded[:, y0:y0 + th + 2 * halo, x0:x0 + tw + 2 * halo]


def _conv_by_tiles(src, w, th, tw, transposed):
    """3x3 SAME conv of (N,H,W,C) `src` with tap-major (9,C,C) weights, or
    its transpose (the gradient with respect to the conv's input)."""
    n, h, wd_, c = src.shape
    out = torch.zeros_like(src)
    for y0, x0, tile in _tiles(src, th, tw, 1):
        acc = torch.zeros(n, th, tw, c)
        for t in range(9):
            ty, tx = divmod(t, 3)
            k = w[8 - t].T if transposed else w[t]
            acc += tile[:, ty:ty + th, tx:tx + tw] @ k
        ye, xe = min(y0 + th, h), min(x0 + tw, wd_)
        out[:, y0:ye, x0:xe] = acc[:, :ye - y0, :xe - x0]
    return out


def _wgrad_by_tiles(a, g, th, tw, fold):
    """dw (9,C,C) of a 3x3 SAME conv with input `a` and output gradient `g`."""
    c = a.shape[-1]
    dw = torch.zeros(9, c, c)
    inner, outer = (a, g) if fold else (g, a)
    for (_, _, small), (_, _, big) in zip(_tiles(inner, th, tw, 0), _tiles(outer, th, tw, 1)):
        for t in range(9):
            ty, tx = divmod(t, 3)
            if fold:  # a on the tile, g shifted back by the tap, from its halo
                av, gv = small, big[:, 2 - ty:2 - ty + th, 2 - tx:2 - tx + tw]
            else:     # g on the tile, a shifted by the tap, from its halo
                av, gv = big[:, ty:ty + th, tx:tx + tw], small
            dw[t] += av.reshape(-1, c).T @ gv.reshape(-1, c)
    return dw


def _backward_by_tiles(dout, x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale, tile, fold=False,
                       bf16=False):
    """All nine gradients the way csrc/rcab_fused_bwd.cu takes them. With
    `bf16`, h1, dh2, dh1 and dx are rounded to bfloat16 where the kernel
    rounds them: dh2 once, before the two products that use it (conv2^T and
    dw2), while db2 sums it unrounded."""
    th, tw = tile
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    hw = x.shape[1] * x.shape[2]
    h1 = rnd(torch.relu(_conv_by_tiles(x, w1, th, tw, False) + b1))
    h2 = _conv_by_tiles(h1, w2, th, tw, False) + b2
    gap = h2.mean(dim=(1, 2))
    z = gap @ wd + bd
    d = torch.relu(z)
    u = torch.sigmoid(d @ wu + bu)
    g = dout * res_scale
    ds = (g * h2).sum(dim=(1, 2)) * u * (1 - u)
    dz = (ds @ wu.T) * (z > 0)
    dgap = dz @ wd.T
    dh2_exact = g * u[:, None, None] + dgap[:, None, None] / hw
    dh2 = rnd(dh2_exact)
    dh1 = rnd(_conv_by_tiles(dh2, w2, th, tw, True) * (h1 > 0))
    dx = rnd(_conv_by_tiles(dh1, w1, th, tw, True) + dout)
    return [dx, _wgrad_by_tiles(x, dh1, th, tw, fold), dh1.sum(dim=(0, 1, 2)),
            _wgrad_by_tiles(h1, dh2, th, tw, fold), dh2_exact.sum(dim=(0, 1, 2)),
            gap.T @ dz, dz.sum(0), d.T @ ds, ds.sum(0)]


@pytest.mark.parametrize("fold", [False, True], ids=["tile", "folded"])
@pytest.mark.parametrize("shape,tile", [((2, 9, 7, 16), (4, 4)), ((1, 13, 21, 8), (8, 16)),
                                        ((2, 17, 18, 16), (16, 16)), ((1, 5, 3, 8), (8, 8))])
def test_tile_walk_identities_match_backward_reference(shape, tile, fold):
    """f32, ragged tiles on both axes (and an image smaller than a tile):
    every gradient within 1e-4 of its largest entry."""
    args, dout = _inputs(5, shape=shape)
    targs = [torch.from_numpy(a) for a in args]
    tdout = torch.from_numpy(dout)
    want = trcab.rcab_backward_reference(tdout, *targs, res_scale=0.5)
    got = _backward_by_tiles(tdout, *targs, res_scale=0.5, tile=tile, fold=fold)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        # <= so that a gradient that is all zero (a gate whose ReLU is shut) passes
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), name


@pytest.mark.parametrize("res_scale", [1.0, 0.5])
def test_dh2_rounded_to_bf16_keeps_gradients_within_tolerance(res_scale):
    """The tensor-core backward feeds dh2 to its mma products as bfloat16.
    With dh2 rounded once before conv2^T and dw2 (and h1, dh1, dx rounded as
    before), all nine gradients stay within 2**-6 of their largest entry of
    f32 jax.grad of rcab_reference at the same bf16-valued inputs."""
    args, dout = _inputs(6, shape=(2, 12, 10, 16))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    args = [bf(a) if i in (0, 1, 3) else a for i, a in enumerate(args)]
    dout = bf(dout)
    want = _jax_grads(args, dout * res_scale)
    want[0] = want[0] + dout * (1.0 - res_scale)
    got = _backward_by_tiles(torch.from_numpy(dout), *map(torch.from_numpy, args),
                             res_scale=res_scale, tile=(8, 16), bf16=True)
    exact = _backward_by_tiles(torch.from_numpy(dout), *map(torch.from_numpy, args),
                               res_scale=res_scale, tile=(8, 16), bf16=False)
    moved = False
    for name, g, e, w in zip(NAMES, got, exact, want):
        assert _rel(g.numpy(), w) < 2.0 ** -6, name
        assert _rel(e.numpy(), w) < 1e-4, name
        moved |= not torch.equal(g, e)
    assert moved  # the rounding is really in the path under test
