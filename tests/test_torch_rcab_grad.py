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
