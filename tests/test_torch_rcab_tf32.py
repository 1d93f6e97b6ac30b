"""The float32 arithmetic of the RCAB kernels' tensor-core plans
(rumpy_tpu_torch/csrc/rcab_common.cuh, rcab_fused.cu, rcab_fused_bwd.cu),
emulated in plain torch on the CPU and held against the JAX package's
rcab_reference and jax.grad of it.

On the card every float32 product of the two convolutions, their transposed
convolutions and their weight gradients runs as 3xTF32 on mma.sync m16n8k8:
each operand v is split into big = rna_tf32(v) and small = rna_tf32(v -
big), and a k-step of 8 adds small.big, big.small and big.big, in that
order, to an f32 accumulator. rna_tf32 rounds to nearest with ties away
from zero and keeps 10 mantissa bits. The emulation takes the same splits
and the same order: taps 0..8, each in k-steps of 8 input channels (the
weight gradients: k-steps of 8 pixels), each mma's 8 products summed
exactly and added to the f32 accumulator with one rounding. The CUDA code
runs only on the card (chip_smoke.py holds it against its plain version
there); these tests hold its arithmetic against the reference, in the
shared and the per-image form (a QRCAB's bd and scale per image), at
ragged shapes, and show why one TF32 pass is not enough."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rumpy_tpu.ops.pallas import rcab_fused as jrcab
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

# chip_smoke.py's tolerances for the kernels against their plain versions:
# the forward's largest absolute error, each gradient's largest error over
# its largest entry.
F32_ATOL = 1e-4
BWD_F32_REL = 2e-4
# Ragged shapes at every tensor-core width but 128 (tiles cut on both axes).
SHAPES = [(2, 9, 7, 16), (1, 13, 21, 32), (2, 10, 11, 64)]
FORMS = ["shared", "per_image"]
NAMES = ["x", "w1", "b1", "w2", "b2", "wd", "bd", "wu", "bu", "scale"]


def rna_tf32(v):
    """cvt.rna.tf32.f32 on a float32 tensor: the bit pattern plus half of the
    13 dropped bits' unit, those bits then cleared (round half away from
    zero on the magnitude)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def split(v):
    big = rna_tf32(v)
    return big, rna_tf32(v - big)


def mma_steps(acc, a, b, passes):
    """acc (M, N) float32 += a (M, k) . b (k, N) for k <= 8, as one k-step
    of mma.sync: 3xTF32 (passes=3: small.big, big.small, big.big) or one
    TF32 pass (big.big); each product's sum exact, one rounding to f32."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    kinds = [(a_small, b_big), (a_big, b_small), (a_big, b_big)] if passes == 3 \
        else [(a_big, b_big)]
    for p, q in kinds:
        acc = (acc.double() + p.double() @ q.double()).float()
    return acc


def conv3x3(src, w, transposed=False, passes=3):
    """3x3 SAME conv of NHWC float32 ``src`` with (9, C, C) tap-major
    weights (transposed: out[p][ci] = sum_t,co src[p + t][co] w[8 - t][ci]
    [co], the data gradient's conv) in the kernels' order: tap-major, then
    k-steps of 8 input channels."""
    n, h, wd, c = src.shape
    padded = F.pad(src, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n * h * wd, c)
    for t in range(9):
        a = padded[:, t // 3:t // 3 + h, t % 3:t % 3 + wd, :].reshape(-1, c)
        b = w[8 - t].T if transposed else w[t]
        for k0 in range(0, c, 8):
            acc = mma_steps(acc, a[:, k0:k0 + 8], b[k0:k0 + 8], passes)
    return acc.reshape(n, h, wd, c)


def wgrad(a, g):
    """dw[t][ci][co] = sum_p a[p + t][ci] g[p][co]: per tap a (C x pixels) .
    (pixels x C) product in k-steps of 8 pixels, 3xTF32."""
    n, h, wd, c = a.shape
    padded = F.pad(a, (0, 0, 1, 1, 1, 1))
    gg = g.reshape(-1, c)
    out = []
    for t in range(9):
        at = padded[:, t // 3:t // 3 + h, t % 3:t % 3 + wd, :].reshape(-1, c)
        acc = torch.zeros(c, c)
        for k0 in range(0, at.shape[0], 8):
            acc = mma_steps(acc, at[k0:k0 + 8].T, gg[k0:k0 + 8], 3)
        out.append(acc)
    return torch.stack(out)


def _inputs(seed, shape, form, r=4):
    """The block's inputs as numpy float32 (conv weights scaled as in
    chip_smoke.py's rcab_inputs), with bd (N, R) and a q-layer's scale
    (N, C) in (0, 1) in the per-image form (else bd (R,) and no scale),
    and a dout."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    k = (1.0 / (9 * c)) ** 0.5
    args = [f(n, h, w, c), f(9, c, c, sc=k), f(c, sc=0.05), f(9, c, c, sc=k),
            f(c, sc=0.05), f(c, c // r, sc=0.3), f(c // r, sc=0.05),
            f(c // r, c, sc=0.3), f(c, sc=0.05)]
    scale = None
    if form == "per_image":
        args[6] = args[6] + f(n, c // r, sc=0.3)
        scale = (1 / (1 + np.exp(-f(n, c)))).astype(np.float32)
    return args, scale, f(n, h, w, c)


def emulated_forward(args, scale, passes=3):
    """The block as the tensor-core plan computes it in float32: both convs
    in 3xTF32 (or one TF32 pass), h1 kept in f32, the gate in f32, the
    per-image bd and scale where given. Returns out and what the backward
    reads (h1, h2, gap, z, d, u)."""
    x, w1, b1, w2, b2, wd, bd, wu, bu = map(torch.from_numpy, args)
    h1 = torch.relu(conv3x3(x, w1, passes=passes) + b1)
    h2 = conv3x3(h1, w2, passes=passes) + b2
    gap = h2.mean(dim=(1, 2))
    z = gap @ wd + bd
    d = torch.relu(z)
    u = torch.sigmoid(d @ wu + bu)
    s = torch.ones_like(u) if scale is None else torch.from_numpy(scale)
    out = h2 * (u * s)[:, None, None, :] + x
    return out, dict(h1=h1, h2=h2, gap=gap, z=z, d=d, u=u, s=s)


def emulated_backward(args, scale, dout):
    """The gradients as the float32 tensor-core plan forms them: dh2 whole in
    f32, conv2's and conv1's transposed convs and both weight gradients in
    3xTF32, the gate's backward in f32. Order as NAMES (scale's gradient
    None without a scale)."""
    x, w1, b1, w2, b2, wd, bd, wu, bu = map(torch.from_numpy, args)
    _, k = emulated_forward(args, scale)
    dout = torch.from_numpy(dout)
    hw = x.shape[1] * x.shape[2]
    du = (dout * k["h2"]).sum(dim=(1, 2))
    dscale = du * k["u"]
    du = du * k["s"]
    ds = du * k["u"] * (1 - k["u"])
    dz = (ds @ wu.T) * (k["z"] > 0)
    dgap = dz @ wd.T
    dh2 = dout * (k["u"] * k["s"])[:, None, None, :] + (dgap / hw)[:, None, None, :]
    dh1 = conv3x3(dh2, w2, transposed=True) * (k["h1"] > 0)
    dx = conv3x3(dh1, w1, transposed=True) + dout
    grads = [dx, wgrad(x, dh1), dh1.sum(dim=(0, 1, 2)), wgrad(k["h1"], dh2),
             dh2.sum(dim=(0, 1, 2)), k["gap"].T @ dz, dz if bd.dim() == 2 else dz.sum(0),
             k["d"].T @ ds, ds.sum(0)]
    return grads + [dscale if scale is not None else None]


def _jax_block(x, w1, b1, w2, b2, wd, bd, wu, bu, scale):
    """The JAX reference with per-image bd (N, R) broadcast as (N, 1, 1, R)
    and the scale applied to the attended branch: x + s * (block - x)."""
    if bd.ndim == 2:
        bd = bd[:, None, None, :]
    out = jrcab.rcab_reference(x, w1, b1, w2, b2, wd, bd, wu, bu)
    return x + scale[:, None, None, :] * (out - x)


def _jax_forward(args, scale):
    s = np.ones(args[0].shape[::3], np.float32) if scale is None else scale
    return np.asarray(_jax_block(*map(jnp.asarray, args), jnp.asarray(s)))


def _jax_grads(args, scale, dout):
    s = np.ones(args[0].shape[::3], np.float32) if scale is None else scale
    loss = lambda *a: (_jax_block(*a) * jnp.asarray(dout)).sum()
    grads = jax.grad(loss, argnums=tuple(range(10)))(*map(jnp.asarray, args), jnp.asarray(s))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10), (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0), (3.0 * 2.0 ** -11 + 1.0, 1.0 + 2.0 ** -9),
    (65536.0 + 40.0, 65536.0 + 64.0)])
def test_rna_tf32_rounds_to_nearest_ties_away(value, want):
    """Ten mantissa bits kept; a tie (half the unit of the 10th bit) goes
    away from zero, on either sign; below it the value rounds down."""
    got = rna_tf32(torch.tensor([value], dtype=torch.float32)).item()
    assert got == np.float32(want)


def test_split_represents_each_value_to_22_bits():
    """big + small stands within 2**-21 of each float32 value's magnitude,
    and both halves have their low 13 bits clear (what mma.sync reads)."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = split(v)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    err = ((big.double() + small.double()) - v.double()).abs() / v.double().abs()
    assert err.max() <= 2.0 ** -21


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_forward_matches_jax_reference(shape, form):
    """The block with both convs in 3xTF32 (the kernels' tap and k-step
    order, h1 in f32) against the JAX rcab_reference in float32: within
    F32_ATOL, the tolerance chip_smoke.py holds the kernel to against its
    plain version on the card."""
    args, scale, _ = _inputs(sum(shape), shape, form)
    got = emulated_forward(args, scale)[0].numpy()
    want = _jax_forward(args, scale)
    assert np.abs(got - want).max() <= F32_ATOL


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_backward_matches_jax_grad(shape, form):
    """All nine gradients (and the per-image scale's) with the transposed
    convs and weight gradients in 3xTF32 and dh2 formed whole in f32,
    against jax.grad of the JAX rcab_reference: each within BWD_F32_REL of
    its largest entry, chip_smoke.py's tolerance on the card."""
    args, scale, dout = _inputs(sum(shape) + 1, shape, form)
    got = emulated_backward(args, scale, dout)
    want = _jax_grads(args, scale, dout)
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            continue
        g = g.detach().numpy().reshape(w.shape)
        assert np.abs(g - w).max() <= BWD_F32_REL * np.abs(w).max(), name


def test_one_tf32_pass_misses_the_f32_tolerance_at_c64():
    """Why the split: at C = 64 the block with one TF32 pass a product
    (big.big alone, about three decimal digits) stands several times
    F32_ATOL off the float32 reference (7.0e-4), where 3xTF32 stays about
    a hundred times inside it (9.5e-7: two ulps of the largest output)."""
    shape = (2, 12, 16, 64)
    args, scale, _ = _inputs(7, shape, "per_image")
    want = _jax_forward(args, scale)
    one = np.abs(emulated_forward(args, scale, passes=1)[0].numpy() - want).max()
    three = np.abs(emulated_forward(args, scale, passes=3)[0].numpy() - want).max()
    assert one > 4 * F32_ATOL
    assert three < F32_ATOL / 20
