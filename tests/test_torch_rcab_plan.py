"""Plain-torch emulations of what the RCAB forward kernel's tensor-core plan
relies on (rumpy_tpu_torch/csrc/rcab_fused.cu), against the JAX package's
rcab_reference and Pallas kernel, on the CPU.

The kernel splits the block into passes over work units: conv1 on a unit's
tile (read with a 1-pixel halo, zero outside the image) writes h1 for the
in-image pixels only; conv2 on a unit of h1 (masked loads: zero outside
the image) writes h2 and one row of per-channel sums for the unit; the
apply pass adds an image's rows in one fixed order into the gate. The CUDA
code runs only on the card (chip_smoke.py holds it against its plain
version there); these tests hold the arithmetic of that design, unit by
unit and in the kernel's summation order, against the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rumpy_tpu.ops.pallas import rcab_fused as jrcab
from rumpy_tpu_torch.ops.cuda import rcab_fused as trcab
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

# Units the tensor-core plan may pick (2*MU rows x 8 columns, MU in
# {1, 2, 4}) and the CUDA-core plan's block tiles.
MMA_UNITS = [(2, 8), (4, 8), (8, 8)]
FMA_TILES = [(16, 16), (8, 16), (8, 8), (4, 8), (4, 4)]
# Ragged shapes: tiles cut by the image's edge on both axes.
RAGGED = [(2, 45, 51, 16), (1, 13, 21, 64)]
APPLY_THREADS = 256  # kThreads: threads of the apply pass


def _inputs(seed, shape, r=4):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    k = (1.0 / (9 * c)) ** 0.5
    return [f(n, h, w, c), f(9, c, c, sc=k), f(c, sc=0.05), f(9, c, c, sc=k),
            f(c, sc=0.05), f(c, c // r, sc=0.3), f(c // r, sc=0.05),
            f(c // r, c, sc=0.3), f(c, sc=0.05)]


def _conv_tile(tile, w):
    """Valid 3x3 conv of a (th+2, tw+2, C) tile with (9, C, C) tap-major
    weights: (th, tw, C) in float32."""
    c = w.shape[-1]
    k = w.float().reshape(3, 3, c, c).permute(3, 2, 0, 1)
    return F.conv2d(tile.permute(2, 0, 1)[None].float(), k)[0].permute(1, 2, 0)


def _unit_pass(inp, w, b, th, tw, conv2):
    """One conv pass unit by unit, as the kernel does it: each unit's input
    tile with its 1-pixel halo is read with zero for pixels outside the
    image, and only in-image outputs are written. conv1 (conv2=False)
    returns h1 = round(relu(.)) in inp's dtype; conv2 returns h2 in float32
    and the per-unit channel sums (N, tiles, C), each summed in the
    kernel's order: down each of the unit's 8 pixel columns, then the
    columns pairwise (a warp butterfly over lanes 4, 8, 16 apart)."""
    n, h, w_, c = inp.shape
    ty, tx = -(-h // th), -(-w_ // tw)
    padded = torch.zeros(n, ty * th + 2, tx * tw + 2, c, dtype=inp.dtype)
    padded[:, 1:h + 1, 1:w_ + 1] = inp
    out = torch.zeros(n, h, w_, c, dtype=torch.float32 if conv2 else inp.dtype)
    sums = torch.zeros(n, ty * tx, c)
    for i in range(n):
        for y in range(ty):
            for x in range(tx):
                y0, x0 = y * th, x * tw
                v = _conv_tile(padded[i, y0:y0 + th + 2, x0:x0 + tw + 2], w) + b
                hh, ww = min(th, h - y0), min(tw, w_ - x0)
                v = v[:hh, :ww]
                if not conv2:
                    out[i, y0:y0 + hh, x0:x0 + ww] = torch.relu(v).to(inp.dtype)
                    continue
                out[i, y0:y0 + hh, x0:x0 + ww] = v
                cols = torch.zeros(8, c)
                for col in range(ww):
                    for row in range(hh):  # rows in order, float32
                        cols[col % 8] = cols[col % 8] + v[row, col]
                for m in (1, 2, 4):  # butterfly: lane r0 meets r0 ^ m
                    cols = cols + cols[torch.arange(8) ^ m]
                sums[i, y * tx + x] = cols[0]
    return out, sums


def _gap_fixed_order(sums, hw):
    """The apply pass's sum of an image's unit rows: channel c's rows split
    over Q threads (rows q, q+Q, ... added in order, float32), then the Q
    sums added in order, divided by H*W."""
    n, tiles, c = sums.shape
    q_threads = max(1, APPLY_THREADS // (c // 4))
    part = torch.zeros(n, q_threads, c)
    for q in range(q_threads):
        for t in range(q, tiles, q_threads):
            part[:, q] = part[:, q] + sums[:, t]
    gap = torch.zeros(n, c)
    for q in range(q_threads):
        gap = gap + part[:, q]
    return gap / hw


def _gate(gap, wd, bd, wu, bu):
    d = torch.relu(gap @ wd + bd)
    return torch.sigmoid(d @ wu + bu)


def _two_pass_block(args, unit, dtype=torch.float32):
    """The whole block as the tensor-core plan computes it; returns (out,
    h2, unit sums, gate)."""
    x, w1, b1, w2, b2, wd, bd, wu, bu = map(torch.from_numpy, args)
    x, w1, w2 = x.to(dtype), w1.to(dtype), w2.to(dtype)
    th, tw = unit
    h1, _ = _unit_pass(x, w1, b1, th, tw, conv2=False)
    h2, sums = _unit_pass(h1, w2, b2, th, tw, conv2=True)
    gate = _gate(_gap_fixed_order(sums, x.shape[1] * x.shape[2]), wd, bd, wu, bu)
    out = (h2 * gate[:, None, None, :] + x.float()).to(dtype)
    return out, h2, sums, gate


def _jax_h2(args):
    """h2 of the JAX reference's arithmetic, float64 on the host."""
    x, w1, b1, w2, b2 = map(jnp.asarray, args[:5])
    c = x.shape[-1]
    conv = lambda a, k: jax.lax.conv_general_dilated(
        a, k.reshape(3, 3, c, c), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    h1 = jnp.maximum(conv(x, w1) + b1, 0.0)
    return np.asarray(conv(h1, w2) + b2, dtype=np.float64)


@pytest.mark.parametrize("unit", MMA_UNITS)
@pytest.mark.parametrize("shape", [(2, 12, 16, 16)] + RAGGED)
def test_two_pass_block_matches_one_pass_reference_f32(shape, unit):
    """h1 kept only for in-image pixels, then conv2 with masked (zero)
    loads, unit sums and the fixed-order gate: the same block as the JAX
    package's one-pass rcab_reference, within 2e-4 (float32 sums in
    another order; outputs |y| < 8)."""
    args = _inputs(0, shape)
    got = _two_pass_block(args, unit)[0].numpy()
    want = np.asarray(jrcab.rcab_reference(*map(jnp.asarray, args)))
    assert np.abs(want).max() < 8
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_two_pass_block_matches_pallas_kernel():
    """The same at the JAX tests' small width, against the Pallas kernel
    itself in interpret mode."""
    args = _inputs(1, (2, 12, 16, 64))
    got = _two_pass_block(args, (4, 8))[0].numpy()
    want = np.asarray(jrcab.rcab_fused(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("unit", MMA_UNITS)
def test_two_pass_block_bf16_matches_reference(unit):
    """bf16 activations and conv weights: h1 rounded to bf16 by the first
    pass, as the one-pass block rounds it. Against the JAX reference in
    bf16: within two bf16 ulps of the largest output (2**-6 * max|y|), the
    tolerance chip_smoke.py holds the kernel to on the card."""
    args = _inputs(2, RAGGED[1])
    got = _two_pass_block(args, unit, torch.bfloat16)[0].float().numpy()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    x, w1, b1, w2, b2, wd, bd, wu, bu = args
    want = np.asarray(jrcab.rcab_reference(
        jb(x), jb(w1), jnp.asarray(b1), jb(w2),
        *map(jnp.asarray, (b2, wd, bd, wu, bu))).astype(jnp.float32))
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("tile", MMA_UNITS + FMA_TILES)
@pytest.mark.parametrize("shape", RAGGED + [(2, 48, 48, 64)])
def test_gate_from_unit_sums_in_fixed_order(shape, tile):
    """GAP of h2 from per-tile sums (tiles cut by the image's edge on both
    axes), added in the apply pass's fixed order, against the mean of the
    JAX reference's h2 in float64: within 1e-6 of max|h2| (float32 sums of
    at most 2,304 terms: a few ulps each), and the gate within 1e-6. Two
    emulations give the same bits: the order is fixed."""
    n, h, w, c = shape
    args = _inputs(3, shape)
    _, h2, sums, gate = _two_pass_block(args, tile)
    h2_ref = _jax_h2(args)
    np.testing.assert_allclose(h2.numpy(), h2_ref, atol=2e-5, rtol=0)
    gap = _gap_fixed_order(sums, h * w).double().numpy()
    gap_ref = h2_ref.mean(axis=(1, 2))
    assert np.abs(gap - gap_ref).max() <= 1e-6 * np.abs(h2_ref).max()
    wd, bd, wu, bu = (torch.from_numpy(a).double() for a in args[5:])
    gate_ref = _gate(torch.from_numpy(gap_ref), wd, bd, wu, bu).numpy()
    np.testing.assert_allclose(gate.double().numpy(), gate_ref, atol=1e-6, rtol=0)
    assert torch.equal(_gap_fixed_order(sums, h * w), _gap_fixed_order(sums.clone(), h * w))


def _backward_from_workspace(dout, args, h2, sums, gate, res_scale):
    """The backward as rcab_fused_bwd.cu takes it: the forward's h2, its
    unit sums (GAP) and its gate from the workspace, h1 computed again from
    x; the gate's backward by hand, the convs' by autograd of the plain
    convs. Returns the nine gradients in float32."""
    x, w1, b1, w2, b2, wd, bd, wu, bu = (torch.from_numpy(a) for a in args)
    n, h, w, c = x.shape
    hw = h * w
    gap = _gap_fixed_order(sums, hw)
    z = gap @ wd + bd
    d = torch.relu(z)
    du = res_scale * (dout * h2).sum(dim=(1, 2))
    ds = du * gate * (1 - gate)
    dz = (ds @ wu.T) * (z > 0)
    dgap = dz @ wd.T
    dh2 = dout * gate[:, None, None, :] * res_scale + (dgap / hw)[:, None, None, :]
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        xl, w1l, b1l, w2l, b2l = leaves
        conv = lambda a, k, b: F.conv2d(
            a, k.reshape(3, 3, c, c).permute(3, 2, 0, 1), padding=1) + b[:, None, None]
        h1 = torch.relu(conv(xl.permute(0, 3, 1, 2), w1l, b1l))
        h2_again = conv(h1, w2l, b2l).permute(0, 2, 3, 1)
        grads = torch.autograd.grad(h2_again, leaves, dh2)
    dx = grads[0] + dout
    return [dx, *grads[1:], gap.T @ dz, dz.sum(0), d.T @ ds, ds.sum(0)]


@pytest.mark.parametrize("unit", [(4, 8), (2, 8)])
@pytest.mark.parametrize("res_scale", [1.0, 0.5])
def test_backward_from_unit_tiled_workspace_matches_jax_grad(unit, res_scale):
    """The backward fed the gate and unit sums that the new tiling lays
    out (ragged tiles on both axes) against jax.grad of the JAX
    rcab_reference: all nine gradients within 1e-4 of each one's largest
    entry. The order is [dx, dw1, db1, dw2, db2, dwd, dbd, dwu, dbu]."""
    shape = RAGGED[0]
    args = _inputs(4, shape)
    dout = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    _, h2, sums, gate = _two_pass_block(args, unit)
    got = _backward_from_workspace(torch.from_numpy(dout), args, h2, sums, gate, res_scale)
    loss = lambda *a: (jrcab.rcab_reference(*a) * jnp.asarray(dout * res_scale)).sum()
    want = [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))]
    want[0] = want[0] + dout * (1.0 - res_scale)  # the JAX block has no res_scale
    for k in range(9):
        g, wv = got[k].detach().numpy(), want[k]
        assert g.shape == wv.shape, k
        assert np.abs(g - wv).max() <= 1e-4 * np.abs(wv).max(), k
    # the port's own plain backward agrees too
    ref = trcab.rcab_backward_reference(torch.from_numpy(dout),
                                        *map(torch.from_numpy, args), res_scale=res_scale)
    for k in range(9):
        assert np.abs(ref[k].numpy() - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k
