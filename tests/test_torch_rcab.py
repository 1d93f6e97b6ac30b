"""The port's RCAB block (rumpy_tpu_torch.ops.cuda.rcab_fused) against the
JAX package's Pallas kernel, its XLA twin and flax's RCAB, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import common as jcommon
from rumpy_tpu.ops.pallas import rcab_fused as jrcab
from rumpy_tpu_torch.models import common as tcommon
from rumpy_tpu_torch.ops.cuda import rcab_fused as trcab
from rumpy_tpu_torch.utils.weights import _convs, _lookup

SHAPE = (2, 12, 16, 64)
R = 16


def _inputs(seed, shape=SHAPE, r=R):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [f(n, h, w, c), f(9, c, c, sc=0.05), f(c, sc=0.01),
            f(9, c, c, sc=0.05), f(c, sc=0.01), f(c, c // r, sc=0.1),
            f(c // r, sc=0.01), f(c // r, c, sc=0.1), f(c, sc=0.01)]


def test_plain_rcab_matches_pallas_and_xla_f32():
    args = _inputs(0)
    got = trcab.rcab_fused(*map(torch.from_numpy, args)).numpy()
    jargs = list(map(jnp.asarray, args))
    pallas = np.asarray(jrcab.rcab_fused(*jargs, interpret=True))
    xla = np.asarray(jrcab.rcab_reference(*jargs))
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=2e-4, rtol=1e-4)


def test_plain_rcab_matches_xla_bf16():
    """bf16 activations and conv weights, f32 accumulation, h1 rounded to
    bf16 between the convs. Summation order differs between the two
    frameworks, so an h1 value near a rounding boundary can land one bf16
    ulp apart and the bf16 output by an ulp or two of its magnitude (the
    outputs here are |y| < 8: one ulp is at most 2**-5 = 0.031). bf16 vs
    f32 of the same block differ by 1.6e-2 max abs, for scale."""
    args = _inputs(1)
    x, w1, b1, w2, b2, wd, bd, wu, bu = args
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    targs = [bf(x), bf(w1), torch.from_numpy(b1), bf(w2),
             *map(torch.from_numpy, (b2, wd, bd, wu, bu))]
    got = trcab.rcab_fused(*targs).float().numpy()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jrcab.rcab_reference(
        jb(x), jb(w1), jnp.asarray(b1), jb(w2),
        *map(jnp.asarray, (b2, wd, bd, wu, bu))).astype(jnp.float32))
    assert np.abs(want).max() < 8
    err = np.abs(got - want)
    assert err.max() <= 2 * 2.0 ** -5
    assert err.mean() < 1e-3  # almost every element agrees exactly
    assert (err == 0).mean() > 0.95


def test_rcab_module_res_scale_matches_flax():
    """The port's RCAB module (kernel path, res_scale 0.5) against flax's
    RCAB with the same params bridged by name, f32."""
    n, h, w, c = SHAPE
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    jm = jcommon.RCAB(c, R, res_scale=0.5)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    tm = tcommon.RCAB(c, R, res_scale=0.5)
    sd = {}
    for port, flax, _ in _convs(tm, "", ()):
        node, _ = _lookup(params, flax)
        sd[f"{port}.weight"] = torch.from_numpy(node["kernel"].transpose(3, 2, 0, 1).copy())
        sd[f"{port}.bias"] = torch.from_numpy(node["bias"].copy())
    tm.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last view
    with torch.inference_mode():
        got = tm(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    # the packed kernel weights are rebuilt when the params change
    with torch.no_grad():
        tm.conv2.bias.add_(1.0)
    with torch.inference_mode():
        moved = tm(xt).permute(0, 2, 3, 1).numpy()
    assert np.abs(moved - got).max() > 0.1


def test_wrapper_rejects_bad_inputs():
    args = list(map(torch.from_numpy, _inputs(4)))
    strided = args[0].permute(0, 2, 1, 3)  # (N, W, H, C) view, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        trcab.rcab_fused(strided, *args[1:])
    c = 12
    bad = list(map(torch.from_numpy, _inputs(5, shape=(1, 6, 6, c), r=4)))
    with pytest.raises(ValueError, match="multiple of 8"):
        trcab.rcab_fused(*bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 24, 32, 64, 128, 256])
def test_plain_rcab_matches_xla_across_channels(c, dtype):
    """A ragged 7x5 image at every kind of C the kernel takes (a multiple
    of 8; 16..128 on its tensor-core pass in bf16, the rest on its
    CUDA-core pass), against JAX's rcab_reference. f32 at the Pallas
    tests' tolerance; bf16 within two bf16 ulps of the largest output
    (2**-6 * max|y|), as in the bf16 test above."""
    args = _inputs(10 + c, shape=(1, 7, 5, c), r=min(c, 16))
    x, w1, b1, w2, b2, wd, bd, wu, bu = args
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    act = lambda a: torch.from_numpy(a).to(tdt)
    got = trcab.rcab_fused(act(x), act(w1), torch.from_numpy(b1), act(w2),
                           *map(torch.from_numpy, (b2, wd, bd, wu, bu)))
    assert got.dtype == tdt and got.shape == x.shape
    jact = lambda a: jnp.asarray(a, jdt)
    want = np.asarray(jrcab.rcab_reference(
        jact(x), jact(w1), jnp.asarray(b1), jact(w2),
        *map(jnp.asarray, (b2, wd, bd, wu, bu))).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    else:
        err = np.abs(got - want)
        assert err.max() <= 2.0 ** -6 * np.abs(want).max()
        assert (err == 0).mean() > 0.95
