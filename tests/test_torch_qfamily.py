"""The rest of the BoBW family in the port, on the CPU, against the JAX
package: the QRCAB in every QCALayer style x pixel attention x SFT layer x
q-layer (the four foldable styles without PA or SFT on the fused kernel's
plain version, every other configuration on the plain route), which route
each configuration takes, QRCAN with PA and SFT through the ``qrcan``
handler, QEDSR (``front_only`` included) through ``qedsr``, and the BoBW
pipeline's ``sft_mode``, ``srmd_mode`` and ``contrastiveblindqedsr``. Flax
params carried over by the weight bridge, inputs from a numpy seed.

Tolerances: f32 outputs within 1e-5 of flax and gradients within 1e-4 of
each gradient's largest entry (the same f32 products summed in another
order); a BoBW train step under SGD at lr 1 (a parameter moves by its
gradient) within 1e-6 on the loss, each generator parameter after it
within 1e-4 of its move plus two float32 ulps of a parameter below 1. bf16: flax rounds every op's output to bf16 and so does the
plain route, but the two sum in other orders and the fused kernel rounds
only h1 and the output: within 2**-6 of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import attention_manipulators as jam
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import attention_manipulators as tam
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

C, R = 16, 4
SHAPE = (2, 7, 9, C)
F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22  # two float32 ulps of a parameter below 1

STYLE_CASES = [(s, pa, sft, q) for s in tam.STYLES for pa in (False, True)
               for sft in (False, True) for q in (False, True)]
STYLE_IDS = [f"{s}-{'pa' if pa else 'nopa'}-{'sft' if sft else 'nosft'}-{'q' if q else 'noq'}"
             for s, pa, sft, q in STYLE_CASES]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(tree, rng):
    """Biases off zero, so that each reaches the output."""
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _grad_pairs(tm, gp):
    """(name, port gradient, flax gradient) for every flax leaf; a port
    parameter without a gradient counts as zeros."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tm.named_parameters()}
    got = dict(jax.tree_util.tree_flatten_with_path(jax_tree_from_state_dict(grads, tm))[0])
    want = jax.tree_util.tree_flatten_with_path(_np(gp))[0]
    assert len(want) == len(got)
    return [(jax.tree_util.keystr(k), got[k], v) for k, v in want]


def _assert_grads(pairs):
    for name, got, want in pairs:
        assert np.abs(got - want).max() <= F32_GRAD_REL * max(np.abs(want).max(), 1e-6), name


def _block_pair(style, pa, sft, q, dtype="float32", seed=0):
    m = C if style == "modulate" else 5
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(style=style, q_layer=q, pa=pa, sft_layer=sft, num_metadata=m)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    meta = rng.random((SHAPE[0], m)).astype(np.float32)
    maps = np.broadcast_to(meta[:, None, None, :], SHAPE[:3] + (m,)).copy()
    jm = jam.QRCAB(C, R, dtype=jdt, **kw)
    params = _jitter(_np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(meta),
                                 jnp.asarray(maps))["params"]), rng)
    tm = tam.QRCAB(C, R, dtype=tdt, **kw)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    return jm, params, tm, x, meta, maps, rng


@pytest.mark.parametrize("style,pa,sft,q", STYLE_CASES, ids=STYLE_IDS)
def test_qrcab_matches_flax(style, pa, sft, q):
    """Forward, and the input's, the metadata's and every parameter's
    gradient."""
    jm, params, tm, x, meta, maps, rng = _block_pair(style, pa, sft, q)
    cot = rng.standard_normal(SHAPE).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(meta), jnp.asarray(maps))
    want = np.asarray(jm.apply({"params": params}, *args))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    mt = torch.from_numpy(meta).requires_grad_(True)
    out = tm(xt, mt, torch.from_numpy(maps).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=F32_ATOL, rtol=0)

    gp, gx, gm = jax.grad(
        lambda p, xv, mv: jnp.sum(jm.apply({"params": p}, xv, mv, args[2]) * cot),
        argnums=(0, 1, 2))(params, args[0], args[1])
    (out * torch.from_numpy(cot)).sum().backward()
    pairs = [("x", xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)),
             # the SFT maps are an input of their own; standard without a
             # q-layer ignores the metadata
             ("metadata", np.zeros_like(meta) if mt.grad is None else mt.grad.numpy(),
              np.asarray(gm))]
    _assert_grads(pairs + _grad_pairs(tm, gp))


@pytest.mark.parametrize("style,pa,sft", [("softmax", True, True),
                                          ("extended_attention", False, False),
                                          ("max_concat", True, False)],
                         ids=["softmax-pa-sft", "extended_attention", "max_concat-pa"])
def test_plain_route_bf16_matches_flax_bf16(style, pa, sft):
    jm, params, tm, x, meta, maps, _ = _block_pair(style, pa, sft, True, dtype="bf16", seed=3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(meta), jnp.asarray(maps)).astype(jnp.float32))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                 torch.from_numpy(meta), torch.from_numpy(maps).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("style,pa,sft", [(s, False, False) for s in tam.STYLES]
                         + [("max_concat", True, False), ("max_concat", False, True),
                            ("standard", True, True)],
                         ids=[f"{s}" for s in tam.STYLES] + ["max_concat-pa", "max_concat-sft",
                                                             "standard-pa-sft"])
def test_route_is_fixed_by_the_options(monkeypatch, style, pa, sft):
    """A QRCAN of the four foldable styles without PA or SFT calls the fused
    kernel's wrapper once a block; every other configuration never does.
    The route is the block's ``fused`` flag, set when it is built."""
    calls = []
    real = rcab.rcab_fused

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(rcab, "rcab_fused", counted)
    m = C if style == "modulate" else 5
    net = tam.QRCAN(scale=2, n_feats=C, n_resgroups=2, n_resblocks=3, reduction=R,
                    style=style, num_metadata=m, include_q_layer=True,
                    include_pixel_attention=pa, include_sft_layer=sft)
    gen = torch.Generator().manual_seed(0)
    for mod in net.modules():
        if hasattr(mod, "init_weights"):
            mod.init_weights(gen)
    net = net.to(memory_format=torch.channels_last)  # as a handler holds it
    foldable = style in tam.KERNEL_STYLES and not pa and not sft
    blocks = [b for g in net.groups for b in g.blocks]
    assert all(b.fused == foldable for b in blocks)
    x = torch.rand(1, 3, 6, 5).contiguous(memory_format=torch.channels_last)
    meta = torch.rand(1, m)
    with torch.inference_mode():
        net(x, meta, meta[:, :, None, None].expand(1, m, 6, 5))
    assert len(calls) == (len(blocks) if foldable else 0)


QRCAN_KW = [dict(style="extended_attention", include_pixel_attention=True,
                 include_sft_layer=True, metadata_bypass_len=5,
                 selective_meta_blocks=[True, False]),
            dict(style="softmax", include_sft_layer=True, metadata_bypass_len=20),
            dict(style="modulate", include_sft_layer=True)]  # qpi expanded to n_feats


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("kw", QRCAN_KW, ids=["ext-pa-sft", "softmax-sft", "modulate-sft"])
def test_qrcan_handler_with_pa_and_sft_matches_jax(kw, dtype):
    kw = dict(scale=2, n_feats=C, n_resgroups=2, n_resblocks=2, reduction=R, dtype=dtype, **kw)
    jh = jax_model("qrcan")(**kw)
    js = jh.init_state()
    th = torch_model("qrcan")(device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np(js.params), th.module))
    if kw.get("selective_meta_blocks"):  # no SFT and no q-layer in the second group
        assert th.module.groups[1].blocks[0].sft is None
        assert th.module.groups[0].blocks[0].sft is not None
    rng = np.random.default_rng(len(kw))
    x = rng.random((2, 8, 7, 3)).astype(np.float32)
    meta = rng.random((2, jh.num_metadata)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}),
                      np.float32)
    got = th.run_eval(state, {"lr": x, "metadata": meta}).float().numpy()
    assert got.shape == want.shape == (2, 16, 14, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


QEDSR_KW = [dict(selective_meta_blocks="front_only", metadata_bypass_len=5),
            dict(selective_meta_blocks=[False, True, True], q_layer_nonlinearity=True,
                 metadata_bypass_len=20),
            dict(metadata=["sigma_x", "blur_kernel"])]  # 11 values: the PCA kernel's 10


@pytest.mark.parametrize("kw", QEDSR_KW, ids=["front_only", "list-nonlinear", "pca-keys"])
def test_qedsr_handler_matches_jax(kw):
    """Forward and every parameter's gradient of an L1 loss."""
    kw = dict(scale=2, num_features=C, num_blocks=3, **kw)
    jh = jax_model("qedsr")(**kw)
    js = jh.init_state()
    th = torch_model("qedsr")(device="cpu", **kw)
    assert th.num_metadata == jh.num_metadata
    params = _jitter(_np(js.params), np.random.default_rng(9))
    state = TrainState(step=0, params=state_dict_from_jax(params, th.module))
    rng = np.random.default_rng(10)
    x = rng.random((2, 6, 8, 3)).astype(np.float32)
    hr = rng.random((2, 12, 16, 3)).astype(np.float32)
    meta = rng.random((2, jh.num_metadata)).astype(np.float32)
    batch = {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}

    def loss(p):
        sr, _, _ = jh.apply(p, batch)
        return jnp.mean(jnp.abs(sr - hr))

    gp = jax.grad(loss)(params)
    sr, _, _ = th.apply(state.params, {"lr": x, "metadata": meta})
    want = np.asarray(jh.apply(params, batch)[0])
    np.testing.assert_allclose(sr.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    (sr - torch.from_numpy(hr)).abs().mean().backward()
    _assert_grads(_grad_pairs(th.module, gp))
    smb = kw.get("selective_meta_blocks")
    if smb == "front_only":
        assert [b.q is not None for b in th.module.blocks] == [True, False, False]


def test_qedsr_bf16_matches_jax():
    kw = dict(scale=2, num_features=C, num_blocks=2, metadata_bypass_len=5, dtype="bf16")
    jh = jax_model("qedsr")(**kw)
    js = jh.init_state()
    th = torch_model("qedsr")(device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np(js.params), th.module))
    rng = np.random.default_rng(11)
    x = rng.random((1, 9, 6, 3)).astype(np.float32)
    meta = rng.random((1, 5)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}),
                      np.float32)
    got = th.run_eval(state, {"lr": x, "metadata": meta}).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# -- the BoBW pipeline's modes and QEDSR generator -------------------------------

BOBW = dict(scale=2, n_feats=C, n_resgroups=1, n_resblocks=2, reduction=R,
            optimizer_type="sgd", lr=1.0)
BOBW_CASES = {"sft_mode": ("contrastiveblindqrcan", dict(BOBW, sft_mode=True)),
              "srmd_mode": ("contrastiveblindqrcan", dict(BOBW, srmd_mode=True)),
              "qedsr": ("contrastiveblindqedsr",
                        dict(scale=2, num_features=C, num_blocks=2,
                             selective_meta_blocks="front_only", optimizer_type="sgd", lr=1.0))}


def _bobw_pair(name, kw):
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th = torch_model(name)(device="cpu", **kw)
    full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    return jh, js, th, th._own_state()


@pytest.mark.parametrize("case", list(BOBW_CASES))
def test_bobw_modes_match_jax(case):
    """The pipeline's eval forward, and one train step (the frozen
    encoder's batch statistics, the generator's update under SGD at lr 1)."""
    name, kw = BOBW_CASES[case]
    jh, js, th, state = _bobw_pair(name, kw)
    gen = th.module.generator
    if case == "srmd_mode":  # the maps go in with the image: 3 + 256 channels
        assert gen.head.weight.shape[1] == 3 + 256
        assert all(b.fused for g in gen.groups for b in g.blocks)
    if case == "sft_mode":
        assert all(b.sft is not None and not b.fused for g in gen.groups for b in g.blocks)
    rng = np.random.default_rng(12)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = th.run_eval(state, {"lr": x}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)

    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    # a copy: the port's step updates the state's tensors in place
    before = jax.tree_util.tree_map(
        np.copy, jax_tree_from_state_dict(state.params, th.module)["generator"])
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)["generator"]
    want_after = _np(js2.params["generator"])
    # under SGD at lr 1 a parameter moves by its gradient; a move below a
    # float32 ulp of the parameter rounds away in either package
    largest = 0.0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want_after)[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        largest = max(largest, move)
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)
    assert largest > 0


def test_sft_mode_with_a_qedsr_generator_fails_as_in_jax():
    """In the JAX package sft_mode hands QEDSR, which takes (x, metadata),
    the maps as a third argument: a TypeError at its first forward (flax's
    init). The port fails the same way at its first forward."""
    kw = dict(scale=2, num_features=C, num_blocks=1, sft_mode=True)
    with pytest.raises(TypeError, match="positional argument"):
        jax_model("contrastiveblindqedsr")(**kw).init_state()
    th = torch_model("contrastiveblindqedsr")(device="cpu", **kw)
    with pytest.raises(TypeError, match="positional argument"):
        th.run_eval(th.init_state(), {"lr": np.zeros((1, 6, 6, 3), np.float32)})
