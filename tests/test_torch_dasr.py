"""DASR and DCLS in the port, on the CPU, against the JAX package: DAConv's
batch folded into the channels at B = 3 with kernels that differ per
example, the DASR forward and the bridge both ways (the key encoder, the
encoder's BatchNorm statistics and the queue too), the two training
phases (the encoder's pretrain step, then the joint step) with Adam, the
queue's K % batch check, and DCLS's kernels and loss.

Flax params carried over by the weight bridge (biases jittered off zero),
inputs from a numpy seed. Tolerances: f32 outputs and losses within 1e-5,
gradients (and Adam's first and second moments, which are the gradients
scaled) within 1e-4 of each leaf's largest entry (of the whole tree's for
the biases of the encoder's convs, each before a BatchNorm, whose
gradient is zero up to rounding), BatchNorm statistics
within 1e-5, the key encoder within one float32 ulp of its operands' size
(one product and one sum of the same values), the queue rows a step
writes within 1e-5 (normalized projections through eight layers), every
other row bit for bit. Parameters after an Adam step move by about lr *
sign(g): they are held within 1e-4 * lr plus two float32 ulps wherever
|g| >= 1e-3 of the largest gradient (below that the two packages'
rounding may decide the move, lr * g / (|g| + 1e-8)). Before the joint
step the port takes JAX's parameters after the pretrain step, so that
both start it from the same weights. bf16 outputs within 2**-6 of the
largest output.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import dasr as jdasr
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import dasr as tdasr
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22
LR = 1e-3
KW = dict(scale=2, n_groups=1, n_blocks=1, n_feats=16, contrastive_K=8, lr=LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), _np(tree))


def test_daconv_folds_the_batch_into_the_channels_as_jax():
    """(1, B*C, H, W) grouped by example * C + channel, B = 3, a kernel per
    example and channel from each example's own embedding."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 6, 16)).astype(np.float32)
    k_v = rng.standard_normal((3, 64)).astype(np.float32)
    jm = jdasr.DAConv(16)
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(k_v))["params"], 1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(k_v)))
    tm = tdasr.DAConv(16, 16)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(k_v))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=F32_ATOL, rtol=0)
    with torch.no_grad():  # each example alone gives its own slice: no mixing across examples
        one = tm(torch.from_numpy(x[1:2]).permute(0, 3, 1, 2), torch.from_numpy(k_v[1:2]))
    np.testing.assert_allclose(one.numpy(), got[1:2].numpy(), atol=F32_ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax(dtype="float32", pretrain=0):
    jh = jax_model("dasr")(dtype=dtype, encoder_pretrain_epochs=pretrain, **KW)
    js = jh.init_state()
    extra = dict(js.extra)
    extra["queue_ptr"] = jnp.asarray(2, jnp.int32)  # a write away from slot 0
    return jh, js.replace(params=jax.tree_util.tree_map(jnp.asarray, _jitter(js.params, 2)),
                          extra=extra)


def _pair(dtype="float32", pretrain=0):
    jh, js = _jax(dtype, pretrain)
    th = torch_model("dasr")(device="cpu", dtype=dtype, encoder_pretrain_epochs=pretrain, **KW)
    th.init_state()
    with torch.no_grad():
        th.module.load_state_dict(th.state_dict_from_jax_trees(_np(js.params), _np(js.extra)))
    return jh, js, th, th._own_state()


def test_dasr_forward_and_bridge_match_jax():
    jh, js, th, state = _pair()
    x = np.random.default_rng(3).random((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jh.apply(js.params, {"lr": jnp.asarray(x)}, extra=js.extra)[0])
    got = th.run_eval(state, {"lr": x}).numpy()
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    trees = th.jax_trees(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, trees["params"], _np(js.params))
    for key in ("bstats", "key_params", "queue", "queue_ptr"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, trees["extra"][key],
                               _np(js.extra[key]))


def test_dasr_bf16_forward_matches_jax():
    jh, js, th, state = _pair("bf16")
    x = np.random.default_rng(4).random((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jh.apply(js.params, {"lr": jnp.asarray(x)}, extra=js.extra)[0], np.float32)
    got = th.run_eval(state, {"lr": x}).float().numpy()
    assert _err(got, want) <= BF16_REL * np.abs(want).max()


def _adam_moments(opt_state):
    """optax's ScaleByAdamState inside a handler's optimizer state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def _port_moments(th, key):
    """The port's Adam state entry ``key`` (or "step") as flax trees of the
    sr_net and the encoder."""
    opt = th.optimizer()
    mod = th.module
    out = {}
    for child in ("sr_net", "encoder"):
        m = getattr(mod, child)
        vals = {n: (opt.state[p][key] if p in opt.state else torch.zeros_like(p))
                for n, p in m.named_parameters()}
        out[child] = jax_tree_from_state_dict(vals, m) if key != "step" else {
            n: int(opt.state[p]["step"]) for n, p in m.named_parameters() if p in opt.state}
    return out


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((n, 2, 8, 8, 3)).astype(np.float32),  # crop 0 query, 1 key
            "hr": rng.random((n, 16, 16, 3)).astype(np.float32)}


def _check_state(th, state, js, jl, tl, queue_before, ptr_before, key_before, query_before):
    """Losses, the encoder's BatchNorm statistics, the key encoder after the
    momentum update, the queue and its pointer."""
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= F32_ATOL, k
    trees = th.jax_trees(state)
    stats = _flat(trees["extra"]["bstats"])
    for k, w in _flat(_np(js.extra["bstats"])).items():
        assert _err(stats[k], w) <= 1e-5, k
    jax.tree_util.tree_map(
        lambda g, w, k, q: np.testing.assert_array_less(
            np.abs(g - np.asarray(w)), 2.0 ** -23 * (np.abs(k) + np.abs(q)) + 1e-30),
        trees["extra"]["key_params"], _np(js.extra["key_params"]), key_before, query_before)
    n = 2
    got_q, want_q = trees["extra"]["queue"], np.asarray(js.extra["queue"])
    rows = [(ptr_before + i) % len(queue_before) for i in range(n)]
    assert _err(got_q[rows], want_q[rows]) <= F32_ATOL
    others = [i for i in range(len(queue_before)) if i not in rows]
    np.testing.assert_array_equal(got_q[others], queue_before[others])
    np.testing.assert_array_equal(want_q[others], queue_before[others])
    assert int(trees["extra"]["queue_ptr"]) == int(js.extra["queue_ptr"]) == ptr_before + n


def _moments_agree(th, js):
    jm = _adam_moments(js.opt_state)
    for key, want in (("exp_avg", jm.mu), ("exp_avg_sq", jm.nu)):
        got = _flat(_port_moments(th, key))
        want = _flat(_np(want))
        tree_max = max(np.abs(w).max() for w in want.values())
        for k, w in want.items():
            under_bn = k.startswith("['encoder']['TConv_") and k.endswith("['bias']")
            scale = tree_max if under_bn else max(np.abs(w).max(), 1e-30)
            assert _err(got[k], w) <= F32_GRAD_REL * scale, (key, k)
    steps = _port_moments(th, "step")
    counts = {c for child in steps.values() for c in child.values()}
    assert counts == {int(jm.count)}, counts


def _moves_agree(got_after, want_after, before, grads):
    """Where the gradient is not tiny, both moves are Adam's, lr * m / (sqrt(v) + eps)."""
    gmax = max(np.abs(g).max() for g in grads.values())
    held = 0
    for k, w in want_after.items():
        sure = np.abs(grads[k]) >= 1e-3 * gmax
        held += int(sure.sum())
        if sure.any():
            d = np.abs((got_after[k] - before[k]) - (w - before[k]))[sure]
            assert d.max() <= F32_GRAD_REL * LR + PARAM_ULPS, k
    assert held > 0.5 * sum(w.size for w in want_after.values())


def test_dasr_two_phases_match_jax():
    """Epoch 0 with encoder_pretrain_epochs 1: the contrastive loss alone,
    the SR net's gradients zeros (Adam's count and moments advance on them,
    as optax's do); epoch 1: SR L1 + contrastive loss. Both from a 5-D
    multi-crop lr (crop 0 the query, crop 1 the key)."""
    jh, js, th, state = _pair(pretrain=1)
    b1, b2 = _batch(5), _batch(6)

    def snapshot(s, trees):
        return (trees["extra"]["queue"].copy(), int(trees["extra"]["queue_ptr"]),
                trees["extra"]["key_params"], trees["params"]["encoder"])

    before = th.jax_trees(state)
    queue_b, ptr_b, key_b, query_b = snapshot(state, before)
    js1, jl1 = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                              {k: jnp.asarray(v) for k, v in b1.items()})
    state1, tl1 = th.train_batch(state, b1)
    assert "pixel-loss" not in tl1
    _check_state(th, state1, js1, jl1, tl1, queue_b, ptr_b, key_b, query_b)
    _moments_agree(th, js1)
    sr_before = _flat(before["params"]["sr_net"])
    after1 = th.jax_trees(state1)
    for k, v in _flat(after1["params"]["sr_net"]).items():
        np.testing.assert_array_equal(v, sr_before[k])
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(js1.params["sr_net"]),
                           before["params"]["sr_net"])

    # the joint step, both from JAX's weights after the pretrain step
    jh.set_epoch(1)
    th.set_epoch(1)
    with torch.no_grad():
        th.module.load_state_dict(th.state_dict_from_jax_trees(_np(js1.params), _np(js1.extra)))
    mid = th.jax_trees(state1)
    queue_b, ptr_b, key_b, query_b = snapshot(state1, mid)
    gp = _flat(jax.tree_util.tree_map(np.asarray, _adam_moments(js1.opt_state).mu))
    js2, jl2 = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js1),
                              {k: jnp.asarray(v) for k, v in b2.items()})
    state2, tl2 = th.train_batch(state1, b2)
    assert {"pixel-loss", "contrastive-loss", "train-loss"} == set(tl2)
    _check_state(th, state2, js2, jl2, tl2, queue_b, ptr_b, key_b, query_b)
    _moments_agree(th, js2)
    mu2 = _flat(_np(_adam_moments(js2.opt_state).mu))
    grads = {k: mu2[k] - 0.9 * gp[k] for k in mu2}  # 0.1 g of the joint step
    _moves_agree(_flat(th.jax_trees(state2)["params"]), _flat(_np(js2.params)),
                 _flat(mid["params"]), grads)


def test_queue_must_divide_by_the_batch_in_both():
    jh, js, th, state = _pair()
    b = _batch(7, n=3)
    with pytest.raises(ValueError, match="multiple"):
        jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), {k: jnp.asarray(v)
                                                              for k, v in b.items()})
    with pytest.raises(ValueError, match="multiple"):
        th.train_batch(state, b)


@pytest.mark.parametrize("size", [(9, 11), (8, 8)])
def test_dcls_kernels_and_loss_match_jax(size):
    """Flax's 'SAME' padding at stride 2 (one pixel before, two after on an
    even side), the softmaxed kernels summing to 1, the L1 loss and its
    gradients."""
    jh = jax_model("dcls")(nf=8, kernel_size=21)
    params = _jitter(jh.init_state().params, 8)
    th = torch_model("dcls")(device="cpu", nf=8, kernel_size=21)
    th.init_state()
    with torch.no_grad():
        th.module.load_state_dict(state_dict_from_jax(params, th.module))
    rng = np.random.default_rng(9)
    x = rng.random((2, *size, 3)).astype(np.float32)
    k = rng.random((2, 441)).astype(np.float32)
    meta = k / k.sum(axis=1, keepdims=True)
    want = np.asarray(jh.apply(params, {"lr": jnp.asarray(x)})[0])
    got, _, _ = th.apply(th._own_state().params, {"lr": x})
    assert got.shape == (2, 21, 21)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.detach().sum(dim=(1, 2)).numpy(), 1.0, atol=1e-5)
    batch = {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}
    jloss, gp = jax.value_and_grad(lambda p: jh.compute_losses(
        jh.apply(p, batch)[0], batch, {})["train-loss"])(params)
    tloss = th.compute_losses(got, {"metadata": meta}, {})["train-loss"]
    assert abs(float(tloss) - float(jloss)) <= F32_ATOL
    tloss.backward()
    g = _flat(jax_tree_from_state_dict({n: p.grad for n, p in th.module.named_parameters()},
                                       th.module))
    for key, w in _flat(_np(gp)).items():
        assert _err(g[key], w) <= F32_GRAD_REL * max(np.abs(w).max(), 1e-12), key
    back = jax_tree_from_state_dict(th.module.state_dict(), th.module)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_dcls_he_normal_init_scale():
    th = torch_model("dcls")(device="cpu", nf=32)
    th.init_state()
    w = th.module.convs[1].weight
    assert abs(float(w.std()) - (2.0 / (32 * 25)) ** 0.5) < 0.1 * (2.0 / (32 * 25)) ** 0.5
    assert float(th.module.dense.weight.abs().max()) <= 1 / 32 ** 0.5


def test_an_hr_only_multi_crop_batch_fails_in_both():
    """The trainer's online chain makes HR-only batches, (B, P, H, W, C) with
    crop_count P; DASR's step never runs a handler's input pipeline, so
    such a batch has no views and fails in both packages (ROADMAP.md
    section 3): DASR trains on LR/HR pairs or on views a caller degrades."""
    jh, js, th, state = _pair()
    hr = np.random.default_rng(10).random((2, 2, 16, 16, 3)).astype(np.float32)
    with pytest.raises(KeyError):
        jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), {"hr": jnp.asarray(hr)})
    with pytest.raises(KeyError):
        th.train_batch(state, {"hr": hr})


def test_dasr_trains_on_multi_crop_pairs_through_the_cli(tmp_path):
    """LR/HR .npy pairs with crop_count 2 through cli.train_sisr on the CPU:
    the data layer stacks two LR crops (crop 0 the query, with its HR)."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    rng = np.random.default_rng(11)
    lr_dir, hr_dir = tmp_path / "lr", tmp_path / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k in range(4):
        hr = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
        np.save(hr_dir / f"im{k}.npy", hr)
        np.save(lr_dir / f"im{k}.npy", np.ascontiguousarray(hr[::2, ::2]))
    cfg = {"experiment": "dasr", "experiment_save_loc": str(tmp_path / "Results"),
           "data": {"scale": 2, "crop": 8, "crop_count": 2, "dataloader_threads": 1,
                    "training_sets": {"data_1": {"lr_dir": str(lr_dir), "hr_dir": str(hr_dir)}}},
           "model": {"name": "dasr", "internal_params": dict(KW)},
           "training": {"num_epochs": 1, "batch_size": 2, "seed": 0}}
    path = tmp_path / "dasr.toml"
    dump_toml(cfg, str(path))
    stats = train_sisr.main(["-p", str(path), "--device", "cpu"])
    assert {"pixel-loss", "contrastive-loss", "train-loss"} <= set(stats[0])
    assert np.isfinite([stats[0][k] for k in ("pixel-loss", "contrastive-loss")]).all()
