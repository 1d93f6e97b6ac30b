"""Joint BoBW training in the port on the CPU, against the JAX package:
``contrastiveblindqrcan`` with ``combined_loss_mode`` "moco" and "supmoco"
at the sizes of tests/test_blind_sr.py, from one state bridged from the
JAX handler (the queue and its labels included), one step each.

Held: the three losses (train, pixel, contrastive); the generator's and
the encoder's parameters after the step (SGD at lr 1, so these are the
gradients); the encoder's BatchNorm running
statistics, which must advance exactly once (the JAX step runs the encoder
three times and keeps one update); the key encoder after the momentum
update; the queue, its pointer and its labels. Tolerances in f32: losses,
parameters and statistics within 1e-6 (the same f32 products summed in
another order), the key encoder within one float32 ulp of its operands'
size (one product and one sum of the same values, which XLA may fuse); the queue rows the step writes are the key encoder's
normalized projections (eight layers of f32 sums in another order),
within 1e-5, every other row bit for bit; the
pointer and the labels exact. In bf16 (flax rounds every op to bf16, the
port's RCAB only h1 and the block's output): the losses (against the
largest of them: a contrastive loss near 0 has no relative precision),
statistics, the queue and the parameters after one step of the default Adam within 2**-7
of their largest entry (XLA keeps excess precision in a jitted bf16 step:
its enqueued keys are not bf16 values, the port's are). An Adam step at
lr 1e-4 moves a parameter by far less than that limit, so the bf16
gradients are held on their own, against an f32 witness: JAX's f32 step
from the same state and batch. The two packages' bf16 gradients are not
compared with each other: flax sums a bias gradient in bf16, and JAX's
bf16 gradients stood 13-16 % (by norm) from the witness, the port's 0.25 %
(generator) and 9-10 % (encoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict

# SGD at lr 1: a parameter moves by its gradient. Adam's first step,
# lr * g / (|g| + 1e-8), would move a parameter whose gradient rounding
# leaves near 1e-8 by an amount that rounding decides.
GEN_KW = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=1, contrastive_K=8,
              encoder_dim=64, block_encoder_loading=True, optimizer_type="sgd", lr=1.0)
MODES = {"moco": dict(combined_loss_mode="moco", crop_count=2),
         "supmoco": dict(combined_loss_mode="supmoco", crop_count=3, num_classes=4)}
QUEUE_LABELS = np.array([0, 1, 2, 3, -1, 1, -1, 0], np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_diff(a, b):
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda u, v: float(np.abs(np.asarray(u, np.float32) - np.asarray(v, np.float32)).max()),
        a, b)))


def _momentum_agrees(got, want, key_before, query_before):
    """The key encoder after ``key * m + query * (1 - m)``: leaf for leaf
    within one float32 ulp of the operands' size, 2**-23 (|key| + |query|)
    (one product and one sum of the same values, which XLA may fuse; a
    result that cancels is exact only to its operands' ulps)."""
    jax.tree_util.tree_map(
        lambda g, w, k, q: np.testing.assert_array_less(
            np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)),
            2.0 ** -23 * (np.abs(np.asarray(k)) + np.abs(np.asarray(q))) + 1e-30),
        got, want, key_before, query_before)


def _max_abs(tree):
    return max(float(np.abs(np.asarray(v, np.float32)).max())
               for v in jax.tree_util.tree_leaves(tree))


def _pair(mode, dtype, **over):
    kw = dict(GEN_KW, dtype=dtype, **MODES[mode], **over)
    jh = jax_model("contrastiveblindqrcan")(**kw)
    js = jh.init_state()
    extra = dict(js.extra)
    extra["queue_ptr"] = jnp.asarray(2, jnp.int32)  # a write away from slot 0
    if mode == "supmoco":
        extra["queue_labels"] = jnp.asarray(QUEUE_LABELS)  # queue positives to find
    js = js.replace(extra=extra)
    th = torch_model("contrastiveblindqrcan")(device="cpu", **kw)
    th.module.load_state_dict(th._jax_state_dict({"network": _np(js.params),
                                                  "extra": _np(js.extra)}))
    return jh, js, th, th._own_state()


def _batch(mode, seed=0, n=2):
    rng = np.random.default_rng(seed)
    crops = MODES[mode]["crop_count"] - 1
    b = {"lr": rng.random((n, 8, 8, 3)).astype(np.float32),
         "image_key": rng.random((n * crops, 8, 8, 3)).astype(np.float32),
         "hr": rng.random((n, 16, 16, 3)).astype(np.float32)}
    if mode == "supmoco":
        b["labels"] = np.array([1, 3], np.int32)[:n]
    return b


def _step(jh, js, th, state, batch):
    # the JAX step donates its state: hand it a copy
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    state2, tl = th.train_batch(state, batch)
    return js2, jl, state2, tl


@pytest.mark.parametrize("mode", list(MODES))
def test_joint_step_matches_jax_f32(mode):
    jh, js, th, state = _pair(mode, "float32")
    stats_before = {k: v.clone() for k, v in state.params.items()
                    if k.startswith("encoder.") and "running" in k}
    queue_before = state.params["queue"].clone()
    batch = _batch(mode)
    js2, jl, state2, tl = _step(jh, js, th, state, batch)
    assert set(tl) == {"train-loss", "pixel-loss", "contrastive-loss"}
    for k in tl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-6, k
    mod = th.module
    for name in ("generator", "encoder"):
        sd = {k[len(name) + 1:]: v for k, v in state2.params.items()
              if k.startswith(name + ".")}
        assert _max_diff(jax_tree_from_state_dict(sd, getattr(mod, name)),
                         _np(js2.params[name])) <= 1e-6, name
    enc_sd = {k[8:]: v for k, v in state2.params.items() if k.startswith("encoder.")}
    want_stats = _np(js2.extra["bstats"]["encoder"])
    assert _max_diff(jax_tree_from_state_dict(enc_sd, mod.encoder, "batch_stats"),
                     want_stats) <= 1e-6 * _max_abs(want_stats)
    # advanced once: the one flax update of the pipeline's forward
    assert all(not torch.equal(state2.params[k], v) for k, v in stats_before.items())
    key_sd = {k[12:]: v for k, v in state2.params.items() if k.startswith("key_encoder.")}
    _momentum_agrees(jax_tree_from_state_dict(key_sd, mod.key_encoder),
                     _np(js2.extra["key_params"]), _np(js.extra["key_params"]),
                     _np(js.params["encoder"]))
    queue, want_q = state2.params["queue"].numpy(), np.asarray(js2.extra["queue"])
    written = [2, 3]
    np.testing.assert_allclose(queue[written], want_q[written], atol=1e-5, rtol=0)
    rest = [i for i in range(8) if i not in written]
    np.testing.assert_array_equal(queue[rest], want_q[rest])
    np.testing.assert_array_equal(queue[rest], queue_before.numpy()[rest])
    assert int(state2.params["queue_ptr"]) == int(js2.extra["queue_ptr"]) == 4
    if mode == "supmoco":
        np.testing.assert_array_equal(state2.params["queue_labels"].numpy(),
                                      np.asarray(js2.extra["queue_labels"]))
        assert state2.params["queue_labels"].numpy()[written].tolist() == [1, 3]


@pytest.mark.parametrize("mode", list(MODES))
def test_joint_step_matches_jax_bf16(mode):
    jh, js, th, state = _pair(mode, "bf16", optimizer_type="adam", lr=1e-4)
    batch = _batch(mode, seed=1)
    js2, jl, state2, tl = _step(jh, js, th, state, batch)
    largest = max(abs(float(v)) for v in jl.values())
    for k in tl:
        assert abs(float(tl[k]) - float(jl[k])) <= 2.0 ** -7 * largest, k
    mod = th.module
    for name in ("generator", "encoder"):
        sd = {k[len(name) + 1:]: v for k, v in state2.params.items()
              if k.startswith(name + ".")}
        want = _np(js2.params[name])
        assert _max_diff(jax_tree_from_state_dict(sd, getattr(mod, name)),
                         want) <= 2.0 ** -7 * _max_abs(want), name
    enc_sd = {k[8:]: v for k, v in state2.params.items() if k.startswith("encoder.")}
    want_stats = _np(js2.extra["bstats"]["encoder"])
    assert _max_diff(jax_tree_from_state_dict(enc_sd, mod.encoder, "batch_stats"),
                     want_stats) <= 2.0 ** -7 * _max_abs(want_stats)
    queue, want_q = state2.params["queue"].numpy(), np.asarray(js2.extra["queue"])
    assert np.abs(queue - want_q).max() <= 2.0 ** -7 * np.abs(want_q).max()
    assert int(state2.params["queue_ptr"]) == 4


# Limits on |bf16 move - f32 move| / |f32 move| (norms over a module's
# parameters). A gradient of half the batch stood 8.5-9.2 % (generator)
# and 100-106 % (encoder) from the full one; a dropped gradient stands at
# 100 %, one of the wrong sign at 200 %.
BF16_MOVE_REL = {"generator": 2.0 ** -5, "encoder": 2.0 ** -2}


def _flat_moves(before, after, name):
    return torch.cat([(before[k] - after[k]).float().flatten() for k in sorted(before)
                      if k.startswith(name + ".") and "running" not in k])


@pytest.mark.parametrize("mode", list(MODES))
def test_joint_bf16_gradients_match_an_f32_witness(mode):
    """The port's bf16 joint step under SGD at lr 1 moves the generator and
    the encoder by their bf16 gradients; JAX's f32 step from the same state
    and batch moves them by the f32 ones. Each module's bf16 move stands
    within BF16_MOVE_REL of the f32 move, by norm."""
    jh, js, th, state = _pair(mode, "bf16")
    jh32 = jax_model("contrastiveblindqrcan")(**dict(GEN_KW, dtype="float32", **MODES[mode]))
    js32 = jh32.init_state().replace(params=jax.tree_util.tree_map(jnp.copy, js.params),
                                     extra=jax.tree_util.tree_map(jnp.copy, js.extra))
    batch = _batch(mode, seed=1)
    before = {k: v.clone() for k, v in state.params.items()}
    state2, _ = th.train_batch(state, batch)
    js32b, _ = jh32.train_batch(js32, {k: jnp.asarray(v) for k, v in batch.items()})

    def bridged(s):
        return th._jax_state_dict({"network": _np(s.params), "extra": _np(s.extra)})

    w_before, w_after = bridged(js), bridged(js32b)
    for name, limit in BF16_MOVE_REL.items():
        got = _flat_moves(before, state2.params, name)
        want = _flat_moves(w_before, w_after, name)
        assert float(want.norm()) > 0, name
        assert float((got - want).norm()) <= limit * float(want.norm()), name


def test_joint_multicrop_stack_splits_like_jax():
    """A 5-D ``lr`` (B, P, h, w, C): crop 0 is the SR and query view, the
    rest the keys, in both packages (the supmoco step with its labels)."""
    jh, js, th, state = _pair("supmoco", "float32")
    b = _batch("supmoco", seed=2)
    stack = np.concatenate([b["lr"][:, None], b["image_key"].reshape(2, 2, 8, 8, 3)], axis=1)
    batch = {"lr": stack, "hr": b["hr"], "labels": b["labels"]}
    js2, jl, state2, tl = _step(jh, js, th, state, batch)
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6


@pytest.mark.parametrize("mode", list(MODES))
def test_joint_queue_batch_must_divide_k(mode):
    """K % n != 0 raises in both packages, before any state moves."""
    jh, js, th, state = _pair(mode, "float32")
    b = _batch(mode, n=3) if mode == "moco" else None
    if mode == "supmoco":
        rng = np.random.default_rng(3)
        b = {"lr": rng.random((3, 8, 8, 3)).astype(np.float32),
             "image_key": rng.random((6, 8, 8, 3)).astype(np.float32),
             "hr": rng.random((3, 16, 16, 3)).astype(np.float32),
             "labels": np.array([0, 1, 2], np.int32)}
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(ValueError, match="multiple of the global enqueue batch"):
        jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                       {k: jnp.asarray(v) for k, v in b.items()})
    with pytest.raises(ValueError, match="multiple of the global enqueue batch"):
        th.train_batch(state, b)
    assert all(torch.equal(before[k], v) for k, v in state.params.items())


def test_joint_encoder_is_trainable_and_key_encoder_is_not():
    _, _, th, _ = _pair("moco", "float32")
    trainable = {id(p) for p in th.trainable_parameters()}
    assert all(id(p) in trainable for p in th.module.encoder.parameters())
    assert all(id(p) in trainable for p in th.module.generator.parameters())
    assert not any(id(p) in trainable for p in th.module.key_encoder.parameters())
