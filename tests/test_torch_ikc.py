"""IKC in the port, on the CPU, against the JAX package: the Predictor, the
Corrector and SFTMD through the bridge (both ways), the SFTMD pretrain
step, the IKC step (one predictor update, then ``correction_steps`` SFTMD
forwards without a gradient and corrector updates inside one
``train_batch``), the eval's per-call dispatch on the phase and the
metadata, checkpoints with three optimizer states, and a JAX-written IKC
checkpoint loaded into the port.

Flax params carried over by the weight bridge (biases jittered off zero),
inputs from a numpy seed. Each child has its own Adam at the handler's lr
in both packages; the steps are compared with SGD at lr 1 (momentum 0.9)
in both in its place, so that a parameter moves by its gradient (Adam's
first move, lr * g / (|g| + 1e-8), lets rounding decide where g is
tiny), and the port's Adam states are checked by their step counts.
Tolerances: f32 outputs and losses within 1e-5 (the same f32 products
summed in another order), gradients, and parameters after the steps,
within 1e-4 of each leaf's largest gradient plus two float32 ulps of a
parameter below 1; bf16 outputs within 2**-6 of the largest output.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22
LR = 1e-4
KW = dict(scale=2, num_features=16, num_blocks=1, code_length=10, correction_steps=2,
          sftmd_pretrain_epochs=1, lr=LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@functools.lru_cache(maxsize=None)
def _jax(dtype="float32"):
    jh = jax_model("ikc")(dtype=dtype, **KW)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        _np(jh.init_state().params))
    return jh, params


def _pair(dtype="float32", sgd=False):
    """The JAX handler and state, and the port's handler carrying the same
    params. ``sgd``: a JAX handler of its own whose three children step by
    SGD at lr 1, and the same optimizers in the port."""
    jh, params = _jax(dtype)
    if sgd:
        jh = jax_model("ikc")(dtype=dtype, **KW)
        jh.child_tx = {n: optax.sgd(1.0, momentum=0.9) for n in jh.child_tx}
    js = jh.init_state()
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                    opt_state={n: jh.child_tx[n].init(params[n]) for n in jh.child_tx})
    th = torch_model("ikc")(device="cpu", dtype=dtype, **KW)
    th.init_state()
    with torch.no_grad():
        th.module.load_state_dict(state_dict_from_jax(params, th.module))
    if sgd:
        th._optimizers = {n: torch.optim.SGD(getattr(th.module, n).parameters(), lr=1.0,
                                             momentum=0.9)
                          for n in ("sr_model", "predictor", "corrector")}
    return jh, js, th, th._own_state()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((2, 8, 8, 3)).astype(np.float32),
            "hr": rng.random((2, 16, 16, 3)).astype(np.float32),
            "metadata": rng.random((2, 10)).astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _params_agree(th, state, js, before):
    """Every parameter after the step against JAX's, within 1e-4 of the
    leaf's largest move (its gradients, at lr 1)."""
    got = _flat(jax_tree_from_state_dict(state.params, th.module))
    want = _flat(_np(js.params))
    assert set(got) == set(want)
    for k, w in want.items():
        move = np.abs(w - before[k]).max()
        assert _err(got[k], w) <= F32_GRAD_REL * max(move, 1e-6) + PARAM_ULPS, k


def test_children_forward_and_bridge_match_jax():
    jh, js, th, state = _pair()
    b = _batch()
    x = torch.from_numpy(b["lr"]).permute(0, 3, 1, 2)
    code = np.asarray(jh.module.apply({"params": js.params}, jnp.asarray(b["lr"]),
                                      method="predict"))
    with torch.no_grad():
        got = th.module.predictor(x)
    np.testing.assert_allclose(got.numpy(), code, atol=F32_ATOL, rtol=0)
    sr = np.asarray(jh.module.apply({"params": js.params}, jnp.asarray(b["lr"]),
                                    jnp.asarray(code)))
    with torch.no_grad():
        got_sr = th.module(x, torch.from_numpy(code)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_sr.numpy(), sr, atol=F32_ATOL, rtol=0)
    new = np.asarray(jh.module.apply({"params": js.params}, jnp.asarray(sr), jnp.asarray(code),
                                     method="correct"))
    with torch.no_grad():
        got_new = th.module.corrector(torch.from_numpy(sr).permute(0, 3, 1, 2),
                                      torch.from_numpy(code))
    np.testing.assert_allclose(got_new.numpy(), new, atol=F32_ATOL, rtol=0)
    back = jax_tree_from_state_dict(th.module.state_dict(), th.module)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, _np(js.params))


def test_pretrain_step_matches_jax():
    """Only SFTMD steps, on the true code (L1); its gradients against
    jax.grad; the predictor and corrector stay as they are."""
    jh, js, th, state = _pair(sgd=True)
    b = _batch(1)
    before = _flat(_np(js.params))
    gp = jax.grad(lambda p: jnp.mean(jnp.abs(jh.module.apply(
        {"params": {**js.params, "sr_model": p}}, jnp.asarray(b["lr"]),
        jnp.asarray(b["metadata"])) - b["hr"])))(js.params["sr_model"])
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jbatch(b))
    state2, tl = th.train_batch(state, b)
    assert set(tl) == set(jl) == {"train-loss", "predictor-loss"}
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= F32_ATOL, k
    grads = {k: p.grad for k, p in th.module.sr_model.named_parameters()}
    got = _flat(jax_tree_from_state_dict(grads, th.module.sr_model))
    for k, w in _flat(_np(gp)).items():
        assert _err(got[k], w) <= F32_GRAD_REL * max(np.abs(w).max(), 1e-6), k
    assert all(p.grad is None for n in ("predictor", "corrector")
               for p in getattr(th.module, n).parameters())
    _params_agree(th, state2, js2, before)
    _, _, th2, state3 = _pair()
    th2.train_batch(state3, b)
    assert set(th2.optimizer_state()) == {"sr_model"}  # Adam, one step
    assert int(next(iter(th2.optimizer_state()["sr_model"]["state"].values()))["step"]) == 1


def test_ikc_step_matches_jax():
    """After the pretrain epochs: the predictor's update, then per
    correction step SFTMD without a gradient and the corrector's update;
    every per-step loss, the minimum as train-loss, the predictor and the
    corrector after their steps (the corrector stepped correction_steps
    times), SFTMD untouched, and the stepped model's blind eval image."""
    jh, js, th, state = _pair(sgd=True)
    jh.set_epoch(1)
    th.set_epoch(1)
    b = _batch(2)
    before = _flat(_np(js.params))
    sr_before = {k: v.clone() for k, v in state.params.items() if k.startswith("sr_model.")}
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jbatch(b))
    state2, tl = th.train_batch(state, b)
    assert set(tl) == set(jl)
    assert {f"sftmd_loss_{i}" for i in range(2)} | {f"corrector_loss_{i}" for i in range(2)} \
        <= set(tl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= F32_ATOL, k
    assert float(tl["train-loss"]) == min(float(tl["sftmd_loss_0"]), float(tl["sftmd_loss_1"]))
    _params_agree(th, state2, js2, before)
    assert all(torch.equal(state2.params[k], v) for k, v in sr_before.items())
    jh2, js3, th2, state3 = _pair()  # Adam at lr 1e-4, the handlers' own optimizers
    jh2.set_epoch(1)
    th2.set_epoch(1)
    js4, _ = jh2.train_batch(jax.tree_util.tree_map(jnp.copy, js3), _jbatch(b))
    th2.train_batch(state3, b)
    opt = th2.optimizer_state()  # the corrector stepped twice, the predictor once
    assert set(opt) == {"predictor", "corrector"}
    assert int(next(iter(opt["corrector"]["state"].values()))["step"]) == 2
    assert int(next(iter(opt["predictor"]["state"].values()))["step"]) == 1
    # the blind eval image of the stepped model, JAX's stepped params carried over
    want = np.asarray(jh2.run_eval(js4, {"lr": jnp.asarray(b["lr"])}))
    with torch.no_grad():
        th2.module.load_state_dict(state_dict_from_jax(_np(js4.params), th2.module))
    got = th2.run_eval(th2._own_state(), {"lr": b["lr"]}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("epoch,with_meta", [(0, True), (0, False), (1, True)])
def test_eval_dispatch_matches_jax(epoch, with_meta):
    """SFTMD on the true code only in the pretrain phase and with metadata;
    else the predictor and the corrector loop."""
    jh, js, th, state = _pair()
    jh.set_epoch(epoch)
    th.set_epoch(epoch)
    b = _batch(4)
    batch = {"lr": b["lr"]}
    if with_meta:
        batch["metadata"] = b["metadata"]
    want = np.asarray(jh.run_eval(js, _jbatch(batch)))
    got = th.run_eval(state, batch).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    blind = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(b["lr"])}))
    assert (np.abs(got - blind).max() > 1e-4) == (epoch == 0 and with_meta)


def test_bf16_blind_eval_matches_jax():
    jh, js, th, state = _pair("bf16")
    jh.set_epoch(1)
    th.set_epoch(1)
    x = _batch(5)["lr"]
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}), np.float32)
    got = th.run_eval(state, {"lr": x}).float().numpy()
    assert _err(got, want) <= BF16_REL * np.abs(want).max()


def test_checkpoint_round_trip_keeps_three_optimizer_states(tmp_path):
    """Save after a pretrain and an IKC step, load into a fresh handler: the
    three Adam states, the weights, the handler metadata; the next IKC
    step is then the same bit for bit."""
    _, _, th, state = _pair()
    b = _batch(6)
    state, _ = th.train_batch(state, b)
    th.set_epoch(1)
    state, _ = th.train_batch(state, b)
    th.save_model(state, str(tmp_path), 1)
    raw = torch.load(tmp_path / "train_model_1", weights_only=True)
    assert set(raw["optimizer"]) == {"sr_model", "predictor", "corrector"}
    assert raw["handler_metadata"] == {"best_epoch_cutoff": 1, "correction_steps": 2}
    th2 = torch_model("ikc")(device="cpu", **KW)
    state2, epoch = th2.load_model(str(tmp_path), 1)
    assert epoch == 1
    th2.set_epoch(1)
    for name in ("sr_model", "predictor", "corrector"):
        a, c = th.optimizer_state()[name]["state"], th2.optimizer_state()[name]["state"]
        assert a.keys() == c.keys()
        for i in a:
            assert all(torch.equal(a[i][k], c[i][k]) for k in a[i])
    _, l1 = th.train_batch(state, _batch(7))
    _, l2 = th2.train_batch(state2, _batch(7))
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert all(torch.equal(state.params[k], state2.params[k]) for k in state.params)
    th3 = torch_model("ikc")(device="cpu", **KW)
    th3.load_model(str(tmp_path), 1, skip_optimizer_load=True)
    assert th3.optimizer_state() is None


def test_jax_written_checkpoint_loads(tmp_path):
    """The JAX package's IKC checkpoint (flax msgpack): its params through
    the bridge; its three optax states onto the children's torch Adams,
    unless skipped."""
    jh, js, th, _ = _pair()
    jh.save_model(js, str(tmp_path), 3)
    fresh = torch_model("ikc")(device="cpu", **KW)
    fresh.load_model(str(tmp_path), 3)
    assert set(fresh.optimizer_state()) == {"sr_model", "predictor", "corrector"}
    state, epoch = fresh.load_model(str(tmp_path), 3, skip_optimizer_load=True)
    assert epoch == 3
    back = jax_tree_from_state_dict(state.params, fresh.module)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, _np(js.params))


def test_pretrain_eval_on_a_wider_metadata_row_fails_in_both():
    """IKC has no metadata column selection: in the pretrain phase the
    eval's whole metadata row is SFTMD's code, so an eval set whose CSV
    holds a column beside the 10 kernel-code values (the downsample's
    scale, as the online chain's CSV does) fails in both packages
    (ROADMAP.md section 3)."""
    jh, js, th, state = _pair()
    jh.set_epoch(0)
    th.set_epoch(0)
    b = _batch(8)
    wide = np.concatenate([b["metadata"], np.full((2, 1), 4.0, np.float32)], axis=1)
    with pytest.raises(flax.errors.ScopeParamShapeError):  # flax's param shape check
        np.asarray(jh.run_eval(js, {"lr": jnp.asarray(b["lr"]), "metadata": jnp.asarray(wide)}))
    with pytest.raises(RuntimeError, match="channels"):
        th.run_eval(state, {"lr": b["lr"], "metadata": wide})
    assert not hasattr(th, "select_metadata") and not hasattr(jh, "select_metadata")
