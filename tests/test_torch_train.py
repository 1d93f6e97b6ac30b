"""The port's train step (rumpy_tpu_torch.models.base) against the JAX
package's: schedules per step, and 25-step trajectories of a small RCAN
from bridged initial weights on fixed batches, on the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import base as jbase
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import base as tbase
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import (jax_tree_from_state_dict,
                                           state_dict_from_jax)

RCAN_KW = dict(scale=2, n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4)

SCHEDULES = [
    (None, {}),
    ("multi_step_lr", {"milestones": [5, 40, 41, 150], "gamma": 0.5}),
    ("step_lr", {"step_size": 30, "gamma": 0.1}),
    ("cosine_annealing_warm_restarts", {"restart_period": 50, "lr_min": 1e-6}),
    ("cosine_warm_restarts", {"t_0": 20, "t_mult": 2, "eta_min": 1e-7}),
    ("one_cycle_lr", {"total_steps": 200, "lr_max": 1e-2}),
    ("one_cycle", {"total_steps": 180, "pct_start": 0.25,
                   "anneal_strategy": "linear", "div_factor": 10.0}),
    ("custom_dasr", {"train_type": "long"}),
    ("custom_dasr", {"train_type": "short"}),
    ("custom_dasr", {"train_type": "no_encoder_long"}),
    ("custom_contrastive", {}),
    ("cosine", {"total_steps": 150, "alpha": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, params):
    """Every scheduler name, 200 steps from t = 0 (300 for the lambdas that
    change after step 225). rtol 1e-6, plus an absolute 2e-7 of the peak
    lr: the JAX side computes in float32, whose cosine near the end of a
    cycle carries that much rounding against a value close to zero."""
    lr = 3e-4
    steps = 300 if name in ("custom_dasr", "custom_contrastive") else 200
    jsched = jbase.build_schedule(lr, name, params)
    tsched = tbase.build_schedule(lr, name, params)
    want = np.array([float(jsched(t)) if callable(jsched) else jsched
                     for t in range(steps)])
    got = np.array([tsched(t) for t in range(steps)])
    peak = max(float(np.abs(want).max()), lr)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7 * peak)


def test_custom_schedule_and_unknown_name():
    sched = tbase.build_schedule(2.0, "custom", {"function": lambda t: t + 1})
    assert sched(4) == 10.0
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tbase.build_schedule(1e-4, "bogus")
    with pytest.raises(ValueError, match="one_cycle_lr needs"):
        tbase.build_schedule(1e-4, "one_cycle_lr", {"total_steps": 2})
    with pytest.raises(ValueError, match="DASR"):
        tbase.build_schedule(1e-4, "custom_dasr", {})


def test_clip_by_global_norm_is_optax_rule():
    """clip / max(norm, clip), with no epsilon: a norm below the limit is
    left exactly as it is, one above comes out at exactly the limit."""
    rng = np.random.default_rng(0)
    for scale in (0.01, 10.0):
        gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale)
              for s in ((3, 4), (5,), (2, 2, 2))]
        before = [g.clone() for g in gs]
        norm = float(torch.sqrt(sum((g ** 2).sum() for g in gs)))
        tbase.clip_by_global_norm(gs, 1.0)
        factor = 1.0 / max(norm, 1.0)
        for g, b in zip(gs, before):
            torch.testing.assert_close(g, b * factor, rtol=1e-6, atol=0)
        if scale < 1:
            assert all(torch.equal(g, b) for g, b in zip(gs, before))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _handlers(**kw):
    jh = jax_model("rcan")(**RCAN_KW, **kw)
    js = jh.init_state()
    th = torch_model("rcan")(device="cpu", **RCAN_KW, **kw)
    th.init_state()
    th.module.load_state_dict(state_dict_from_jax(_np_tree(js.params), th.module))
    return jh, js, th, th._own_state()


def _batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((steps, 2, 10, 12, 3)).astype(np.float32),
            rng.random((steps, 2, 20, 24, 3)).astype(np.float32))


def _assert_leaves_close(ts, th, js, atol):
    got = jax.tree_util.tree_leaves_with_path(
        jax_tree_from_state_dict(ts.params, th.module))
    want = dict(jax.tree_util.tree_leaves_with_path(_np_tree(js.params)))
    assert len(got) == len(want)
    worst = max(float(np.abs(leaf - want[path]).max()) for path, leaf in got)
    assert worst <= atol, f"worst parameter difference {worst} > {atol}"


TRAJECTORIES = {
    "adam_multistep": dict(lr=1e-3, scheduler="multi_step_lr",
                           scheduler_params={"milestones": [5, 15, 22], "gamma": 0.5}),
    "rmsprop": dict(lr=1e-4, optimizer_type="rmsprop",
                    optimizer_params={"alpha": 0.95}),
    "adam_clipped": dict(lr=1e-3, grad_clip=0.05, loss="charbonnier"),
    "sgd_cosine": dict(lr=1e-2, optimizer_type="sgd", scheduler="cosine",
                       scheduler_params={"total_steps": 25}, loss="l2"),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_trajectory_matches_jax(name):
    """25 steps on fixed batches from the same weights: per-step loss
    within 1e-5, final parameters leaf for leaf within 1e-4."""
    torch.set_num_threads(2)
    steps = 25
    jh, js, th, ts = _handlers(**TRAJECTORIES[name])
    xs, ys = _batches(steps)
    for i in range(steps):
        js, jl = jh.train_batch(js, {"lr": jnp.asarray(xs[i]), "hr": jnp.asarray(ys[i])})
        ts, tl = th.train_batch(ts, {"lr": xs[i], "hr": ys[i]})
        assert abs(float(jl["train-loss"]) - float(tl["train-loss"])) < 1e-5, i
    assert ts.step == steps == int(js.step)
    _assert_leaves_close(ts, th, js, 1e-4)


def test_clipping_is_active_in_its_trajectory():
    """The clipped trajectory's limit really binds: the first gradient's
    global norm exceeds it."""
    _, _, th, ts = _handlers(**TRAJECTORIES["adam_clipped"])
    xs, ys = _batches(1)
    th.grad_clip = None
    th.lr = 0.0
    th.schedule = lambda t: 0.0
    th.train_batch(ts, {"lr": xs[0], "hr": ys[0]})
    norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in th.module.parameters())))
    assert norm > 0.05


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    """save -> load (optimizer moments and step included) -> one more step
    gives the parameters of the run that never stopped; skipping the
    optimizer state, or a minimal checkpoint, gives different ones."""
    kw = dict(lr=1e-3, scheduler="step_lr",
              scheduler_params={"step_size": 2, "gamma": 0.5})
    xs, ys = _batches(4, seed=1)
    th = torch_model("rcan")(device="cpu", **RCAN_KW, **kw)
    ts = th.init_state(seed=3)
    for i in range(3):
        ts, _ = th.train_batch(ts, {"lr": xs[i], "hr": ys[i]})
    th.save_model(ts, str(tmp_path / "full"), epoch=0)
    th.save_model(ts, str(tmp_path / "minimal"), epoch=0, minimal=True)
    ts, _ = th.train_batch(ts, {"lr": xs[3], "hr": ys[3]})
    want = {k: v.clone() for k, v in ts.params.items()}

    def resumed(folder, **load_kw):
        h = torch_model("rcan")(device="cpu", **RCAN_KW, **kw)
        state, epoch = h.load_model(str(tmp_path / folder), "last", **load_kw)
        assert epoch == 0 and state.step == 3
        state, _ = h.train_batch(state, {"lr": xs[3], "hr": ys[3]})
        return state.params

    got = resumed("full")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7)
    for params in (resumed("full", skip_optimizer_load=True), resumed("minimal")):
        assert max(float((params[k] - want[k]).abs().max()) for k in want) > 1e-5


def test_loss_masking_and_update_hooks():
    """loss_masking drops pixels whose mask has a black channel;
    transform_grads and transform_updates see named tensors and can
    freeze parameters."""
    xs, ys = _batches(1, seed=2)
    mask = np.ones_like(ys[0])
    mask[:, :10, :, 1] = 0.0  # the top half has one black channel
    th = torch_model("rcan")(device="cpu", loss_masking=True, **RCAN_KW)
    ts = th.init_state(seed=0)
    with torch.no_grad():
        sr = th.run_eval(ts, {"lr": xs[0]}).float()
    want = float((sr[:, 10:] - torch.from_numpy(ys[0][:, 10:])).abs().sum()
                 / sr.numel())
    _, losses = th.train_batch(ts, {"lr": xs[0], "hr": ys[0], "mask": mask})
    assert abs(float(losses["train-loss"]) - want) < 1e-6

    class Frozen(type(th)):
        def transform_grads(self, grads, state, batch):
            return {k: (torch.zeros_like(g) if k.startswith("head") else g)
                    for k, g in grads.items()}

        def transform_updates(self, updates, state, batch):
            return {k: (torch.zeros_like(u) if k.startswith("tail") else u)
                    for k, u in updates.items()}

    fh = Frozen(device="cpu", optimizer_type="sgd", lr=0.1, **RCAN_KW)
    fs = fh.init_state(seed=0)
    before = {k: v.clone() for k, v in fs.params.items()}
    fs, _ = fh.train_batch(fs, {"lr": xs[0], "hr": ys[0]})
    moved = {k: float((fs.params[k] - before[k]).abs().max()) for k in before}
    assert moved["head.weight"] == 0.0 and moved["tail.weight"] == 0.0
    assert moved["body_tail.weight"] > 0.0


def test_bf16_activations_over_f32_parameters():
    """dtype='bf16': parameters, their gradients and the optimizer state
    stay float32; the step runs and the loss is finite."""
    xs, ys = _batches(1, seed=4)
    th = torch_model("rcan")(device="cpu", dtype="bf16", **RCAN_KW)
    ts = th.init_state(seed=0)
    ts, losses = th.train_batch(ts, {"lr": xs[0], "hr": ys[0]})
    assert np.isfinite(float(losses["train-loss"]))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in th.module.parameters())
    assert all(v.dtype == torch.float32 for s in th.optimizer().state.values()
               for k, v in s.items() if torch.is_tensor(v) and k != "step")


def test_remat_gives_the_same_gradients():
    xs, ys = _batches(1, seed=5)
    grads = []
    for remat in (False, True):
        th = torch_model("rcan")(device="cpu", remat=remat, optimizer_type="sgd",
                                 lr=0.0, **RCAN_KW)
        ts = th.init_state(seed=0)
        th.train_batch(ts, {"lr": xs[0], "hr": ys[0]})
        grads.append({k: p.grad.clone() for k, p in th.module.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=1e-7)
