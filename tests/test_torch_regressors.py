"""The direct degradation regressors in the port, on the CPU, against the JAX
package (``rumpy_tpu/models/regressors.py``): each network at a tiny size
(BasicNet; ResNet basic blocks and bottlenecks, stages (1, 1, 1, 1) at
width 8, with the selective softmax; DenseNet with blocks (2, 2); an
EfficientNet of a few blocks; MANet nc (8, 16) at kernel 5 on an odd size)
in eval mode and in train mode with its BatchNorm statistics; the
handler's target normalisation, occupancy loss, centre-crop and multi-patch
evaluation, MANet's invariant-kernel loss and map evaluation; one Adam step
of a tiny ResNet with its statistics; and the regression route, which
trains a direct regressor from a metadata CSV and reads its predictions in
the contrastive evaluation (the JAX trainer fails there: ROADMAP.md section
3). Flax params and statistics come over through the weight bridge and go
back bit for bit; inputs come from a numpy seed.

Tolerances: float32 forwards within 2e-5 of flax. In train mode, where
BatchNorm normalises by a small batch's statistics, both packages run in
float64 too (flax's BatchNorm and the JAX networks' float32 output cast
made float64 by stand-ins), and agree there within 1e-9 of each output's or
statistic's largest entry; each float32 output and statistic is then held
against that float64 value: the port's error within twice JAX's own (or
one float32 ulp of the largest entry, where JAX's is below that). An
absolute bound on float32 would count the CPU conv algorithm's rounding.
Handler outputs and losses within 2e-5 (the
occupancy count exactly); the softmax and the adaptive pool within 1e-6
(the JAX pool takes its means in two passes). The Adam step is held in
float64 in both packages (flax's BatchNorm made float64 too: the JAX regressors fix it to
float32), where float32 rounding of near-zero gradients decides the sign
of an Adam first step's move: each parameter within 1e-8 of the learning
rate, each statistic within 1e-12, the loss (float32 in the JAX
regressor) within 1e-6 of its value.
"""

import functools
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rumpy_tpu.models import regressors as jreg
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import regressors as treg
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

F32_ATOL, HELPER_ATOL = 2e-5, 1e-6
F64_REL, F64_STAT = 1e-8, 1e-12
F64_TRAIN_REL, F32_ULP = 1e-9, 2.0 ** -23
ADAM_LR = 1e-3

NETS = {
    "basicnet": (lambda: jreg.BasicNet(output_size=4), lambda: treg.BasicNet(3, 4), (2, 36, 36, 3)),
    "resnet_basic": (lambda: jreg.ResNet(output_size=4, stage_sizes=(1, 1, 1, 1), width=8),
                     lambda: treg.ResNet(3, 4, (1, 1, 1, 1), width=8), (3, 64, 64, 3)),
    "resnet_bottleneck_softmax": (
        lambda: jreg.ResNet(output_size=5, stage_sizes=(1, 1, 1, 1), bottleneck=True, width=8,
                            add_softmax=True, softmax_range=(1, 4)),
        lambda: treg.ResNet(3, 5, (1, 1, 1, 1), True, width=8, add_softmax=True,
                            softmax_range=(1, 4)), (3, 62, 62, 3)),
    "densenet_softmax": (
        lambda: jreg.DenseNet(output_size=3, block_config=(2, 2), growth_rate=4, init_features=8,
                              add_softmax=True),
        lambda: treg.DenseNet(3, 3, (2, 2), 4, 8, add_softmax=True), (3, 36, 36, 3)),
    "efficientnet": (lambda: jreg.EfficientNet(output_size=3, width_mult=0.3, depth_mult=0.3),
                     lambda: treg.EfficientNet(3, 3, 0.3, 0.3), (2, 32, 32, 3)),
    "manet": (lambda: jreg.MANet(kernel_size=5, nc=(8, 16), scale=2),
              lambda: treg.MANet(3, 5, (8, 16), scale=2), (2, 13, 11, 3)),
}


def _np(tree):
    """Copies: the JAX train step donates its state's buffers."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _out(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close_trees(got, want, atol):
    lg, lw = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw) and lg
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("net", list(NETS))
def test_network_matches_flax(net, monkeypatch):
    """Eval mode on running statistics moved off their init, then train
    mode: outputs and the updated statistics, held in float64 in both
    packages, and in float32 against that float64 reference, where the
    port's error stays within twice JAX's own. The bridge gives the flax
    params and statistics back bit for bit."""
    make_j, make_t, shape = NETS[net]
    jm, tm = make_j(), make_t()
    x = _rand(shape, 1)
    variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    rng = np.random.default_rng(2)
    stats = variables.get("batch_stats")
    if stats:
        stats = jax.tree_util.tree_map(
            lambda a: a + 0.2 * rng.random(a.shape).astype(np.float32), stats)
        variables["batch_stats"] = stats
    tm.load_state_dict(state_dict_from_jax(variables["params"], tm, batch_stats=stats or None))
    assert not [a for a, b in zip(
        jax.tree_util.tree_leaves(jax_tree_from_state_dict(tm.state_dict(), tm)),
        jax.tree_util.tree_leaves(variables["params"])) if not np.array_equal(a, b)]
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    got = _out(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    if not stats:
        return
    # JAX's float32 reference is its eager call, unfused as the port's ops
    # are (a jitted call fuses and errs less)
    want32, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    jax32 = [np.asarray(want32)] + jax.tree_util.tree_leaves(_np(mut["batch_stats"]))
    port32 = [_out(tm(_nchw(x), train=True))] + jax.tree_util.tree_leaves(
        jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats"))
    jax64, port64 = _train_mode_in_float64(make_j, make_t, variables, x, monkeypatch)
    assert len(jax64) == len(port64) == len(jax32) == len(port32) > 1
    for p64, j64, p32, j32 in zip(port64, jax64, port32, jax32):
        top = np.abs(j64).max()
        assert np.abs(p64 - j64).max() <= F64_TRAIN_REL * top
        port_err, jax_err = np.abs(p32 - j64).max(), np.abs(j32 - j64).max()
        assert port_err <= max(2 * jax_err, F32_ULP * top), (port_err, jax_err, top)


def _train_apply(jm):
    """The flax network's train-mode call, jitted: (outputs, updated
    variables)."""
    return jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))


def _train_mode_in_float64(make_j, make_t, variables, x, monkeypatch):
    """One train-mode call of each package's network in float64 (flax's
    BatchNorm and the JAX networks' float32 output cast made float64 by
    stand-ins) from ``variables``: [outputs, *statistics leaves] each."""
    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with monkeypatch.context() as mp:
        mp.setattr(jreg, "nn", _float64_flax())
        mp.setattr(jreg, "jnp", _float64_jnp())
        with jax.enable_x64(True):
            jm = make_j().clone(dtype=jnp.float64)
            out, mut = _train_apply(jm)(f64(variables), jnp.asarray(x, jnp.float64))
            jax64 = [np.asarray(out)] + jax.tree_util.tree_leaves(_np(mut["batch_stats"]))
    tm = make_t()
    tm.load_state_dict(state_dict_from_jax(variables["params"], tm,
                                           batch_stats=variables["batch_stats"]))
    tm.double()
    for m in tm.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        out = tm(_nchw(x.astype(np.float64)), train=True)
        port64 = [_out(out)] + jax.tree_util.tree_leaves(
            jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats"))
    return jax64, port64


def test_helpers_match_jax():
    x = np.random.default_rng(3).standard_normal((3, 9)).astype(np.float32)
    np.testing.assert_allclose(treg.selective_softmax(torch.from_numpy(x), (2, 7)).numpy(),
                               np.asarray(jreg.selective_softmax(jnp.asarray(x), (2, 7))),
                               atol=HELPER_ATOL, rtol=0)
    gt = np.where(x > 0.3, x, 0.0).astype(np.float32)
    assert float(treg.indicator_occupancy_loss(torch.from_numpy(x), torch.from_numpy(gt), 0.1)) \
        == float(jreg.indicator_occupancy_loss(jnp.asarray(x), jnp.asarray(gt), 0.1))
    m = _rand((2, 5, 13, 11), 4)  # bins of unequal sizes on both axes
    np.testing.assert_allclose(
        treg.adaptive_avg_pool(torch.from_numpy(m), 5).numpy(),
        np.asarray(jreg.adaptive_avg_pool(jnp.asarray(m.transpose(0, 2, 3, 1)), 5)).transpose(
            0, 3, 1, 2), atol=HELPER_ATOL, rtol=0)


def _pair(name, **kw):
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    th = torch_model(name)(device="cpu", **kw)
    stats = _np(js.extra["bstats"]) or None
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module, batch_stats=stats))
    return jh, js, th


HANDLER_CASES = {
    "zero_mean_occupancy": ("basicnn", dict(output_size=4, normalization_scheme="zero_mean",
                                            normalization_params={"mean": 0.2, "std": 0.5},
                                            occupancy_loss=True, occ_weight=0.5),
                            (2, 40, 40, 3)),
    "zero_to_one_centre_crop": ("basicnn", dict(output_size=4, crop_size=24,
                                                normalization_scheme="zero_to_one",
                                                normalization_params={"minim": -1.0,
                                                                      "maxim": 3.0}),
                                (2, 40, 44, 3)),
    "multi_patch": ("resnet", dict(output_size=4, width=8, input_patch_num=2, crop_size=16,
                                   centercrop_patch_eval=False), (1, 40, 36, 3)),
}


@pytest.mark.parametrize("case", list(HANDLER_CASES))
def test_handler_eval_and_losses_match_jax(case):
    """run_eval (the crop or the patches, the network, the un-normalised
    output), run_embedding, and the losses of a train step's forward."""
    name, kw, shape = HANDLER_CASES[case]
    jh, js, th = _pair(name, **kw)
    x = _rand(shape, 5)
    state = th._own_state()
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = th.run_eval(state, {"lr": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(th.run_embedding(state, x).numpy(), want, atol=F32_ATOL, rtol=0)
    meta = np.random.default_rng(6).standard_normal((shape[0], 4)).astype(np.float32)
    meta[:, 0] = 0.0  # at the occupancy threshold's side of zero
    crop = x[:, :32, :32]
    if th.input_patch_num > 1:
        crop = np.concatenate([crop, crop[:, ::-1]], axis=-1)
    jpred, _, _ = jh.apply(js.params, {"lr": jnp.asarray(crop)}, train=False,
                           extra=js.extra)
    want = jh.compute_losses(jpred, {"metadata": jnp.asarray(meta)}, {})
    tpred, _, _ = th.apply(state.params, {"lr": torch.from_numpy(crop)}, train=False)
    got = th.compute_losses(tpred, {"metadata": torch.from_numpy(meta)}, {})
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= F32_ATOL * max(1.0, abs(float(want[k]))), k
    if "occ-loss" in want:
        assert float(got["occ-loss"]) == float(want["occ-loss"]) > 0
        assert th.occ_thres == jh.occ_thres


def test_manet_handler_matches_jax():
    """The invariant kernel's (N, k^2) target spread over the HR map, and
    the map returned as it is by run_eval (no crop, no un-normalisation)."""
    kw = dict(kernel_size=5, sr_scale=2, nc=(8, 16), nb=1, invariant_kernel=True)
    jh, js, th = _pair("manet", **kw)
    x = _rand((2, 11, 13, 3), 7)
    target = _rand((2, 25), 8)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    got = th.run_eval(th._own_state(), {"lr": torch.from_numpy(x)})
    assert tuple(got.shape) == want.shape == (2, 22, 26, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    jl = jh.compute_losses(jnp.asarray(want), {"metadata": jnp.asarray(target)}, {})
    tl = th.compute_losses(got, {"metadata": torch.from_numpy(target)}, {})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= F32_ATOL


def test_refusals_match_jax():
    for make in (jax_model, lambda n: (lambda **kw: torch_model(n)(device="cpu", **kw))):
        with pytest.raises(RuntimeError, match="Normalization parameters"):
            make("basicnn")(normalization_scheme="zero_mean")
        with pytest.raises(RuntimeError, match="Model Undefined"):
            make("resnet")(model_type="resnet34")


def _float64_flax():
    """flax.linen with BatchNorm made float64 (the JAX regressors fix its
    dtype to float32)."""
    def batch_norm(**kw):
        return fnn.BatchNorm(**dict(kw, dtype=jnp.float64, param_dtype=jnp.float64))

    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("_")}
    return types.SimpleNamespace(**dict(names, BatchNorm=batch_norm))


def _float64_jnp():
    """jax.numpy with float32 standing for float64 (the JAX regressors cast
    their outputs to float32)."""
    return types.SimpleNamespace(**dict({k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("_")}, float32=jnp.float64))


def test_resnet_adam_step_matches_jax_in_float64(monkeypatch):
    """One Adam step of a tiny ResNet-18 with its BatchNorm statistics, both
    packages in float64: every parameter and every running statistic."""
    kw = dict(output_size=4, width=8, lr=ADAM_LR)
    _, js, _ = _pair("resnet", **kw)
    params, stats = _np(js.params), _np(js.extra["bstats"])
    rng = np.random.default_rng(9)
    batch = {"lr": rng.random((3, 48, 48, 3)), "metadata": rng.random((3, 4))}

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

    monkeypatch.setattr(jreg, "nn", _float64_flax())
    with jax.enable_x64(True):
        jh = jax_model("resnet")(**kw)
        jh.module = jh.module.clone(dtype=jnp.float64)
        jh._rejit()
        state = js.replace(params=f64(params), opt_state=jh.tx.init(f64(params)),
                           extra={"bstats": f64(stats)})
        js2, jl = jh.train_batch(state, f64(batch))
        want, want_stats = _np(js2.params), _np(js2.extra["bstats"])
    th = torch_model("resnet")(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(params, th.module, batch_stats=stats))
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    th.module.double()
    for m in th.module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    state2, tl = th.train_batch(th._own_state(), {k: torch.from_numpy(v) for k, v in batch.items()})
    # the JAX regressor casts its output and target to float32, so its loss
    # is a float32 value; the gradients below are float64 in both
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6 * float(jl["train-loss"])
    _close_trees(jax_tree_from_state_dict(state2.params, th.module), want, F64_REL * ADAM_LR)
    _close_trees(jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats"),
                 want_stats, F64_STAT)
    moved = [np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(want),
                                                 jax.tree_util.tree_leaves(params))]
    assert min(moved) > 0.5 * ADAM_LR


# -- the regression route -----------------------------------------------------------

META_COLUMNS = ["0-realesrganblur-sigma_x", "0-realesrganblur-sigma_y",
                "2-realesrgannoise-gaussian_noise_scale", "3-randomcompress-jpeg_quality"]


@pytest.fixture(scope="module")
def metadata_set(tmp_path_factory):
    """Eight LR PNGs and a metadata CSV in the offline pipeline's layout."""
    root = tmp_path_factory.mktemp("regressor_set")
    rng = np.random.default_rng(10)
    rows = []
    for i in range(8):
        Image.fromarray((rng.random((24, 24, 3)) * 255).astype(np.uint8)).save(
            root / f"im{i}.png")
        rows.append([f"im{i}.png", 0.2 + 3 * rng.random(), 0.2 + 3 * rng.random(),
                     30 * rng.random(), float(rng.integers(30, 95))])
    with open(root / "degradation_metadata.csv", "w") as fh:
        fh.write(",".join(["image"] + META_COLUMNS) + "\n")
        fh.writelines(",".join(str(v) for v in r) + "\n" for r in rows)
    return str(root)


def _route_config(save_loc, lr_dir):
    csv_path = os.path.join(lr_dir, "degradation_metadata.csv")
    return {"experiment": "resnet_regression", "experiment_save_loc": str(save_loc),
            "data": {"task_type": "regression", "scale": 2, "crop": 16, "dataloader_threads": 1,
                     "training_sets": {"data_1": {"lr_dir": lr_dir, "metadata_file": csv_path}},
                     "eval_sets": {"data_1": {"lr_dir": lr_dir, "crop": 16,
                                              "metadata_file": csv_path}}},
            "model": {"name": "resnet", "internal_params": {
                "output_size": len(META_COLUMNS), "width": 8, "crop_size": 16}},
            "training": {"num_epochs": 1, "batch_size": 4, "seed": 0}}


def test_regression_route_trains_a_direct_regressor(tmp_path, metadata_set):
    """The port's route hands the step one crop an item and its metadata
    row, and its contrastive evaluation reads the regressor's predictions;
    the JAX trainer gives the regressor two crops an item, assembles a
    contrastive batch without "lr", and fails at the first step."""
    from rumpy_tpu.config.loader import to_none_dict
    from rumpy_tpu.training.regression_trainer import RegressionTrainingHandler as JaxRoute
    from rumpy_tpu_torch.training.regression_trainer import RegressionTrainingHandler

    jax_route = JaxRoute(to_none_dict(_route_config(tmp_path / "jax", metadata_set)),
                         verbose=False)
    with pytest.raises(KeyError, match="lr"):
        jax_route.run_experiment()

    route = RegressionTrainingHandler(_route_config(tmp_path / "port", metadata_set),
                                      verbose=False, device="cpu")
    batch = next(iter(route.train_data))
    assert np.shape(batch["lr"]) == (4, 16, 16, 3)
    assert np.shape(batch["metadata"]) == (4, len(META_COLUMNS))
    handler = route.model.model
    stats0 = {k: v.clone() for k, v in handler.module.state_dict().items() if "running" in k}
    seen = []
    embed = handler.run_embedding
    handler.run_embedding = lambda state, images: seen.append((images, embed(state, images))) \
        or seen[-1][1]
    stats = route.run_experiment()
    assert np.isfinite(stats[0]["train-loss"])
    moved = [k for k, v in handler.module.state_dict().items()
             if k in stats0 and not torch.equal(v, stats0[k])]
    assert len(moved) == len(stats0) > 0
    dump = np.load(tmp_path / "port" / "resnet_regression" / "result_outputs"
                   / "encodings_epoch_0.npz")
    assert dump["embeddings"].shape == (8, len(META_COLUMNS))
    np.testing.assert_array_equal(dump["embeddings"], torch.cat([e for _, e in seen]).numpy())
    images, embeddings = seen[0]
    np.testing.assert_array_equal(  # the predictions, un-normalised
        embeddings.numpy(), handler.run_eval(route.model.state, {"lr": images}).numpy())
