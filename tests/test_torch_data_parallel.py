"""The port's data parallelism (``rumpy_tpu_torch/parallel/mesh.py`` and its
readers) on the CPU: gloo groups of 2 and 4 rank processes against the JAX
package's 8-device CPU mesh (``tests/conftest.py``) and against the port in
one process on the global batch.

A step over W ranks with B / W rows each must compute what one device
computes on the global batch B, as ``tests/test_sharding.py`` holds the JAX
mesh to: EDSR, DAN v1 and ESRGAN's G + D step against ``shard_batch`` steps
of the JAX handlers from the same weights (the port's seeded init carried
over by the weight bridge); the BoBW joint step, MoCo and SupMoCo (their
queues, pointers and label queue advance by the global batch) against the
port's one-process step; FaceGAN's step (its real half drawn from the
global batch's permutation) from the JAX step's draws against the JAX mesh
and, in float64, against one process, and from its own draws against one
process; flax-style BatchNorm's statistics, output and
input gradient over the group against the global batch's in float64; the
degradation chain's rows against the one-process chain, single- and
multi-view; a checkpoint written by rank 0 and resumed by every rank; and
``cli.train_sisr`` run by every rank of the group against one process.

Each world is spawned once for the file (a module fixture runs every case
and returns the results); the tests then assert case by case. Tolerances:
losses within 1e-5 of JAX's (1e-4 for ESRGAN's four, as in
``test_sharding.py``), parameters after an Adam step within 1e-5 absolute
of JAX's; the port across ranks against the port in one process within
1e-5 absolute (float32 sums in another order); FaceGAN's losses within
1e-5 of JAX's and each move within 1e-4 of its leaf's largest move (as
``tests/test_torch_face_models.py`` holds the one-process step), its
ranks within 1e-9 of one process in float64; BatchNorm in float64
within 1e-9; the chain's draws and metadata bit for bit, its images within
1e-6 (its float32 convolutions on fewer rows).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from test_torch_face_models import _assert_moves, _dropout_keep
from rumpy_tpu.models.base import TrainState
from rumpy_tpu.models.base import build_optimizer as jax_optimizer
from rumpy_tpu.parallel import mesh as jmesh
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.checkpoint import checkpoint_path
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

WORLDS = (2, 4)
F32_ATOL = 1e-5
F64_ATOL = 1e-9

EDSR = dict(scale=2, num_features=8, num_blocks=1, lr=1e-3)
DAN = dict(mode="v1", scale=2, nf=8, nb=1, loop=2, input_para=4, kernel_size=9, lr=1e-3,
           init_ker_map=(0.1, 0.2, 0.3, 0.4))
ESRGAN = dict(scale=4, nf=8, nb=1, gc=8, d_nf=8, pretrain_epochs=0, lr=1e-4)
# the handlers held against the port in one process step in float64 under
# SGD at lr 1: a parameter moves by its gradient (Adam's first step would let
# rounding decide the moves of the conv biases before BatchNorm, whose
# gradient is 0), and the DASR encoder's BatchNorm over 4 x 4 values a
# channel amplifies float32 rounding to 1e-4 of a move
SGD = dict(optimizer_type="sgd", lr=1.0)
BOBW = dict(scale=2, combined_loss_mode="moco", crop_count=2, contrastive_K=16,
            encoder_dim=32, block_encoder_loading=True, n_feats=8, n_resgroups=1,
            n_resblocks=1, **SGD)
MOCO = dict(K=16, dim=32, **SGD)
SUPMOCO = dict(K=16, dim=32, dropdown=8, positives_per_class=2, **SGD)
FACEGAN = dict(latent_dim=8, nf=8, **SGD)
FACEGAN_D_LR = 1e-2  # a discriminator moved at lr 1 calls every fake
CHAIN = {"pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                      ["realesrgannoise", "n"], ["jpegcompress", "j"]],
         "deg_configs": {"b": {"kernel_range": ["iso", "aniso", "generalized_iso",
                                                "plateau_aniso", "sinc"],
                               "kernel_size": 9, "request_kernel_metadata": True},
                         "d": {"scale": 2},
                         "n": {"gaussian_poisson_ratio": 0.5,
                               "gaussian_noise_sigma_range": [1, 30],
                               "poisson_noise_scale_range": [0.05, 3]},
                         "j": {"random_compression": True, "compression_range": [20, 80]}},
         "scale": 2}


def _port_init(name, kw, epoch=None):
    """The port handler's seeded weights (the state dict every rank loads)."""
    h = torch_model(name)(device="cpu", **kw)
    if epoch is not None:
        h.set_epoch(epoch)
    h.init_state(seed=0)
    return h, {k: v.detach().clone() for k, v in h.module.state_dict().items()}


def _batch(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.random(s).astype(np.float32) for k, s in shapes.items()}


def _jax_step(name, kw, module, sd, batch, epoch=None):
    """The JAX handler's step on the 8-device mesh (replicated state, batch
    sharded over ``data``) from the port's weights. Returns the losses and
    the params after it as numpy trees."""
    jh = jax_model(name)(**kw)
    if epoch is not None:
        jh.set_epoch(epoch)
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(sd, module))
    extra = {}
    if name == "esrgan":
        jh.discriminator = jh.build_discriminator()
        opt = {"generator": jh.main_tx.init(params["generator"]),
               "discriminator": jh.d_tx.init(params["discriminator"])}
        stats = jax_tree_from_state_dict(sd, module, "batch_stats")["discriminator"]
        extra = {"d_vars": {"batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}}
    else:
        opt = jh.tx.init(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt,
                       extra=extra, rng=jax.random.PRNGKey(0))
    mesh = jmesh.get_mesh(n_data=8)
    state, losses = jh.train_batch(jmesh.replicate(mesh, state), jmesh.shard_batch(mesh, batch))
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, state.params))


def _facegan(specs, jax_cases):
    """FaceGAN's specs from the JAX handler's seeded init: a step with the
    JAX step's draws (float32, and float64 for one process), one from the
    handler's own draws, and a half batch of 2 that 4 ranks do not divide;
    the JAX mesh step runs in the test process."""
    jh = jax_model("facegan")(**FACEGAN)
    jh.d_tx = jax_optimizer(FACEGAN_D_LR, "sgd")
    js = jh.init_state()
    th = torch_model("facegan")(device="cpu", **FACEGAN)
    th.module.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params), th.module,
        batch_stats={"discriminator": jax.tree_util.tree_map(np.asarray,
                                                             js.extra["d_bstats"])}))
    sd = {k: v.detach().clone() for k, v in th.module.state_dict().items()}
    n, half = 8, 4
    hr = _batch(13, hr=(n, 80, 80, 3))
    _, zk_d, zk_g, perm_k, drop1, drop2 = jax.random.split(js.rng, 6)
    d_vars = {"params": js.params["discriminator"], "batch_stats": js.extra["d_bstats"]}
    draws = {"perm": np.asarray(jax.random.permutation(perm_k, n)),
             "z_d": np.asarray(jax.random.uniform(zk_d, (half, 8))),
             "z_g": np.asarray(jax.random.uniform(zk_g, (n, 8))),
             "keep_real": _dropout_keep(jh.discriminator, d_vars, drop1, (half, 80, 80, 3)),
             "keep_fake": _dropout_keep(jh.discriminator, d_vars, drop2, (half, 80, 80, 3))}
    base = dict(case="facegan", model="facegan", kwargs=FACEGAN, state_dict=sd,
                d_lr=FACEGAN_D_LR, batch=hr)
    specs["facegan"] = dict(base, draws=draws)
    specs["facegan64"] = dict(base, draws=draws, float64=True)
    specs["facegan_own"] = dict(base, kwargs=dict(FACEGAN, lr=1e-2), float64=True)
    specs["facegan_split"] = dict(base, batch={"hr": hr["hr"][:4]})
    jax_cases["facegan"] = (jh, js, hr, th.module)


def _jax_facegan(jh, js, hr, module):
    """The JAX FaceGAN step on the 8-device mesh: losses and params."""
    mesh = jmesh.get_mesh(n_data=8)
    state, losses = jh.train_batch(jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.copy, js)),
                                   jmesh.shard_batch(mesh, hr))
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, state.params), js.params)


def _specs(tmp):
    """Every case's spec (the same for each world) and the JAX side's inputs."""
    specs, jax_cases = {}, {}
    for name, kw, shapes, epoch in (
            ("edsr", EDSR, dict(lr=(8, 8, 8, 3), hr=(8, 16, 16, 3)), None),
            ("dan", DAN, dict(lr=(8, 8, 8, 3), hr=(8, 16, 16, 3), metadata=(8, 4)), None),
            ("esrgan", ESRGAN, dict(lr=(8, 32, 32, 3), hr=(8, 128, 128, 3)), 0)):
        h, sd = _port_init(name, kw, epoch)
        batch = _batch(len(name), **shapes)
        specs[name] = dict(case="steps", model=name, kwargs=kw, epoch=epoch, state_dict=sd,
                           batch=batch)
        jax_cases[name] = (name, kw, h.module, sd, batch, epoch)
    specs["bobw"] = dict(case="steps", model="contrastiveblindqrcan", kwargs=BOBW,
                         float64=True,
                         state_dict=_port_init("contrastiveblindqrcan", BOBW)[1],
                         batch=_batch(5, lr=(8, 2, 8, 8, 3), hr=(8, 16, 16, 3)))
    specs["moco"] = dict(case="steps", model="moco", kwargs=MOCO, steps=2, float64=True,
                         batch=_batch(6, image_query=(8, 16, 16, 3), image_key=(8, 16, 16, 3)))
    sup = _batch(7, image_query=(8, 16, 16, 3), image_key=(16, 16, 16, 3))
    sup["labels"] = np.asarray([0, 1, 2, 1, 0, 2, 2, 1], np.int64)
    specs["supmoco"] = dict(case="steps", model="supmoco", kwargs=SUPMOCO, steps=2, float64=True,
                            setup=[("register_classes", (3,))], batch=sup)
    rng = np.random.default_rng(8)
    specs["batchnorm"] = dict(case="batchnorm", x=rng.standard_normal((8, 5, 3, 2)) * 3 + 1,
                              g=rng.standard_normal((8, 5, 3, 2)))
    hr = rng.random((8, 16, 16, 3)).astype(np.float32)
    specs["chain"] = dict(case="chain", hr=hr, views=1, seed=11, **CHAIN)
    specs["chain_views"] = dict(case="chain", hr=hr, views=2, seed=12, **CHAIN)
    specs["mesh_errors"] = dict(case="mesh_errors")
    _facegan(specs, jax_cases)
    return specs, jax_cases


def _trainer_spec(root, tag):
    """``cli.train_sisr`` on 8 LR/HR pairs, one epoch of 2 steps at batch 4
    (the loader on one thread: the same crops in every process)."""
    from rumpy_tpu_torch.config.loader import dump_toml
    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        rng = np.random.default_rng(9)
        for sub, side in (("lr", 12), ("hr", 24)):
            os.makedirs(os.path.join(data, sub))
        for i in range(8):
            hr = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
            np.save(os.path.join(data, "hr", f"im{i}.npy"), hr)
            np.save(os.path.join(data, "lr", f"im{i}.npy"), hr[::2, ::2])
    exp_root = os.path.join(root, tag)
    cfg = {"experiment": "edsr_dp", "experiment_save_loc": exp_root,
           "data": {"scale": 2, "crop": 8, "dataloader_threads": 1,
                    "training_sets": {"data_1": {"lr_dir": os.path.join(data, "lr"),
                                                 "hr_dir": os.path.join(data, "hr")}}},
           "model": {"name": "edsr", "internal_params": dict(EDSR, seed=3)},
           "training": {"num_epochs": 1, "batch_size": 4, "seed": 3}}
    path = os.path.join(root, f"{tag}.toml")
    dump_toml(cfg, path)
    return dict(case="trainer", config=path, experiment_dir=os.path.join(exp_root, "edsr_dp"))


def _regression_spec(root, tag):
    """``cli.train_sisr`` routed to the regression trainer: SupMoCo on 8
    HR-only images, each batch's views degraded on the device in one pass
    (blur, x2 down, noise) and colour-distorted, batch 4, one epoch."""
    from rumpy_tpu_torch.config.loader import dump_toml
    hr_dir = os.path.join(root, "hr_only")
    if not os.path.isdir(hr_dir):
        os.makedirs(hr_dir)
        rng = np.random.default_rng(10)
        for i in range(8):
            np.save(os.path.join(hr_dir, f"im{i}.npy"),
                    rng.integers(0, 256, (48, 48, 3), dtype=np.uint8))
    exp_root = os.path.join(root, tag)
    cfg = {"experiment": "supmoco_dp", "experiment_save_loc": exp_root,
           "data": {"task_type": "regression", "scale": 2, "crop": 16, "dataloader_threads": 1,
                    "colour_distort": True,
                    "online_degradations": {
                        "pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                                     ["realesrgannoise", "n"]],
                        "deg_configs": {"b": {"kernel_range": ["iso", "aniso"],
                                              "kernel_size": 9},
                                        "d": {"scale": 2},
                                        "n": {"gaussian_noise_sigma_range": [1, 30]}}},
                    "training_sets": {"data_1": {"hr_dir": hr_dir}}},
           "model": {"name": "supmoco", "internal_params":
                     {"K": 16, "positives_per_class": 2, "dim": 64, "seed": 4}},
           "training": {"num_epochs": 1, "batch_size": 4, "seed": 4}}
    path = os.path.join(root, f"{tag}_regression.toml")
    dump_toml(cfg, path)
    return dict(case="trainer", config=path, experiment_dir=os.path.join(exp_root, "supmoco_dp"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The results of the 2- and 4-rank worlds (a list of each rank's) and
    of the same cases in one process, and the JAX mesh's steps. One spawn
    of 4 ranks runs the 4-rank world, the 2-rank one (the ranks cut into two
    groups) and the one-process cases (on rank 0), while this process runs
    the JAX steps."""
    tmp = str(tmp_path_factory.mktemp("data_parallel"))
    specs, jax_cases = _specs(tmp)
    by_size = {}
    for w in (1,) + WORLDS:
        by_size[w] = dict(specs)
        by_size[w]["checkpoint"] = dict(case="checkpoint", model="edsr", kwargs=EDSR,
                                        batch=specs["edsr"]["batch"], first_group=True,
                                        dir=os.path.join(tmp, f"ckpt{w}"))
    by_size[2]["trainer"] = dict(_trainer_spec(tmp, "world2"), first_group=True)
    by_size[2]["regression"] = dict(_regression_spec(tmp, "world2"), first_group=True)
    by_size[1]["trainer"] = _trainer_spec(tmp, "alone")
    by_size[1]["regression"] = _regression_spec(tmp, "alone")
    by_size[1].pop("mesh_errors")
    by_size[1] = {k: dict(v, first_group=True) for k, v in by_size[1].items()}
    out = os.path.join(tmp, "ranks")
    ctx = worker.start_world(max(WORLDS), by_size, out)
    jax_runs = {name: (_jax_facegan if name == "facegan" else _jax_step)(*args)
                for name, args in jax_cases.items()}
    ranks = worker.results(ctx, (1,) + WORLDS, out)
    return {"worlds": {w: ranks[w] for w in WORLDS}, "alone": ranks[1][0], "jax": jax_runs,
            "modules": {name: args[-1] if name == "facegan" else args[2]
                        for name, args in jax_cases.items()},
            "trainer_dirs": {"world2": os.path.join(tmp, "world2", "edsr_dp")}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_state(got, want, atol=F32_ATOL, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["edsr", "dan", "esrgan"])
def test_step_matches_the_jax_mesh_step(runs, world, name):
    """Every rank's losses and parameters after one step against the JAX
    handler's step on the 8-device mesh, from the same weights and global
    batch."""
    j_losses, j_params = runs["jax"][name]
    module = runs["modules"][name]
    tol = 1e-4 if name == "esrgan" else F32_ATOL
    for rank in runs["worlds"][world]:
        got = rank[name]
        for k in (("train-loss", "gan-loss", "d-loss-real", "d-loss-fake") if name == "esrgan"
                  else [k for k in j_losses if k in got["losses"][0]]):
            assert abs(got["losses"][0][k] - j_losses[k]) <= tol, (k, got["losses"][0][k],
                                                                  j_losses[k])
        tree = jax_tree_from_state_dict({k: torch.from_numpy(v)
                                         for k, v in got["state"].items()}, module)
        _assert_state(_flat(tree), _flat(j_params))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["edsr", "dan", "esrgan", "bobw", "moco", "supmoco"])
def test_ranks_hold_the_one_process_state(runs, world, name):
    """Every rank ends with the same state as the port's one process on the
    global batch: parameters, BatchNorm statistics, the queues and their
    pointer; and reports the same losses."""
    want = runs["alone"][name]
    tol = F64_ATOL if name in ("bobw", "moco", "supmoco") else F32_ATOL
    for rank in runs["worlds"][world]:
        got = rank[name]
        _assert_state(got["state"], want["state"], atol=tol)
        for step, (g, w) in enumerate(zip(got["losses"], want["losses"])):
            for k in w:
                assert abs(g[k] - w[k]) <= tol, (step, k, g[k], w[k])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,steps", [("bobw", 1), ("moco", 2), ("supmoco", 2)])
def test_queues_advance_by_the_global_batch(runs, world, name, steps):
    """The queue pointer moves by the global batch each step (8, not 8 / W);
    the newest rows are the one-process keys in global batch order, the
    label queue its labels, on every rank alike."""
    want = runs["alone"][name]["state"]
    ranks = runs["worlds"][world]
    for rank in ranks:
        st = rank[name]["state"]
        assert int(st["queue_ptr"]) == (8 * steps) % 16 == int(want["queue_ptr"])
        assert np.all(np.isfinite([v for lo in rank[name]["losses"] for v in lo.values()]))
        np.testing.assert_allclose(st["queue"], want["queue"], rtol=0, atol=F64_ATOL)
        np.testing.assert_array_equal(st["queue"], ranks[0][name]["state"]["queue"])
        if name == "supmoco":
            np.testing.assert_array_equal(st["queue_labels"], want["queue_labels"])


@pytest.mark.parametrize("world", WORLDS)
def test_batchnorm_statistics_over_the_group(runs, world):
    """Train-mode BatchNorm over the group in float64: each rank's output
    rows, input gradient rows and every rank's running statistics are the
    global batch's within 1e-9."""
    want = runs["alone"]["batchnorm"]
    n = 8 // world
    for r, rank in enumerate(runs["worlds"][world]):
        got = rank["batchnorm"]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], want[k][r * n:(r + 1) * n], rtol=0, atol=1e-9)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["chain", "chain_views"])
def test_chain_rows_match_the_one_process_chain(runs, world, name):
    """The chain over the group (blur of five families, x2 down, Gaussian or
    Poisson noise, JPEG at a drawn quality): each rank's metadata rows are
    the one-process chain's bit for bit, its images within 1e-6; the
    multi-view mode splits by image, never inside an image's views."""
    want = runs["alone"][name]
    views = 2 if name == "chain_views" else 1
    n = 8 // world
    for r, rank in enumerate(runs["worlds"][world]):
        got = rank[name]
        rows = slice(r * n // views, (r + 1) * n // views)
        assert set(got["meta"]) == set(want["meta"])
        for k, v in want["meta"].items():
            np.testing.assert_array_equal(got["meta"][k], v[rows], err_msg=k)
        np.testing.assert_allclose(got["lr"], want["lr"][r * n:(r + 1) * n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_round_trip_under_the_group(runs, world):
    """Rank 0 alone writes the checkpoint; every rank reloads it and its
    resumed step lands where the uninterrupted one does, as in one process."""
    alone = runs["alone"]["checkpoint"]
    for rank in runs["worlds"][world]:
        got = rank["checkpoint"]
        assert got["files"] == [os.path.basename(checkpoint_path("", 3))]
        assert got["epoch"] == 3
        assert abs(got["loss_cont"] - got["loss_res"]) < 1e-6
        _assert_state(got["res"], got["cont"], atol=1e-6)
        _assert_state(got["cont"], alone["cont"])


def test_train_sisr_under_the_group(runs):
    """``cli.train_sisr`` run by both ranks of a group (the trainer joins it
    through ``use_mesh``): the same epoch losses and checkpoint as one
    process on the same data; only rank 0's files."""
    alone = runs["alone"]["trainer"]
    ranks = runs["worlds"][2]
    for rank in ranks:
        got = rank["trainer"]
        for k, v in alone["stats"][0].items():
            if k != "compute_efficiency":
                assert abs(got["stats"][0][k] - v) <= F32_ATOL, k
        _assert_state(got["network"], alone["network"])
    exp = runs["trainer_dirs"]["world2"]
    with open(os.path.join(exp, "result_outputs", "summary.csv")) as f:
        assert len(f.read().strip().splitlines()) == 2  # the header and epoch 0, once
    assert os.listdir(os.path.join(exp, "saved_models")) == [
        os.path.basename(checkpoint_path("", 0))]


def test_regression_trainer_under_the_group(runs):
    """The regression trainer (SupMoCo on views degraded and
    colour-distorted on the device) over 2 ranks: the queue's labels, from
    the chain's metadata of the global batch, bit for bit those of one
    process, the pointer past the global batches; the queue, the encoder
    and the epoch's loss as one process's within float32's reach through
    BatchNorm over 2 x 4 x 4 values a channel (Adam at lr 1e-3 moves a
    parameter by at most lr: within 2 lr)."""
    alone = runs["alone"]["regression"]
    for rank in runs["worlds"][2]:
        got = rank["regression"]
        net, want = got["network"], alone["network"]
        np.testing.assert_array_equal(net["queue_labels"], want["queue_labels"])
        assert int(net["queue_ptr"]) == int(want["queue_ptr"]) == 8
        _assert_state(net, want, atol=2e-3 + 1e-6,
                      keys=[k for k in want if k not in ("queue_labels", "queue_ptr")])
        assert abs(got["stats"][0]["train-loss"] - alone["stats"][0]["train-loss"]) <= 1e-3


def test_mesh_refuses_a_partial_data_axis(runs):
    """``get_mesh(n_data=...)`` other than the group's size raises, and
    ``local_batch_size`` keeps the JAX package's error."""
    for w in WORLDS:
        for rank in runs["worlds"][w]:
            assert "data axis must hold every rank" in rank["mesh_errors"]["error"]
    mesh = mesh_mod.Mesh(0, 8, torch.device("cpu"))
    assert mesh_mod.local_batch_size(mesh, 32) == 4
    with pytest.raises(ValueError, match="not divisible by data-parallel size 8"):
        mesh_mod.local_batch_size(mesh, 12)


@pytest.mark.parametrize("world", WORLDS)
def test_facegan_step_matches_the_jax_mesh_step(runs, world):
    """FaceGAN's step from the JAX step's draws on every rank: the losses
    and accuracies against the JAX handler's step on the 8-device mesh from
    the same weights and global batch, and every move of both networks."""
    j_losses, j_params, j_before = runs["jax"]["facegan"]
    module = runs["modules"]["facegan"]
    before = jax.tree_util.tree_map(np.asarray, j_before)
    for rank in runs["worlds"][world]:
        got = rank["facegan"]
        for k in ("train-loss", "d-loss-real", "d-loss-fake"):
            assert abs(got["losses"][k] - j_losses[k]) <= F32_ATOL, (k, got["losses"][k],
                                                                    j_losses[k])
        for k in ("d-acc-real", "d-acc-fake"):
            assert got["losses"][k] == j_losses[k], k
        after = jax_tree_from_state_dict({k: torch.from_numpy(v)
                                          for k, v in got["state"].items()}, module)
        for part in ("discriminator", "generator"):
            _assert_moves(after[part], before[part], j_params[part],
                          # the strided convs' biases feed a train-mode BatchNorm
                          zero_in_exact=lambda p: part == "discriminator" and "bias" in p
                          and "TConv_0" not in p)


@pytest.mark.parametrize("world", WORLDS)
def test_facegan_ranks_hold_the_one_process_step(runs, world):
    """Every rank's FaceGAN state, BatchNorm statistics included, and losses
    as one process's on the global batch, in float64 within 1e-9: from the
    given draws, and from the handler's own draws (the global batch's, the
    same generator on every rank). In float32 its first-step gradients
    (hundreds for the first conv's bias) carry rounding of the BatchNorm
    sums' order to 1e-5 of a move."""
    for name, tol in (("facegan64", F64_ATOL), ("facegan_own", F64_ATOL)):
        want = runs["alone"][name]
        for rank in runs["worlds"][world]:
            got = rank[name]
            _assert_state(got["state"], want["state"], atol=tol)
            for k, v in want["losses"].items():
                assert abs(got["losses"][k] - v) <= tol, (name, k, got["losses"][k], v)


def test_facegan_refuses_a_half_batch_the_group_does_not_divide(runs):
    """A global batch of 4 has a real half of 2: 2 ranks take one image
    each, 4 ranks raise, as ``get_mesh`` refuses a batch the ranks do not
    divide."""
    for rank in runs["worlds"][2]:
        assert "error" not in rank["facegan_split"]
    for rank in runs["worlds"][4]:
        assert "real half batch 2 (of 4) does not divide over the 4 ranks" in \
            rank["facegan_split"]["error"]
