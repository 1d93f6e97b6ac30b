"""The attribute-conditioned GAN handlers (facesrattributesgan, agagan,
fmfnet) in the port, on the CPU, against the JAX package's
``AttributeGANHandler``: an L1 pre-train step and an LSGAN step of each
from the same state (FaceSR's with the JAX step's dropout masks injected),
with the discriminator's calls a step; a JAX-written checkpoint (FaceSR's
with its generator's BatchNorm statistics in ``extra.g_vars``) loaded into
the port and scored; the metadata rules of both packages; and the port's
CLI round trip, ``cli.train_sisr`` on a CelebA-format set with its
attributes file, then ``cli.eval_sisr`` on the saved run.

Weights come from the port's seeded init, jittered, through the weight
bridge; inputs come from a numpy seed. Steps run under SGD at lr 1, so a
parameter moves by its gradient. FaceSR's steps are held in float64 in
both packages: its encoder ends in a 1 x 1 bottleneck whose train-mode
BatchNorm normalises two values a channel, E[x^2] - E[x]^2 of nearly equal
numbers, which float32 rounding decides. There each loss, move and
statistic is within 1e-9 of the JAX step's (relative to the leaf's largest
move or entry). AGA-GAN's and FMFNet's steps are float32: losses within
1e-5 relative, each move within 1e-4 (AGA-GAN) or 1e-3 (FMFNet, a much
deeper network: ``MOVE_REL``) of that leaf's largest move plus two float32
ulps of 1. Checkpoint scores within 1e-5 of the largest output.
"""

import contextlib
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models.base import TrainState
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
from torch_parallel_worker import default_threads
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

NA = 8
SGD = dict(optimizer_type="sgd", lr=1.0)
WIDTHS = {"facesrattributesgan": 4, "agagan": 8, "fmfnet": 8}
F64_REL, LOSS_REL, PARAM_ULPS, OUT_REL = 1e-9, 1e-5, 2.0 ** -22, 1e-5
# float32 moves against the leaf's largest move: FMFNet's last convs take
# their gradient through 51 conv-PReLUs and 20 dense-block calls, summed over
# 128 x 128 pixels in another order (1.5e-4 of the move seen at its output
# bias); AGA-GAN's within 1e-4
MOVE_REL = {"agagan": 1e-4, "fmfnet": 1e-3}
CELEBA = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs Big_Lips "
          "Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows Chubby Double_Chin "
          "Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open "
          "Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose Receding_Hairline "
          "Rosy_Cheeks Sideburns Smiling Straight_Hair Wavy_Hair Wearing_Earrings Wearing_Hat "
          "Wearing_Lipstick Wearing_Necklace Wearing_Necktie Young").split()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            t.add_(0.02 * torch.rand(t.shape, generator=gen) if "running_var" in name
                   else 0.02 * torch.randn(t.shape, generator=gen))


def _port_float64(mp, module):
    mp.setattr(torch.Tensor, "float", torch.Tensor.double)
    module.double()
    for m in module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((n, 16, 16, 3)).astype(np.float32),
            "hr": rng.random((n, 128, 128, 3)).astype(np.float32),
            "metadata": (rng.random((n, NA)) > 0.5).astype(np.float32)}


def _pair(name, seed, **kw):
    """The port's handler, seeded and jittered, and its params and
    statistics as flax trees."""
    th = torch_model(name)(device="cpu", n_feats=WIDTHS[name], metadata_bypass_len=NA, **kw)
    th.init_state(seed)
    _seeded(th.module, seed)
    return (th, jax_tree_from_state_dict(th.module.state_dict(), th.module),
            jax_tree_from_state_dict(th.module.state_dict(), th.module, "batch_stats"))


def _jax_handler(name, dtype, **kw):
    jh = jax_model(name)(n_feats=WIDTHS[name], metadata_bypass_len=NA, **kw)
    if dtype == jnp.float64:
        jh.dtype = dtype
        jh.module = jh.build_module(None, None, None)
    jh.discriminator = jh.build_discriminator()
    return jh


def _jax_state(jh, params, stats):
    g_vars = {"batch_stats": stats["generator"]} if stats.get("generator") else {}
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state={"generator": jh.tx.init(params["generator"]),
                                 "discriminator": jh.d_tx.init(params["discriminator"])},
                      extra={"d_vars": {}, "g_vars": g_vars}, rng=jax.random.PRNGKey(0))


def _dropout_masks(jd, params, key, img, meta):
    """The keep masks of the FaceSR discriminator's three dropouts in a
    train-mode call with ``key``: (N, C) for the channel dropouts, (N,
    1024) for the dense one."""
    taken = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            mask = np.asarray(out) != 0
            taken.append(mask[:, 0, 0, :] if mask.ndim == 4 else mask)
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jd.apply({"params": params}, img, meta, train=True, rngs={"dropout": key})
    return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in taken)


def _assert_step(got, want, before, move_rel=None):
    """Each leaf against the JAX step's: in float64 (no ``move_rel``)
    within 1e-9 of its largest move or entry, in float32 within ``move_rel``
    of its largest move plus two ulps of 1."""
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                               jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        tol = (F64_REL * max(move, np.abs(w).max()) if move_rel is None
               else move_rel * move + PARAM_ULPS)
        assert np.abs(g - w).max() <= tol, jax.tree_util.keystr(path)


def _never_called(*args):
    raise AssertionError("the attribute GAN step ran the online chain")


@pytest.mark.parametrize("name", list(WIDTHS))
def test_pretrain_and_gan_steps_match_jax(name, monkeypatch):
    """From one state, the pre-train step (the generator in train mode, its
    L1) and the adversarial step (the generator against the discriminator
    in eval mode, fake then real; then the discriminator in train mode on
    the real and the detached fake images, FaceSR's with the masks JAX
    drew from its step key): the losses, every parameter of both networks
    and FaceSR's BatchNorm statistics; the port's discriminator calls, two
    in eval mode and two in train mode. Both packages ignore an online
    chain (one that raises is never called) and ``main_lr`` (at 1e-30 the
    adversarial step still moves the generator by its gradient: the one
    generator optimizer is the pre-train one), ROADMAP.md section 3."""
    f64 = name == "facesrattributesgan"
    dtype = jnp.float64 if f64 else jnp.float32
    kw = dict(pretrain_epochs=1, main_lr=1e-30, **SGD)
    th, params, stats = _pair(name, 3, **kw)
    th.set_input_pipeline(_never_called)
    batch = _batch(5)
    want = {}
    with jax.enable_x64(True) if f64 else contextlib.nullcontext():
        jh = _jax_handler(name, dtype, **kw)
        jh.set_input_pipeline(_never_called)
        p, s = (_f64(params), _f64(stats)) if f64 else (params, stats)
        js0 = _jax_state(jh, p, s)
        jb = {k: jnp.asarray(v, dtype) for k, v in batch.items()}
        for epoch in (0, 1):
            jh.set_epoch(epoch)
            js, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js0), jb)
            want[epoch] = (_np(js.params), {k: float(v) for k, v in jl.items()},
                           _np(js.extra["g_vars"].get("batch_stats", {})))
        draws = {}
        if f64:
            _, drop1, drop2 = jax.random.split(js0.rng, 3)
            draws = {part: _dropout_masks(jh.discriminator, p["discriminator"], key, jb["hr"],
                                          jb["metadata"])
                     for part, key in (("keep_real", drop1), ("keep_fake", drop2))}
            assert [tuple(k.shape) for k in draws["keep_real"]] == \
                th.discriminator.mask_shapes(2)
    start = {k: v.clone() for k, v in th.module.state_dict().items()}
    if f64:
        _port_float64(monkeypatch, th.module)
    tb = {k: torch.from_numpy(v).to(torch.float64 if f64 else torch.float32)
          for k, v in batch.items()}
    calls = []
    th.discriminator.register_forward_pre_hook(
        lambda m, a, k: calls.append(bool(k.get("train"))), with_kwargs=True)
    with default_threads():  # float32 steps: see default_threads
        for epoch in (0, 1):
            th.module.load_state_dict(start)
            th.load_optimizer_state(None)
            th.set_epoch(epoch)
            calls.clear()
            if epoch == 0:
                _, tl = th.train_batch(th._own_state(), tb)
                assert calls == []
            else:
                th._own_state()
                tl = th.step_from_draws(tb, draws)
                assert sorted(calls) == [False, False, True, True]
            wp, wl, wst = want[epoch]
            assert set(tl) == set(wl)
            for k, w in wl.items():
                rel = F64_REL if f64 else LOSS_REL
                assert abs(float(tl[k]) - w) <= rel * max(abs(w), 1e-12), (epoch, k)
            got = jax_tree_from_state_dict(th.module.state_dict(), th.module)
            assert max(np.abs(w - b).max() for w, b in zip(
                jax.tree_util.tree_leaves(wp["generator"]),
                jax.tree_util.tree_leaves(params["generator"]))) > 1e-6
            for part in ("generator", "discriminator"):
                _assert_step(got[part], wp[part], params[part], None if f64 else MOVE_REL[name])
            if f64:
                assert float(tl["gan-loss"]) > 0 if epoch else float(tl["gan-loss"]) == 0
                got_stats = jax_tree_from_state_dict(th.module.state_dict(), th.module,
                                                     "batch_stats")["generator"]
                for g, w, b in zip(jax.tree_util.tree_leaves(got_stats),
                                   jax.tree_util.tree_leaves(wst),
                                   jax.tree_util.tree_leaves(stats["generator"])):
                    assert np.abs(g - w).max() <= F64_REL * np.abs(w).max()
                    assert not np.array_equal(w, b)


@pytest.mark.parametrize("name", ["facesrattributesgan", "agagan"])
def test_jax_written_checkpoint_scores_the_same(name, tmp_path):
    """A checkpoint the JAX handler wrote (params {generator,
    discriminator}, FaceSR's generator statistics in extra.g_vars, its
    optax state) loads through ``load_model`` (the optimizer state
    skipped) and scores a batch as the JAX handler does, the statistics
    bit for bit."""
    th, params, stats = _pair(name, 11)
    jh = _jax_handler(name, jnp.float32)
    js = _jax_state(jh, params, stats)
    jh.save_model(js, str(tmp_path / "saved_models"), epoch=0)
    fresh = torch_model(name)(device="cpu", n_feats=WIDTHS[name], metadata_bypass_len=NA)
    state, epoch = fresh.load_model(str(tmp_path / "saved_models"), "last",
                                    skip_optimizer_load=True)
    assert epoch == 0
    assert all(torch.equal(v, th.module.state_dict()[k]) for k, v in state.params.items())
    batch = _batch(12, n=3)
    want = np.asarray(jh.run_eval(js, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = fresh.run_eval(state, batch).numpy()
    assert got.shape == want.shape == (3, 128, 128, 3)
    assert np.abs(got - want).max() <= OUT_REL * np.abs(want).max()


def test_metadata_rules_match_jax():
    """``metadata=["all"]`` (the default) is CelebA's 40 attributes in both
    packages, with the same handler metadata; both ``apply``s raise without
    metadata."""
    jh = jax_model("agagan")(n_feats=4)
    th = torch_model("agagan")(device="cpu", n_feats=4)
    assert jh.num_metadata == th.num_metadata == 40
    assert jh.handler_metadata() == th.handler_metadata()
    assert jh.scale == th.scale == 8
    with pytest.raises(RuntimeError, match="Metadata needs to be specified"):
        jh.apply({}, {"lr": jnp.zeros((1, 16, 16, 3))})
    with pytest.raises(RuntimeError, match="Metadata needs to be specified"):
        th.apply(th.init_state().params, {"lr": np.zeros((1, 16, 16, 3), np.float32)})


def test_facesr_trains_from_its_own_draws():
    """``train_batch`` in the adversarial phase draws the dropout masks from
    the handler's generator: finite losses, both networks and the
    generator's statistics moved."""
    th = torch_model("facesrattributesgan")(device="cpu", n_feats=4, metadata_bypass_len=NA)
    state = th.init_state()
    before = {k: v.clone() for k, v in state.params.items()}
    state2, losses = th.train_batch(state, _batch(13))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert float(losses["gan-loss"]) > 0 and float(losses["d-loss-real"]) > 0
    moved = {k for k, v in state2.params.items() if not torch.equal(v, before[k])}
    assert {k.split(".")[0] for k in moved} == {"generator", "discriminator"}
    assert any(k.endswith("running_mean") for k in moved)


def _write_faces(root, rng, n):
    """A CelebA-format set: ``n`` HR 128 x 128 faces (.npy), their x8
    decimations and list_attr_celeba.txt."""
    lr_dir, hr_dir = root / "lr", root / "hr"
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    rows = []
    for k in range(n):
        stem = f"{k + 1:06d}"
        hr = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
        np.save(hr_dir / f"{stem}.npy", hr)
        np.save(lr_dir / f"{stem}.npy", np.ascontiguousarray(hr[::8, ::8]))
        rows.append(f"{stem}.jpg " + " ".join(f"{v:2d}" for v in rng.choice([-1, 1], 40)))
    attrs = root / "list_attr_celeba.txt"
    attrs.write_text(f"{n}\n" + " ".join(CELEBA) + "\n" + "\n".join(rows) + "\n")
    return str(lr_dir), str(hr_dir), str(attrs)


def test_cli_round_trip_on_the_cpu(tmp_path):
    """facesrattributesgan at n_feats 4 through cli.train_sisr on a
    CelebA-format set with all 40 attributes (epoch 0 pre-trains, epoch 1
    is adversarial), then cli.eval_sisr on the saved run with the attributes
    given by the eval config: finite losses, the handler metadata in the
    checkpoint, a PSNR and SSIM row an image."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.utils import checkpoint as ckpt
    lr_dir, hr_dir, attrs = _write_faces(tmp_path, np.random.default_rng(14), 4)
    cfg = {"experiment": "facesr_attr", "experiment_save_loc": str(tmp_path / "Results"),
           "data": {"scale": 8, "dataloader_threads": 1, "metadata": ["all"],
                    "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir,
                                                 "attributes_loc": attrs}}},
           "model": {"name": "facesrattributesgan", "internal_params": {
               "n_feats": 4, "metadata": ["all"], "pretrain_epochs": 1}},
           "training": {"num_epochs": 2, "batch_size": 2, "seed": 3}}
    dump_toml(cfg, str(tmp_path / "train.toml"))
    stats = train_sisr.main(["-p", str(tmp_path / "train.toml"), "--device", "cpu"])
    assert float(stats[0]["gan-loss"]) == 0 < float(stats[1]["gan-loss"])
    assert all(np.isfinite([s["train-loss"], s["d-loss-real"]]).all() for s in stats.values())
    saved = ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(tmp_path / "Results" / "facesr_attr" / "saved_models"), 1))
    assert saved["handler_metadata"]["num_metadata"] == 40
    dump_toml({"data": {"lr_dir": lr_dir, "hr_dir": hr_dir, "attributes_loc": attrs,
                        "data_attributes": "all"}}, str(tmp_path / "eval.toml"))
    out = tmp_path / "scores"
    eval_sisr.main(["-c", str(tmp_path / "eval.toml"), "--model_loc",
                    str(tmp_path / "Results"), "--scale", "8", "-m", "PSNR", "-m", "SSIM",
                    "-me", "facesr_attr", "last", "--out_loc", str(out), "--device", "cpu"])
    lines = (out / "individual_metrics.csv").read_text().splitlines()
    assert "facesr_attr" in lines[0] and "PSNR" in lines[1] and len(lines) == 2 + 4 + 1
