"""The BoBW slice of the port on the CPU, against the JAX package: QRCAN
(``qrcan`` handler, with selective_meta_blocks and
num_q_layers_inner_residual), the flax-semantics BatchNorm, the DASR
encoder in eval and train mode (running statistics included), the packaged
``supmoco_fullchain_d256`` encoder loaded by both packages, a
``contrastiveblindqrcan`` train step, a JAX-written BoBW checkpoint, and
the trainer and eval CLI driving the example config at a tiny size.

Tolerances: f32 outputs within 1e-5 (QRCAN) and 1e-4 (the encoder's 256
pooled features, relative to their largest) of flax, the same f32 products
summed in another order; BatchNorm statistics within 1e-6 (after a train
step with the packaged encoder, 1e-6 of the largest statistic); a train step's
loss within 1e-6 and its updated generator params within 1e-6. bf16: flax
rounds every op's output to bf16 and the port's RCAB kernel only h1 and the
block's output, so QRCAN x2 within 2**-6 of the largest output (measured
4.6e-3 to 5.3e-3), and the encoder, whose ops both round alike, within 2**-7 of
the largest feature.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models.contrastive import DASREncoder as JaxDASREncoder
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.models.common import BatchNorm
from rumpy_tpu_torch.models.contrastive import DASREncoder
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils import checkpoint as ckpt
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

PACKAGED = "supmoco_fullchain_d256"
BOBW = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_diff(a, b):
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda u, v: float(np.abs(np.asarray(u, np.float32) - np.asarray(v, np.float32)).max()),
        a, b)))


def _max_abs(tree):
    return max(float(np.abs(np.asarray(v)).max()) for v in jax.tree_util.tree_leaves(tree))


# -- QRCAN -------------------------------------------------------------------

QRCAN_CASES = [
    dict(style="max_concat", metadata_bypass_len=24, selective_meta_blocks=[True, False],
         num_q_layers_inner_residual=1),
    dict(style="mini_concat", metadata_bypass_len=5, num_q_layers_inner_residual=1),
    dict(style="modulate"),  # one qpi value, expanded by scale_qpi
    dict(style="standard", metadata_bypass_len=3, include_q_layer=False),
]


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("kw", QRCAN_CASES, ids=[c["style"] for c in QRCAN_CASES])
def test_qrcan_handler_matches_jax(kw, dtype):
    kw = dict(scale=2, n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4,
              dtype=dtype, **kw)
    jh = jax_model("qrcan")(**kw)
    js = jh.init_state()
    th = torch_model("qrcan")(device="cpu", **kw)
    state = TrainState(step=0, params=state_dict_from_jax(_np(js.params), th.module))
    if kw.get("selective_meta_blocks"):  # the second group runs without q-layers
        assert th.module.groups[0].blocks[0].q is not None
        assert th.module.groups[0].blocks[1].q is None
        assert th.module.groups[1].blocks[0].q is None
    rng = np.random.default_rng(len(kw))
    x = rng.random((2, 10, 9, 3)).astype(np.float32)
    meta = rng.random((2, jh.num_metadata)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x), "metadata": jnp.asarray(meta)}),
                      np.float32)
    got = th.run_eval(state, {"lr": x, "metadata": meta}).float().numpy()
    assert got.shape == want.shape == (2, 20, 18, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
    with pytest.raises(RuntimeError, match="Metadata needs to be specified"):
        th.run_eval(state, {"lr": x})


# -- BatchNorm and the DASR encoder -------------------------------------------

def test_batchnorm_keeps_flax_running_stats():
    """One train-mode step: flax's biased variance and momentum 0.9 (torch's
    BatchNorm2d would store the unbiased variance, the trap)."""
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    x = (2.0 + 3.0 * rng.standard_normal((4, 5, 6, 8))).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, use_running_average=False)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(8)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    stats = _np(mut["batch_stats"])
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], atol=1e-6, rtol=0)
    ref = torch.nn.BatchNorm2d(8, momentum=0.1)
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(ref.running_var.numpy() - stats["var"]).max() > 1e-3


@pytest.mark.parametrize("dropdown", [None, 6])
def test_dasr_encoder_eval_and_train_mode_match_flax(dropdown):
    rng = np.random.default_rng(1)
    x = rng.random((3, 21, 18, 3)).astype(np.float32)  # odd sides at the stride-2 convs
    jenc = JaxDASREncoder(dropdown_q=dropdown)
    variables = _np(jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), train=True))
    params = variables["params"]
    stats = jax.tree_util.tree_map(  # running statistics away from 0 and 1
        lambda a: a + 0.2 * np.abs(rng.standard_normal(a.shape)).astype(np.float32),
        variables["batch_stats"])
    enc = DASREncoder(dropdown_q=dropdown)
    enc.load_state_dict(state_dict_from_jax(params, enc, batch_stats=stats))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    (wfea, wout) = jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=False)
    with torch.no_grad():
        fea, out = enc(xt, train=False)
    assert sorted(out) == sorted(wout)
    for got, want in [(fea, wfea)] + [(out[k], wout[k]) for k in wout]:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()

    (wfea, _), mut = jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
    with torch.no_grad():
        fea, _ = enc(xt, train=True)
    want = np.asarray(wfea)
    assert np.abs(fea.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    moved = jax_tree_from_state_dict(enc.state_dict(), enc, "batch_stats")
    assert _max_diff(moved, _np(mut["batch_stats"])) <= 1e-6
    assert _max_diff(moved, stats) > 1e-3


# -- the packaged encoder and the BoBW handler ---------------------------------

@pytest.fixture(scope="module")
def jax_bobw():
    """The JAX handler with the packaged encoder loaded, and its state."""
    jh = jax_model("contrastiveblindqrcan")(pre_trained_encoder_weights=PACKAGED, **BOBW)
    return jh, jh.init_state()


def _port_bobw(js, **kw):
    """The port's handler with the JAX state's generator and encoder."""
    th = torch_model("contrastiveblindqrcan")(device="cpu", **BOBW, **kw)
    full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    return th, th._own_state()


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_packaged_encoder_embeddings_match(jax_bobw, dtype):
    """Both packages load supmoco_fullchain_d256 (weights and running
    statistics) and give the same pre-q embedding of one input."""
    jh, js = jax_bobw
    th = torch_model("contrastiveblindqrcan")(device="cpu", dtype=dtype,
                                              pre_trained_encoder_weights=PACKAGED, **BOBW)
    state = th.init_state()
    enc_sd = {k[len("encoder."):]: v for k, v in state.params.items()
              if k.startswith("encoder.")}
    raw = ckpt.load_checkpoint(ckpt.checkpoint_path(ckpt.resolve_packaged(PACKAGED), 29))
    assert _max_diff(jax_tree_from_state_dict(enc_sd, th.module.encoder),
                     raw["network"]) == 0.0
    assert _max_diff(jax_tree_from_state_dict(enc_sd, th.module.encoder, "batch_stats"),
                     raw["extra"]["q_bstats"]) == 0.0
    x = np.random.default_rng(3).random((2, 24, 20, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want, _ = JaxDASREncoder(dtype=jdt).apply(
        {"params": js.extra["frozen_encoder"], "batch_stats": js.extra["bstats"]["encoder"]},
        jnp.asarray(x), train=False)
    want = np.asarray(want, np.float32)
    with torch.no_grad():
        got = th.module.embed(torch.from_numpy(x).permute(0, 3, 1, 2))[0].float().numpy()
    assert got.shape == (2, 256)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_bobw_train_step_matches_jax(jax_bobw):
    """One train step of the frozen-encoder pipeline: the loss, the updated
    generator, the encoder's weights unchanged (no gradient, no optimizer
    step) and its BatchNorm running statistics moved as flax's did."""
    jh, js = jax_bobw
    th, state = _port_bobw(js)
    assert all(not p.requires_grad for p in th.module.encoder.parameters())
    assert {id(p) for p in th.trainable_parameters()} == {
        id(p) for n, p in th.module.named_parameters() if not n.startswith("encoder.")}
    rng = np.random.default_rng(4)
    lr = rng.random((2, 16, 16, 3)).astype(np.float32)
    hr = rng.random((2, 32, 32, 3)).astype(np.float32)
    enc_before = {k: v.clone() for k, v in state.params.items() if k.startswith("encoder.")}

    # the JAX step donates its state: hand it a copy
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr)})
    state2, tl = th.train_batch(state, {"lr": lr, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    tree = jax_tree_from_state_dict(state2.params, th.module)
    assert _max_diff(tree["generator"], _np(js2.params["generator"])) <= 1e-6
    want_stats = _np(js2.extra["bstats"])
    assert _max_diff(jax_tree_from_state_dict(state2.params, th.module, "batch_stats"),
                     want_stats) <= 1e-6 * _max_abs(want_stats)
    for k, v in enc_before.items():
        after = state2.params[k]
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(after, v), k
        else:
            assert torch.equal(after, v), k


def test_jax_bobw_checkpoint_loads_into_port(jax_bobw, tmp_path):
    """A BoBW checkpoint the JAX package wrote (frozen encoder and running
    statistics in its ``extra``) evaluates the same in the port."""
    jh, js = jax_bobw
    jh.save_model(js, str(tmp_path / "saved_models"), epoch=0)
    th = torch_model("contrastiveblindqrcan")(device="cpu", **BOBW)
    state, epoch = th.load_model(str(tmp_path / "saved_models"), "last",
                                 skip_optimizer_load=True)
    x = np.random.default_rng(5).random((1, 14, 12, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(state, {"lr": x}).numpy(), want, atol=1e-5, rtol=0)


def test_bobw_options_of_later_slices_raise():
    """The options that raised before they were ported (the SFT and SRMD
    modes, a QEDSR generator, the softmax style) give the JAX pipeline's
    outputs from its random-init state, running statistics included."""
    x = np.random.default_rng(8).random((2, 12, 10, 3)).astype(np.float32)
    for kw in (dict(BOBW, sft_mode=True), dict(BOBW, srmd_mode=True),
               dict(scale=2, generator="qedsr", num_features=16, num_blocks=2),
               dict(BOBW, style="softmax")):
        jh = jax_model("contrastiveblindqrcan")(**kw)
        js = jh.init_state()
        th = torch_model("contrastiveblindqrcan")(device="cpu", **kw)
        full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
        th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                      batch_stats=_np(js.extra["bstats"])))
        want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
        got = th.run_eval(th._own_state(), {"lr": x}).numpy()
        assert got.shape == want.shape == (2, 24, 20, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=str(kw))


def test_bobw_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("contrastiveblindqrcan", "qrcan"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_model(name)(**BOBW)


def test_trainable_encoder_mode_trains_it(jax_bobw):
    """encoder_freeze_mode other than "all" (without a joint loss): the
    encoder takes the L1 loss's gradient through the embedding, as in the
    JAX package, where it stays in the optimized params."""
    jh, js = jax_bobw
    th, state = _port_bobw(js, encoder_freeze_mode="none")
    before = {k: v.clone() for k, v in state.params.items() if k.startswith("encoder.")}
    rng = np.random.default_rng(6)
    th.train_batch(state, {"lr": rng.random((2, 16, 16, 3)).astype(np.float32),
                           "hr": rng.random((2, 32, 32, 3)).astype(np.float32)})
    assert not torch.equal(state.params["encoder.convs.0.weight"],
                           before["encoder.convs.0.weight"])


# -- the example config through the trainer and the eval CLI --------------------

def test_example_config_trains_and_scores_on_cpu(tmp_path):
    """examples/train_bobw_rcan_supmoco.toml at a tiny width: HR-only
    .npy files through its degradation chain, the packaged encoder
    resolved by name, validation on LR/HR pairs ("on_site" metadata without
    a CSV), then cli.eval_sisr on the saved run."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "examples", "train_bobw_rcan_supmoco.toml")).as_plain()
    rng = np.random.default_rng(7)
    hr_dir, lr_dir, ehr_dir = tmp_path / "hr", tmp_path / "elr", tmp_path / "ehr"
    for d in (hr_dir, lr_dir, ehr_dir):
        os.makedirs(d)
    for k in range(2):
        np.save(hr_dir / f"h{k}.npy", rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
        hr = rng.integers(0, 256, (32, 28, 3), dtype=np.uint8)
        np.save(ehr_dir / f"e{k}.npy", hr)
        np.save(lr_dir / f"e{k}.npy", np.ascontiguousarray(hr[::4, ::4]))
    cfg["experiment_save_loc"] = str(tmp_path / "Results")
    cfg["data"]["crop"] = 8
    cfg["data"]["dataloader_threads"] = 1
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["data"]["eval_sets"]["data_1"] = {"lr_dir": str(lr_dir), "hr_dir": str(ehr_dir),
                                          "metadata_file": "on_site"}
    cfg["model"]["internal_params"].update(n_feats=16, n_resgroups=1, n_resblocks=2,
                                           reduction=4, dtype="float32")
    cfg["training"].update(num_epochs=1, batch_size=2)
    path = tmp_path / "bobw.toml"
    dump_toml(cfg, str(path))
    stats = train_sisr.main(["-p", str(path), "--device", "cpu"])
    assert np.isfinite([stats[0]["train-loss"], stats[0]["val-PSNR"]]).all()
    exp = cfg["experiment"]
    saved = torch.load(os.path.join(tmp_path, "Results", exp, "saved_models", "train_model_0"),
                       weights_only=True)
    raw = ckpt.load_checkpoint(ckpt.checkpoint_path(ckpt.resolve_packaged(PACKAGED), 29))
    np.testing.assert_array_equal(saved["network"]["encoder.convs.5.weight"].numpy(),
                                  raw["network"]["TConv_5"]["kernel"].transpose(3, 2, 0, 1))
    out = tmp_path / "scores"
    eval_sisr.main(["--model_loc", str(tmp_path / "Results"), "--out_loc", str(out),
                    "--lr_dir", str(lr_dir), "--hr_dir", str(ehr_dir), "--scale", "4",
                    "-me", exp, "last", "--device", "cpu"])
    assert os.path.isfile(out / "individual_metrics.csv")
