"""DAN in the port, on the CPU, against the JAX package: v1, v2 (plain and
residual forms) and v1QRCAN (QRCAN's blocks on the RCAB kernel's plain
version), forward at every iteration, one train step's per-iteration losses,
gradients and updated parameters, the bridge both ways, the model
constants carried across, the defaults' divergence, the example's
metadata chain and ``danv1qrealesrgan``'s build and eval.

Flax params are carried over by the weight bridge (biases jittered off
zero), DAN's ``init_ker_map`` and DANv2's ``pca_matrix`` by
``model_constants_from_jax`` (both packages fit their defaults from their
own random draws), inputs from a numpy seed. Tolerances: f32 outputs within
1e-5 (the same f32 products summed in another order), gradients within
1e-4 of each gradient's largest entry, a train step under SGD at lr 1 (a
parameter moves by its gradient) within 1e-4 of each leaf's largest move
plus two float32 ulps of a parameter below 1, losses within 1e-5; bf16
outputs within 2**-6 of the largest output.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.config.loader import load_config as jax_load_config
from rumpy_tpu.degradations.pipeline import ImagePipeline as JaxPipeline
from rumpy_tpu.models import dan as jdan
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
from rumpy_tpu_torch.models import dan as tdan
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import (jax_tree_from_state_dict, model_constants_from_jax,
                                           state_dict_from_jax)

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "train_dan_qrcan_blind.toml")

KS = 7  # DANv2's kernel size here
CASES = {
    "v1": dict(mode="v1", nf=16, nb=1, loop=2),
    "v2": dict(mode="v2", nf=16, nb=1, ng=1, loop=2, kernel_size=KS),
    "v2-residual": dict(mode="v2", nf=16, nb=1, ng=1, loop=2, kernel_size=KS,
                        residual_kernel=True, residual_sr=True),
    "v1QRCAN": dict(mode="v1QRCAN", loop=2,
                    generator_params=dict(n_feats=16, n_resgroups=1, n_resblocks=2)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _constants(case):
    """Seeded constants in place of the fitted defaults: a code for v1, an
    orthonormal (10, k^2) basis for v2."""
    rng = np.random.default_rng(7)
    if CASES[case]["mode"] == "v2":
        q, _ = np.linalg.qr(rng.standard_normal((KS * KS, 10)))
        return {"pca_matrix": tuple(tuple(r) for r in q.T.astype(np.float32).tolist())}
    return {"init_ker_map": tuple(rng.standard_normal(10).astype(np.float32).tolist())}


@functools.lru_cache(maxsize=None)
def _jax(case, dtype="float32", **over):
    jh = jax_model("dan")(scale=2, dtype=dtype, **CASES[case], **_constants(case), **dict(over))
    rng = np.random.default_rng(len(case))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        _np(jh.init_state().params))
    return jh, params


def _pair(case, dtype="float32", **over):
    """The JAX handler and params, and the port's handler (built with its
    own fitted defaults) carrying both the params and the constants."""
    jh, params = _jax(case, dtype, **over)
    th = torch_model("dan")(device="cpu", scale=2, dtype=dtype, **CASES[case], **over)
    with torch.no_grad():
        th.module.load_state_dict(state_dict_from_jax(params, th.module))
    model_constants_from_jax(jh.module, th.module)
    return jh, params, th, th._own_state()


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 8, 8, 3)).astype(np.float32)
    hr = rng.random((2, 16, 16, 3)).astype(np.float32)
    if CASES[case]["mode"] == "v2":
        k = rng.random((2, KS * KS)).astype(np.float32)
        meta = k / k.sum(axis=1, keepdims=True)
    else:
        meta = rng.random((2, 10)).astype(np.float32)
    return x, hr, meta


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_dan_forward_matches_jax(case):
    """Every iteration's SR, code (and v2's kernel), the eval SR, and the
    bridge back to flax's tree."""
    jh, params, th, state = _pair(case)
    x, _, _ = _inputs(case)
    want = jh.module.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = th.module(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) and len(got[0]) == CASES[case]["loop"]
    for i in range(CASES[case]["loop"]):
        np.testing.assert_allclose(got[0][i].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[0][i]), atol=F32_ATOL, rtol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w[i]), atol=F32_ATOL, rtol=0)
    sr = th.run_eval(state, {"lr": x})
    assert sr.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(sr.numpy(), np.asarray(jh.apply(params, {"lr": jnp.asarray(x)})[0]),
                               atol=F32_ATOL, rtol=0)
    back = jax_tree_from_state_dict(th.module.state_dict(), th.module)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_model_constants_come_from_the_jax_module():
    jh, _, th, _ = _pair("v1")
    np.testing.assert_array_equal(th.module.init_ker_map.numpy(),
                                  np.asarray(jh.module.init_ker_map, np.float32))
    jh2, _, th2, _ = _pair("v2")
    np.testing.assert_array_equal(th2.module.pca_matrix.numpy(),
                                  np.asarray(jh2.module.pca_matrix, np.float32))
    with pytest.raises(ValueError, match="init_ker_map"):
        model_constants_from_jax(type("M", (), {"init_ker_map": (0.0,) * 3})(), th.module)


def test_dan_bf16_forward_matches_jax():
    jh, params, th, state = _pair("v1", "bf16")
    x, _, _ = _inputs("v1", 3)
    want = np.asarray(jh.apply(params, {"lr": jnp.asarray(x)})[0], np.float32)
    got = th.run_eval(state, {"lr": x}).float().numpy()
    assert _err(got, want) <= BF16_REL * np.abs(want).max()


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", ["v1", "v2", "v1QRCAN"])
def test_dan_train_step_matches_jax(case):
    """Per-iteration losses, every parameter's gradient against jax.grad of
    the JAX loss, and the parameters after one SGD step at lr 1. The
    iterations before the last keep no graph in the port's step."""
    jh, params, th, state = _pair(case, optimizer_type="sgd", lr=1.0)
    x, hr, meta = _inputs(case, 1)
    batch = {"lr": jnp.asarray(x), "hr": jnp.asarray(hr), "metadata": jnp.asarray(meta)}
    gp = jax.grad(lambda p: jh.compute_losses(jh.apply(p, batch, train=True)[0], batch,
                                              {})["train-loss"])(params)
    js = jh.init_state()
    js2, jl = jh.train_batch(js.replace(params=jax.tree_util.tree_map(jnp.asarray, params)),
                             batch)
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr, "metadata": meta})
    assert set(tl) == set(jl)
    assert len([k for k in tl if k.startswith("image-loss-iter-")]) == CASES[case]["loop"]
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= F32_ATOL, k
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in th.module.named_parameters()}
    got_g = _flat(jax_tree_from_state_dict(grads, th.module))
    want_g = _flat(_np(gp))
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        assert _err(got_g[k], w) <= F32_GRAD_REL * max(np.abs(w).max(), 1e-6), k
    got_p = _flat(jax_tree_from_state_dict(state2.params, th.module))
    want_p = _flat(_np(js2.params))
    for k, w in want_p.items():
        move = np.abs(want_g[k]).max()
        assert _err(got_p[k], w) <= F32_GRAD_REL * max(move, 1e-6) + PARAM_ULPS, k
    with torch.enable_grad():
        out, _, _ = th.apply(state2.params, {"lr": x}, train=True)
    assert out[0][0].grad_fn is None and out[0][-1].grad_fn is not None
    assert out[1][0].grad_fn is None and out[1][-1].grad_fn is not None


def test_default_constants_differ_from_jax_by_their_draws():
    """Both packages fit the default basis to 2000 random SRMD kernels, from
    jax.random and from a torch generator. The port's fit is its own every
    time; its rows stand within a few hundredths of JAX's, up to sign."""
    ours = np.asarray(tdan._default_pca_matrix(10, 21), np.float32)
    np.testing.assert_array_equal(ours, np.asarray(tdan._default_pca_matrix(10, 21)))
    theirs = np.asarray(jdan._default_pca_matrix(10, 21), np.float32)
    assert ours.shape == theirs.shape == (10, 441)
    np.testing.assert_allclose(ours @ ours.T, np.eye(10), atol=1e-5)
    row_gap = [min(np.abs(o - t).max(), np.abs(o + t).max()) for o, t in zip(ours, theirs)]
    ikm = np.asarray(tdan._default_init_ker_map(10, 21))
    jikm = np.asarray(jdan._default_init_ker_map(10, 21))
    code_gap = float(np.abs(np.abs(ikm) - np.abs(jikm)).max())
    print(f"default basis rows up to sign: max gap {max(row_gap):.4g} "
          f"(first row {row_gap[0]:.4g}); delta code |values| gap {code_gap:.4g}")
    assert row_gap[0] < 0.05  # the leading component is the same direction
    assert max(row_gap) > 1e-4  # and the defaults are not the same constants


def test_danv1qrealesrgan_raises_naming_item_9():
    """danv1qrealesrgan raised naming item 9 until gan_models came: now it
    builds DAN v1 on a QRRDBNet restorer (its steps against JAX are in
    tests/test_torch_gan.py) and scores as JAX's at the same weights and
    code; v1QHAN, whose family came with the HAN slice, builds its QHAN
    restorer and matches JAX."""
    gkw = dict(scale=2, nf=8, nb=1, gc=4, d_nf=4, loop=2, init_ker_map=(0.1,) * 10)
    jg = jax_model("danv1qrealesrgan")(**gkw)
    jgs = jg.init_state()
    tg = torch_model("danv1qrealesrgan")(device="cpu", **gkw)
    assert type(tg.module.generator.restorer).__name__ == "RRDBNet"
    tg.module.load_state_dict(state_dict_from_jax(
        _np(jgs.params), tg.module,
        batch_stats={"discriminator": _np(jgs.extra["d_vars"]["batch_stats"])}))
    x = np.random.default_rng(1).random((1, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.run_eval(tg._own_state(), {"lr": x}).numpy(),
                               np.asarray(jg.run_eval(jgs, {"lr": jnp.asarray(x)})),
                               atol=F32_ATOL, rtol=0)
    kw = dict(mode="v1QHAN", scale=2, nf=16, loop=2, input_para=4, kernel_size=9,
              init_ker_map=(0.1,) * 4,
              generator_params=dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4))
    jh = jax_model("dan")(**kw)
    js = jh.init_state()
    th = torch_model("dan")(device="cpu", **kw)
    assert type(th.module.restorer).__name__ == "QHAN"
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module))
    x = np.random.default_rng(0).random((1, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(th._own_state(), {"lr": x}).numpy(), want,
                               atol=F32_ATOL, rtol=0)


def _example_chains():
    cfg = jax_load_config(EXAMPLE)
    online = cfg["data"]["online_degradations"]
    fixed = {"pipeline": online["pipeline"],
             "deg_configs": {k: dict(v) for k, v in online["deg_configs"].items()}}
    b = fixed["deg_configs"]["b"]
    b.pop("request_full_kernels")
    b.update(request_pca_kernels=True, pca_length=10)
    return online, fixed


def _select(mat, keys, requested):
    idx = [i for r in requested for i, k in enumerate(keys) if k == r or k.endswith(f"-{r}")]
    return mat[:, idx]


def test_example_chain_gives_442_columns_that_fail_the_kernel_loss_in_both():
    """examples/train_dan_qrcan_blind.toml asks for full kernels and no
    metadata selection: a (N, 442) target for the (N, 10) estimate, and
    the first step fails in both packages; the corrected chain
    (request_pca_kernels, pca_length 10, metadata ["blur_kernel"]) gives
    (N, 10)."""
    online, fixed = _example_chains()
    hr = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    jp = JaxPipeline(online["pipeline"], deg_configs=online["deg_configs"], scale=4)
    _, jmeta = jp.degrade_batch(jax.random.PRNGKey(0), jnp.asarray(hr))
    jmat, jkeys = jp.metadata_matrix(jmeta)
    tp = ImagePipeline(online["pipeline"], deg_configs=online["deg_configs"], scale=4)
    _, tmeta = tp.degrade_batch(torch.Generator().manual_seed(0), torch.from_numpy(hr))
    tmat, tkeys = tp.metadata_matrix(tmeta)
    assert np.asarray(jmat).shape == tuple(tmat.shape) == (2, 442)
    assert list(jkeys) == list(tkeys)

    kw = dict(CASES["v1QRCAN"], scale=4, **_constants("v1QRCAN"))
    jh = jax_model("dan")(**kw)
    lr = np.random.default_rng(1).random((2, 4, 4, 3)).astype(np.float32)
    with pytest.raises((TypeError, ValueError)):
        jh.train_batch(jh.init_state(), {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr),
                                         "metadata": jmat})
    th = torch_model("dan")(device="cpu", **kw)
    with pytest.raises(RuntimeError):
        th.train_batch(th.init_state(), {"lr": lr, "hr": hr, "metadata": tmat})

    jp2 = JaxPipeline(fixed["pipeline"], deg_configs=fixed["deg_configs"], scale=4)
    _, jmeta2 = jp2.degrade_batch(jax.random.PRNGKey(0), jnp.asarray(hr))
    tp2 = ImagePipeline(fixed["pipeline"], deg_configs=fixed["deg_configs"], scale=4)
    _, tmeta2 = tp2.degrade_batch(torch.Generator().manual_seed(0), torch.from_numpy(hr))
    jsel = _select(np.asarray(jp2.metadata_matrix(jmeta2)[0]), jp2.metadata_matrix(jmeta2)[1],
                   ["blur_kernel"])
    tmat2, tkeys2 = tp2.metadata_matrix(tmeta2)
    tsel = _select(tmat2, tkeys2, ["blur_kernel"])
    assert jsel.shape == tuple(tsel.shape) == (2, 10)
    state, losses = th.train_batch(th.init_state(), {"lr": lr, "hr": hr, "metadata": tsel})
    assert np.isfinite(float(losses["train-loss"]))


def test_example_with_the_corrected_chain_through_both_clis(tmp_path):
    """examples/train_dan_qrcan_blind.toml at a tiny width on the CPU, its
    chain corrected (request_pca_kernels, pca_length 10, metadata
    ["blur_kernel"]): HR-only .npy files through cli.train_sisr with
    validation on LR/HR pairs, then cli.eval_sisr on the run."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    cfg = load_config(EXAMPLE).as_plain()
    _, fixed = _example_chains()
    rng = np.random.default_rng(12)
    hr_dir, lr_dir, ehr_dir = tmp_path / "hr", tmp_path / "elr", tmp_path / "ehr"
    for d in (hr_dir, lr_dir, ehr_dir):
        os.makedirs(d)
    for k in range(2):
        np.save(hr_dir / f"h{k}.npy", rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
        hr = rng.integers(0, 256, (32, 28, 3), dtype=np.uint8)
        np.save(ehr_dir / f"e{k}.npy", hr)
        np.save(lr_dir / f"e{k}.npy", np.ascontiguousarray(hr[::4, ::4]))
    cfg["experiment_save_loc"] = str(tmp_path / "Results")
    cfg["data"].update(crop=8, dataloader_threads=1, online_degradations=fixed,
                       metadata=["blur_kernel"])
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["data"]["eval_sets"]["data_1"] = {"lr_dir": str(lr_dir), "hr_dir": str(ehr_dir),
                                          "metadata_file": "on_site"}
    cfg["model"]["internal_params"].update(
        loop=2, init_ker_map=list(_constants("v1")["init_ker_map"]),
        generator_params={"n_feats": 16, "n_resgroups": 1, "n_resblocks": 2})
    cfg["training"].update(num_epochs=1, batch_size=2)
    path = tmp_path / "dan.toml"
    dump_toml(cfg, str(path))
    stats = train_sisr.main(["-p", str(path), "--device", "cpu"])
    assert {"image-loss-iter-1", "kernel-loss-iter-1"} <= set(stats[0])
    assert np.isfinite([stats[0]["train-loss"], stats[0]["val-PSNR"]]).all()
    out = tmp_path / "scores"
    eval_sisr.main(["--model_loc", str(tmp_path / "Results"), "--out_loc", str(out),
                    "--lr_dir", str(lr_dir), "--hr_dir", str(ehr_dir), "--scale", "4",
                    "-me", cfg["experiment"], "last", "--device", "cpu"])
    assert os.path.isfile(out / "individual_metrics.csv")
