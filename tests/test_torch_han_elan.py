"""HAN, QHAN, ELAN and QELAN in the port, on the CPU, against the JAX
package (``rumpy_tpu/models/han_elan.py``): LAM, CSAM, the shift conv and
GMSA (with and without shifted windows, in train and eval, and the path
that reuses the previous attention) forward and gradients; each handler's
eval output and one train step, ELAN's BatchNorm statistics after it; the
``contrastiveblindqhan`` and ``contrastiveblindqelan`` BoBW handlers' forward
and one step; what QELAN's BatchNorm and ``sft_mode`` do under BoBW in both
packages; and JAX-written HAN and ELAN checkpoints evaluated in the port.
Flax params are carried over by the weight bridge, inputs come from a numpy
seed, and every ``gamma`` (zero at init, where LAM and CSAM would add
nothing) is set to 0.5 in both packages before comparing.

Tolerances: f32 outputs within 1e-5 of flax, gradients within 1e-4 of each
gradient's largest entry (of all gradients' largest, for GMSA's input-conv
bias in train, whose exact gradient is zero), a train step under SGD at lr 1 (a parameter
moves by its gradient) within 1e-6 on the loss and 1e-4 of each move plus
two float32 ulps. LAM's energies are sums over C x H x W terms and its
softmax of ``max - energy`` is near one-hot, so a float32 rounding of an
energy moves the output by about |energy| x 2**-23 relative: the LAM tests
keep the energies near 10 (inputs of scale 0.1), where that stays far
inside 1e-5. bf16: flax rounds every op's output to bf16 and so does the
port, summing in other orders: within 2**-6 of the largest output. LAM at
bf16 moves flax's own output by 0.2-0.9 from its f32 output (its winner
changes with the energies' rounding), yet the port's bf16 stays within
2**-6 of flax's bf16, since both round the same energies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.models import han_elan as jhe
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import han_elan as the
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

F32_ATOL, F32_GRAD_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -6
PARAM_ULPS = 2.0 ** -22
GAMMA = 0.5

HANDLERS = {
    "han": dict(scale=2, n_feats=16, n_resgroups=2, n_resblocks=1, reduction=4),
    "qhan": dict(scale=2, metadata=["qpi"], n_feats=16, n_resgroups=2, n_resblocks=1,
                 reduction=4),
    "elan": dict(scale=2, m_elan=2, c_elan=30, window_sizes=(2, 4, 4)),
    "qelan": dict(scale=2, metadata=["qpi"], m_elan=4, c_elan=30, window_sizes=(2, 4, 4)),
}
SGD = dict(optimizer_type="sgd", lr=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gammas(tree, value=GAMMA):
    """Every ``gamma`` leaf of a flax tree set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.full_like(np.asarray(a), value)
                      if jax.tree_util.keystr(p).endswith("['gamma']") else np.asarray(a)), tree)


def _grad_pairs(tm, gp):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tm.named_parameters()}
    got = dict(jax.tree_util.tree_flatten_with_path(jax_tree_from_state_dict(grads, tm))[0])
    want = jax.tree_util.tree_flatten_with_path(_np(gp))[0]
    assert len(want) == len(got)
    return [(jax.tree_util.keystr(k), got[k], v) for k, v in want]


def _assert_grads(pairs, zero_in_exact=()):
    """Each gradient within 1e-4 of its largest entry; one that exact
    arithmetic makes zero (a bias in front of BatchNorm on batch
    statistics: its entries are rounding noise) within 1e-4 of the largest
    entry of all."""
    top = max(np.abs(want).max() for _, _, want in pairs)
    for name, got, want in pairs:
        scale = top if name in zero_in_exact else max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= F32_GRAD_REL * scale, name


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


# -- blocks ------------------------------------------------------------------------

def _lam_input(dtype=np.float32, shape=(2, 11, 6, 7, 16), scale=0.1):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * scale
    # bf16-valued, so that both precisions start from one input
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _lam_port(x):  # (B, N, H, W, C) -> the port's (B, N, C, H, W)
    return torch.from_numpy(np.array(x)).permute(0, 1, 4, 2, 3)


def _lam_flat(t, shape):  # the port's (B, N*C, H, W) -> flax's (B, H, W, N*C)
    b, n, h, w, c = shape
    return t.reshape(b, n, c, h, w).permute(0, 3, 4, 1, 2).reshape(b, h, w, n * c)


def test_lam_matches_flax():
    """LAM in f32: the output, the input's gradient and gamma's."""
    x = _lam_input()
    params = {"gamma": jnp.full((1,), GAMMA)}
    jm = jhe.LAMModule()
    cot = np.random.default_rng(2).standard_normal(
        (x.shape[0], x.shape[2], x.shape[3], x.shape[1] * x.shape[4])).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, v: jnp.sum(jm.apply({"params": p}, v) * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))
    tm = the.LAMModule()
    tm.load_state_dict(state_dict_from_jax(params, tm))
    xt = _lam_port(x).requires_grad_(True)
    out = _lam_flat(tm(xt), x.shape)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=F32_ATOL, rtol=0)
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_grads([("x", xt.grad.permute(0, 1, 3, 4, 2).numpy(), np.asarray(gx))]
                  + _grad_pairs(tm, gp))


def test_lam_bf16_matches_flax_bf16():
    """bf16 energies near one-hot: flax's own bf16 output stands far from
    its f32 output, the port's bf16 within 2**-6 of flax's bf16."""
    shape = (2, 11, 8, 8, 16)
    x = _lam_input(shape=shape, scale=0.5)
    p = {"params": {"gamma": jnp.full((1,), GAMMA)}}
    f32 = np.asarray(jhe.LAMModule().apply(p, jnp.asarray(x)))
    b16 = np.asarray(jhe.LAMModule(dtype=jnp.bfloat16).apply(
        p, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    tm = the.LAMModule()
    tm.load_state_dict(state_dict_from_jax(p["params"], tm))
    with torch.inference_mode():
        got = _lam_flat(tm(_lam_port(x).to(torch.bfloat16)).float(), shape).numpy()
    flax_own = np.abs(b16 - f32).max()
    print(f"LAM bf16: flax bf16 vs its f32 {flax_own:.4g}, port bf16 vs flax bf16 "
          f"{np.abs(got - b16).max():.4g}, largest output {np.abs(f32).max():.4g}")
    assert flax_own > BF16_REL * np.abs(f32).max()  # the near one-hot softmax shows
    assert np.abs(got - b16).max() <= BF16_REL * np.abs(b16).max()


def test_csam_matches_flax():
    """CSAM: the 3-D kernel (3,3,3,1,1) carried to (1,1,3,3,3), the volume's
    padding on the channel axis too; output and gradients."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    jm = jhe.CSAMModule()
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = {**_gammas(params), "TConv_0": {
        "kernel": params["TConv_0"]["kernel"],
        "bias": np.full((1,), 0.2, np.float32)}}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, v: jnp.sum(jm.apply({"params": p}, v) * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))
    tm = the.CSAMModule()
    tm.load_state_dict(state_dict_from_jax(params, tm))
    assert tuple(tm.conv.weight.shape) == (1, 1, 3, 3, 3)
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt)
    np.testing.assert_allclose(_nhwc(out), want, atol=F32_ATOL, rtol=0)
    (out * _nchw(cot)).sum().backward()
    _assert_grads([("x", _nhwc(xt.grad), np.asarray(gx))] + _grad_pairs(tm, gp))


def test_shift_conv_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)  # 12 // 5 = 2: a remainder
    jm = jhe.ShiftConv(9)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = the.ShiftConv(12, 9)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, atol=F32_ATOL, rtol=0)


GMSA_CASES = {"no_shift-train": (0, True, True), "shift-train": (1, True, True),
              "shift-eval": (1, False, True), "reuse-attention": (1, True, False)}


@pytest.mark.parametrize("case", list(GMSA_CASES))
def test_gmsa_matches_flax(case):
    """GMSA: the 1x1 conv, BatchNorm (batch statistics and their update in
    train, running statistics in eval), windows of 2, 4 and 4 rolled by
    -ws/2 and back when shifted, and the attention reused from a first
    GMSA; output, attentions, statistics and gradients."""
    shifts, train, calc = GMSA_CASES[case]
    c, ws = 30, (2, 4, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, c)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    prev = None
    if not calc:
        first = jhe.GMSA(c, shifts, ws, calc_attn=True)
        v = first.init(jax.random.PRNGKey(2), jnp.asarray(x))
        _, prev = first.apply(v, jnp.asarray(x))
    jm = jhe.GMSA(c, shifts, ws, calc_attn=calc)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), prev)
    params = _np(variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.random(a.shape).astype(np.float32),
        _np(variables["batch_stats"]))

    def run(p, v):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, v, prev, train=train,
                            mutable=["batch_stats"])
        return out, mut["batch_stats"]

    (want, atns), new_stats = run(params, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, v: jnp.sum(run(p, v)[0][0] * cot), argnums=(0, 1))(
        params, jnp.asarray(x))
    tm = the.GMSA(c, shifts, ws, calc_attn=calc)
    tm.load_state_dict(state_dict_from_jax(params, tm, batch_stats=stats))
    xt = _nchw(x).requires_grad_(True)
    tprev = None if prev is None else [torch.from_numpy(np.array(a)) for a in prev]
    out, tatns = tm(xt, tprev, train=train)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=F32_ATOL, rtol=0)
    for a, b in zip(tatns, atns):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=F32_ATOL, rtol=0)
    got_stats = jax_tree_from_state_dict(tm.state_dict(), tm, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(got_stats), jax.tree_util.tree_leaves(new_stats)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-6)
    if not train:  # eval leaves the statistics as they were
        for g, w in zip(jax.tree_util.tree_leaves(got_stats), jax.tree_util.tree_leaves(stats)):
            np.testing.assert_array_equal(g, w)
    (out * _nchw(cot)).sum().backward()
    _assert_grads([("x", _nhwc(xt.grad), np.asarray(gx))] + _grad_pairs(tm, gp),
                  zero_in_exact=("['TConv_0']['bias']",) if train else ())


# -- handlers ------------------------------------------------------------------------

def _jax_stats(name, js):
    return (_np(js.extra["vars"]["batch_stats"]) if name in ("elan", "qelan") else None)


@functools.lru_cache(maxsize=None)
def _handler_pair(name, dtype="float32"):
    """The JAX handler and state (gammas 0.5, ELAN's running statistics
    moved off their init) and the port handler loaded with them."""
    kw = dict(HANDLERS[name], dtype=dtype, **SGD)
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, _gammas(_np(js.params))))
    if name in ("elan", "qelan"):
        rng = np.random.default_rng(6)
        stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.2 * rng.random(a.shape).astype(np.float32),
            _np(js.extra["vars"]["batch_stats"]))
        js = js.replace(extra={**js.extra, "vars": {"batch_stats": stats}})
    th = torch_model(name)(device="cpu", **kw)
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module,
                                                  batch_stats=_jax_stats(name, js)))
    return jh, js, th


def _batch(name, rng, h=10, w=14, n=2):
    b = {"lr": rng.random((n, h, w, 3)).astype(np.float32),
         "hr": rng.random((n, 2 * h, 2 * w, 3)).astype(np.float32)}
    if name.startswith("q"):
        b["metadata"] = rng.random((n, 1)).astype(np.float32)
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_moves(th, state_after, before, js_after):
    """Each parameter's move under SGD at lr 1 within 1e-4 of the JAX
    move plus two float32 ulps."""
    after = jax_tree_from_state_dict(state_after.params, th.module)
    largest = 0.0
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(js_after.params))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        largest = max(largest, move)
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)
    assert largest > 0


@pytest.mark.parametrize("name", list(HANDLERS))
def test_handler_eval_and_step_match_jax(name):
    """Eval on a size that is no multiple of ELAN's windows (10 x 14: the
    reflect pad to 12 x 16 and the crop back), then one train step: the
    loss, every parameter gamma included, and for ELAN the BatchNorm
    running statistics the step wrote."""
    jh, js, th = _handler_pair(name)
    state = th._own_state()
    batch = _batch(name, np.random.default_rng(7))
    want = np.asarray(jh.run_eval(js, _jnp(batch)))
    got = th.run_eval(state, batch).numpy()
    assert got.shape == (2, 20, 28, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)

    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js), _jnp(batch))
    before = jax.tree_util.tree_map(np.copy, jax_tree_from_state_dict(state.params, th.module))
    state2, tl = th.train_batch(state, batch)
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    _assert_moves(th, state2, before, js2)
    if name in ("elan", "qelan"):
        got_stats = jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats")
        want_stats = _np(js2.extra["vars"]["batch_stats"])
        moved = 0
        for g, w, b in zip(jax.tree_util.tree_leaves(got_stats), jax.tree_util.tree_leaves(want_stats),
                           jax.tree_util.tree_leaves(_jax_stats(name, js))):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
            moved += not np.array_equal(w, b)
        assert moved == len(jax.tree_util.tree_leaves(want_stats))
    # the state goes back to the JAX weights for the next test
    th.module.load_state_dict(state_dict_from_jax(_np(js.params), th.module,
                                                  batch_stats=_jax_stats(name, js)))


@pytest.mark.parametrize("name", ["han", "elan"])
def test_bf16_eval_matches_jax_bf16(name):
    jh, js, th = _handler_pair(name, "bf16")
    batch = _batch(name, np.random.default_rng(8))
    want = np.asarray(jh.run_eval(js, _jnp(batch)), np.float32)
    got = th.run_eval(th._own_state(), batch).float().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("name", ["han", "elan"])
def test_jax_written_checkpoint_evaluates_in_the_port(name, tmp_path):
    """A checkpoint the JAX package wrote (HAN: gammas in the params; ELAN:
    running statistics in extra.vars.batch_stats) loads through
    ``load_model`` and evaluates as the JAX handler does."""
    jh, js, _ = _handler_pair(name)
    jh.save_model(js, str(tmp_path / "saved_models"), epoch=0)
    th = torch_model(name)(device="cpu", **HANDLERS[name], **SGD)
    state, epoch = th.load_model(str(tmp_path / "saved_models"), "last",
                                 skip_optimizer_load=True)
    assert epoch == 0
    x = np.random.default_rng(9).random((1, 9, 11, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(state, {"lr": x}).numpy(), want, atol=F32_ATOL,
                               rtol=0)


def test_qhan_launches_the_per_image_scale_form(monkeypatch):
    """QHAN's default standard style with q-layers gives every block's
    kernel launch shared bd and bu and a per-image scale."""
    from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab
    _, _, th = _handler_pair("qhan")
    forms, real = [], rcab.rcab_fused

    def counted(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=1.0):
        forms.append((bd.dim(), bu.dim(), torch.is_tensor(res_scale) and res_scale.dim()))
        return real(x, w1, b1, w2, b2, wd, bd, wu, bu, res_scale=res_scale)

    monkeypatch.setattr(rcab, "rcab_fused", counted)
    th.run_eval(th._own_state(), _batch("qhan", np.random.default_rng(10)))
    assert forms == [(1, 1, 2)] * 2


# -- BoBW --------------------------------------------------------------------------

BOBW = {"contrastiveblindqhan": dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=2,
                                     reduction=4, **SGD),
        "contrastiveblindqelan": dict(scale=2, m_elan=2, c_elan=30, window_sizes=(2, 4, 4),
                                      **SGD)}


@functools.lru_cache(maxsize=None)
def _bobw_pair(name):
    jh = jax_model(name)(**BOBW[name])
    js = jh.init_state()
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, _gammas(_np(js.params))))
    th = torch_model(name)(device="cpu", **BOBW[name])
    full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    return jh, js, th


@pytest.mark.parametrize("name", list(BOBW))
def test_bobw_handler_matches_jax(name):
    """The pipeline's eval forward and one train step (the frozen
    encoder's batch statistics, the generator's update under SGD at lr 1)."""
    jh, js, th = _bobw_pair(name)
    state = th._own_state()
    rng = np.random.default_rng(11)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(state, {"lr": x}).numpy(), want, atol=F32_ATOL,
                               rtol=0)
    js2, jl = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                             {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    before = jax.tree_util.tree_map(
        np.copy, jax_tree_from_state_dict(state.params, th.module)["generator"])
    state2, tl = th.train_batch(state, {"lr": x, "hr": hr})
    assert abs(float(tl["train-loss"]) - float(jl["train-loss"])) <= 1e-6
    after = jax_tree_from_state_dict(state2.params, th.module)["generator"]
    for (path, w), g, b in zip(jax.tree_util.tree_flatten_with_path(_np(js2.params["generator"]))[0],
                               jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        move = np.abs(w - b).max()
        assert np.abs(g - w).max() <= F32_GRAD_REL * move + PARAM_ULPS, jax.tree_util.keystr(path)
    stats = jax_tree_from_state_dict(state2.params, th.module, collection="batch_stats")
    for g, w in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(_np(js2.extra["bstats"]))):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    th.module.load_state_dict(state_dict_from_jax(
        {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}, th.module,
        batch_stats=_np(js.extra["bstats"])))


def test_bobw_qelan_batchnorm_keeps_its_running_statistics():
    """Both pipelines call the generator without ``train``: inside
    contrastiveblindqelan, QELAN's BatchNorm normalises by its running
    statistics in a train step as in evaluation, and the step leaves them
    as they were (the encoder's move). So the pipeline's train-mode output
    is the generator's running-statistics output on the train-mode
    embedding, not its batch-statistics one."""
    jh, js, th = _bobw_pair("contrastiveblindqelan")
    rng = np.random.default_rng(12)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr = rng.random((2, 20, 24, 3)).astype(np.float32)
    js2, _ = jh.train_batch(jax.tree_util.tree_map(jnp.copy, js),
                            {"lr": jnp.asarray(x), "hr": jnp.asarray(hr)})
    gen0, gen1 = _np(js.extra["bstats"]["generator"]), _np(js2.extra["bstats"]["generator"])
    enc0, enc1 = _np(js.extra["bstats"]["encoder"]), _np(js2.extra["bstats"]["encoder"])
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(gen0),
                                                    jax.tree_util.tree_leaves(gen1)))
    assert not all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(enc0),
                                                        jax.tree_util.tree_leaves(enc1)))
    state = th._own_state()
    gen_stats = {k: v.clone() for k, v in state.params.items()
                 if k.startswith("generator.") and k.endswith(("running_mean", "running_var"))}
    state2, _ = th.train_batch(state, {"lr": x, "hr": hr})
    assert gen_stats and all(torch.equal(state2.params[k], v) for k, v in gen_stats.items())
    with torch.no_grad():
        lr = torch.from_numpy(x).permute(0, 3, 1, 2)
        emb, _ = th.module.embed(lr, train=True)
        in_step = th.module(lr, train=True)
        running = th.module.generator(lr, emb, train=False)
        batch_stats = th.module.generator(lr, emb, train=True)
    torch.testing.assert_close(in_step, running, rtol=0, atol=0)
    assert not torch.allclose(in_step, batch_stats)
    th.module.load_state_dict(state_dict_from_jax(
        {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}, th.module,
        batch_stats=_np(js.extra["bstats"])))


MODE_CASES = {"qhan-sft_mode": ("contrastiveblindqhan", "sft_mode"),
              "qhan-srmd_mode": ("contrastiveblindqhan", "srmd_mode"),
              "qelan-sft_mode": ("contrastiveblindqelan", "sft_mode"),
              "qelan-srmd_mode": ("contrastiveblindqelan", "srmd_mode")}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_bobw_modes_as_in_jax(case):
    """sft_mode hands the generator the maps as a third argument: QHAN's
    meta_maps, which it ignores without SFT layers (both packages give
    the plain forward), but QELAN's ``train``, whose truth value fails in
    both. srmd_mode feeds 3 + 256 channels: QHAN takes them, QELAN's mean
    shift of 3 channels fails in both."""
    name, mode = MODE_CASES[case]
    kw = dict(BOBW[name], **{mode: True})
    x = np.random.default_rng(13).random((1, 8, 8, 3)).astype(np.float32)
    th = torch_model(name)(device="cpu", **kw)
    if name == "contrastiveblindqelan":
        with pytest.raises((TypeError, ValueError), match="ambiguous|broadcast"):
            jax_model(name)(**kw).init_state()
        with pytest.raises(RuntimeError, match="ambiguous|size of tensor"):
            th.run_eval(th.init_state(), {"lr": x})
        return
    jh = jax_model(name)(**kw)
    js = jh.init_state()
    full = {**_np(js.params), "encoder": _np(js.extra["frozen_encoder"])}
    th.module.load_state_dict(state_dict_from_jax(full, th.module,
                                                  batch_stats=_np(js.extra["bstats"])))
    want = np.asarray(jh.run_eval(js, {"lr": jnp.asarray(x)}))
    np.testing.assert_allclose(th.run_eval(th._own_state(), {"lr": x}).numpy(), want,
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["contrastiveblindqhan", "contrastiveblindqsan"])
def test_bobw_example_trains_and_scores_with_the_generator(name, tmp_path):
    """examples/train_bobw_rcan_supmoco.toml with the model's name changed,
    at a tiny width (its n_feats, n_resgroups and n_resblocks go to QHAN or
    SAN): HR-only .npy files through its chain, the packaged encoder by
    name, validation on LR/HR pairs, then cli.eval_sisr on the saved run."""
    import os

    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "examples", "train_bobw_rcan_supmoco.toml")).as_plain()
    rng = np.random.default_rng(14)
    hr_dir, lr_dir, ehr_dir = tmp_path / "hr", tmp_path / "elr", tmp_path / "ehr"
    for d in (hr_dir, lr_dir, ehr_dir):
        os.makedirs(d)
    for k in range(2):
        np.save(hr_dir / f"h{k}.npy", rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
        hr = rng.integers(0, 256, (32, 28, 3), dtype=np.uint8)
        np.save(ehr_dir / f"e{k}.npy", hr)
        np.save(lr_dir / f"e{k}.npy", np.ascontiguousarray(hr[::4, ::4]))
    cfg["model"]["name"] = name
    cfg["experiment_save_loc"] = str(tmp_path / "Results")
    cfg["data"]["crop"] = 8
    cfg["data"]["dataloader_threads"] = 1
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": str(hr_dir)}}
    cfg["data"]["eval_sets"]["data_1"] = {"lr_dir": str(lr_dir), "hr_dir": str(ehr_dir)}
    cfg["model"]["internal_params"].update(n_feats=16, n_resgroups=1, n_resblocks=2,
                                           reduction=4, dtype="float32")
    cfg["training"].update(num_epochs=1, batch_size=2)
    dump_toml(cfg, str(tmp_path / "bobw.toml"))
    stats = train_sisr.main(["-p", str(tmp_path / "bobw.toml"), "--device", "cpu"])
    assert np.isfinite([stats[0]["train-loss"], stats[0]["val-PSNR"]]).all()
    out = tmp_path / "scores"
    eval_sisr.main(["--model_loc", str(tmp_path / "Results"), "--out_loc", str(out),
                    "--lr_dir", str(lr_dir), "--hr_dir", str(ehr_dir), "--scale", "4",
                    "-me", cfg["experiment"], "last", "--device", "cpu"])
    assert os.path.isfile(out / "individual_metrics.csv")


def test_dan_v1qelan_fails_in_both():
    """The JAX DAN handler keeps params only, so QELAN's BatchNorm finds no
    batch_stats at the first forward; the port refuses the mode when it is
    built rather than run a BatchNorm whose statistics nothing keeps."""
    kw = dict(mode="v1QELAN", scale=2, nf=16, loop=2, input_para=4, kernel_size=9,
              init_ker_map=(0.1,) * 4,
              generator_params=dict(m_elan=2, c_elan=30, window_sizes=(2, 4, 4)))
    jh = jax_model("dan")(**kw)
    js = jh.init_state()
    from flax.errors import ScopeCollectionNotFound
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        jh.run_eval(js, {"lr": jnp.zeros((1, 8, 8, 3))})
    with pytest.raises(ValueError, match="batch_stats"):
        torch_model("dan")(device="cpu", **kw)
