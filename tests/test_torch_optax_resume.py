"""A JAX-written training run resumes in the port with its optax state
(``rumpy_tpu_torch/models/base.py::_load_optax_state``), on the CPU.

The JAX handler takes two steps and saves through its own ``save_model``
(a real flax-msgpack file); the port loads it in train mode. Its torch
moments must equal JAX's ``mu`` / ``nu`` / ``trace`` leaf by leaf, bit for
bit (the weight bridge only transposes and flips), ``step`` must be the
optax count as a CPU scalar, and both packages' third step from there must
agree: each parameter within 2e-6 + 1e-3 of the lr (float32 gradients of
two frameworks differ in their last bits, and Adam scales an update to
about the lr). The multi-optimizer handlers are held by their moments and
counts after each phase; every other handler class structurally, on
zeros shaped by ``jax.eval_shape`` of its ``init_state``. A state that
does not fit raises and names the path; a minimal checkpoint starts fresh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rumpy_tpu.models.base import TrainState as JaxState
from rumpy_tpu.models.base import build_optimizer as jax_build_optimizer
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu_torch.models import base as tbase
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict

RCAN_KW = dict(scale=2, n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4, lr=1e-3)
STEP_ATOL = 2e-6
STEP_LR_RTOL = 1e-3

_SHARED = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rcan_params():
    """One small RCAN's flax params, made once a file."""
    if "params" not in _SHARED:
        _SHARED["params"] = _np(jax_model("rcan")(**RCAN_KW).init_state().params)
    return _SHARED["params"]


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((2, 8, 8, 3), dtype=np.float32),
            "hr": rng.random((2, 16, 16, 3), dtype=np.float32)}


def _leaves_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _assert_close(got, want, lr, path=""):
    if isinstance(want, dict):
        for k in want:
            _assert_close(got[k], want[k], lr, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=STEP_ATOL + STEP_LR_RTOL * lr, rtol=0, err_msg=path)


def _port_moments(th, opt, field, module=None):
    """A torch moment of ``opt`` as the flax tree of ``module`` (zeros where
    a parameter has none)."""
    module = module or th.module
    return jax_tree_from_state_dict(
        {k: opt.state[p][field] if field in opt.state.get(p, {}) else torch.zeros_like(p)
         for k, p in module.named_parameters()}, module)


def _moments(opt_state, clip):
    """The moment state of a JAX handler's optax chain, as flax serialises it."""
    return _np(serialization.to_state_dict(opt_state))["1" if clip else "0"]["0"]


# optimizer type, weight decay, clip, scheduler
VOCABULARY = [
    ("adam", 0.0, None, None),
    ("adam", 0.0, 0.05, "multi_step_lr"),
    ("adamw", 0.1, None, "multi_step_lr"),
    ("adamw", 0.1, 0.05, None),
    ("rmsprop", 0.0, 0.05, "multi_step_lr"),
    ("rmsprop", 0.0, None, None),
    ("sgd", 0.0, None, "multi_step_lr"),
    ("sgd", 0.0, 0.05, None),
]
# the schedule halves the lr at the third step: a resumed schedule position
# that is off changes the step
SCHEDULE = {"milestones": [2], "gamma": 0.5}
TORCH_FIELDS = {"adam": ("exp_avg", "exp_avg_sq"), "adamw": ("exp_avg", "exp_avg_sq"),
                "rmsprop": ("square_avg",), "sgd": ("momentum_buffer",)}
OPTAX_FIELDS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "rmsprop": ("nu",),
                "sgd": ("trace",)}


@pytest.mark.parametrize("kind,wd,clip,sched", VOCABULARY,
                         ids=[f"{k}-wd{w}-clip{c}-{s}" for k, w, c, s in VOCABULARY])
def test_the_optimizer_vocabulary_resumes(kind, wd, clip, sched, tmp_path, monkeypatch):
    kw = dict(RCAN_KW, optimizer_type=kind, grad_clip=clip, scheduler=sched,
              scheduler_params=SCHEDULE if sched else None)
    jh = jax_model("rcan")(**kw)
    # the handlers take no weight decay; an AdamW with one on both sides
    jh.tx = jax_build_optimizer(kw["lr"], kind, sched, kw["scheduler_params"], clip,
                                weight_decay=wd)
    jh._rejit()
    params = _rcan_params()
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(
        jnp.asarray, params), opt_state=jh.tx.init(params), extra={},
        rng=jax.random.PRNGKey(0))
    for s in range(2):
        state, _ = jh.train_batch(state, {k: jnp.asarray(v) for k, v in _batch(s).items()})
    jh.save_model(state, str(tmp_path), 2)

    monkeypatch.setattr(tbase, "build_optimizer",
                        functools.partial(tbase.build_optimizer, weight_decay=wd))
    th = torch_model("rcan")(device="cpu", **kw)
    ts, epoch = th.load_model(str(tmp_path), 2)
    assert (epoch, ts.step) == (2, 2)
    opt = th.optimizer()
    chain = _moments(state.opt_state, clip)
    for optax_field, torch_field in zip(OPTAX_FIELDS[kind], TORCH_FIELDS[kind]):
        _leaves_equal(_port_moments(th, opt, torch_field), chain[optax_field], optax_field)
    for p in th.module.parameters():
        st = opt.state[p]
        for torch_field in TORCH_FIELDS[kind]:
            assert st[torch_field].stride() == p.stride()
        if kind != "sgd":
            assert st["step"].device.type == "cpu" and st["step"].dtype == torch.float32
            assert float(st["step"]) == 2

    b = _batch(2)
    state3, jl = jh.train_batch(state, {k: jnp.asarray(v) for k, v in b.items()})
    ts3, tl = th.train_batch(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl["train-loss"]), float(jl["train-loss"]), rtol=1e-5)
    _assert_close(jax_tree_from_state_dict(ts3.params, th.module), _np(state3.params),
                  kw["lr"])


# -- every handler: a JAX state of the real layout, filled from a seed -------------

# small configurations of every registered model (the existing tests' sizes)
SMALL = {
    "rcan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "qrcan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "edsr": dict(num_features=16, num_blocks=2), "qedsr": dict(num_features=16, num_blocks=2),
    "edsrmd": dict(num_features=16, num_blocks=2), "srmd": dict(nc=16, nb=2),
    "srcnn": {}, "vdsr": {},
    "moco": dict(K=8, dim=32), "supmoco": dict(K=8, dim=32, positives_per_class=1, num_classes=4),
    "weakcon": dict(K=8, dim=32, positives_per_class=1, vector_size=6), "supcon": dict(dim=32),
    "degradationregressor": dict(num_targets=5),
    "han": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "qhan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "elan": dict(c_elan=16, m_elan=2), "qelan": dict(c_elan=16, m_elan=2),
    "san": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "qsan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "contrastiveblindqrcan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4,
                                  block_encoder_loading=True),
    "contrastiveblindqedsr": dict(num_features=16, num_blocks=2, block_encoder_loading=True),
    "contrastiveblindqhan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4,
                                 block_encoder_loading=True),
    "contrastiveblindqelan": dict(c_elan=16, m_elan=2, block_encoder_loading=True),
    "contrastiveblindqsan": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4,
                                 block_encoder_loading=True),
    "contrastiveblindqrealesrgan": dict(nf=8, nb=1, gc=4, block_encoder_loading=True),
    "contrastiveblindmetabed": dict(block_encoder_loading=True),
    "esrgan": dict(nf=8, nb=1, gc=4, d_nf=4, pretrain_epochs=1),
    "bsrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
    "realesrgan": dict(nf=8, nb=1, gc=4, d_nf=4, pretrain_epochs=1),
    "qrealesrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
    # DAN's default kernel map is fit from 2,000 random kernels: given here
    "dan": dict(nf=16, nb=2, loop=1, init_ker_map=tuple(np.linspace(-1, 1, 10))),
    "danv1qrealesrgan": dict(nf=8, nb=1, gc=4, d_nf=4, loop=1,
                             init_ker_map=tuple(np.linspace(-1, 1, 10))),
    "dasr": dict(n_groups=1, n_blocks=1, n_feats=16, contrastive_K=8), "dcls": {},
    "facesrattributesgan": dict(n_feats=4, pretrain_epochs=1), "agagan": dict(n_feats=4),
    "fmfnet": dict(n_feats=8),
    "dic": dict(num_steps=2, num_features=8, num_groups=1, hg_num_feature=16,
                num_fusion_block=1),
    "dicnet": dict(num_steps=2, num_features=8, num_groups=1, hg_num_feature=16,
                   num_fusion_block=1),
    "sparnet": dict(min_ch=8, max_ch=16, in_size=32, out_size=32, min_feat_size=16,
                    res_depth=1),
    "qsparnet": dict(min_ch=8, max_ch=16, in_size=32, out_size=32, min_feat_size=16,
                     res_depth=1),
    "rcansplitceleb": dict(n_feats=16, n_resgroups=1, n_resblocks=2, reduction=4),
    "facegan": dict(latent_dim=8, nf=8),
    "esrganfs": dict(nf=8, nb=1, gc=4, d_nf=4, pretrain_epochs=1),
    "fssr": dict(nf=8, nb=1, gc=4, d_nf=4), "fssrdsgan": dict(n_res_blocks=2,
                                                              use_perceptual_loss=False),
    "sftmd": dict(num_features=16, num_blocks=1),
    "ikc": dict(num_features=16, num_blocks=1, code_length=10),
    "metabed": {}, "metabedesrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
    "basicnn": {}, "resnet": {}, "manet": {},
    "efficientnet": dict(width_mult=0.25, depth_mult=0.25),
    "densenet": dict(block_config=(1, 1, 1, 1), growth_rate=8, init_features=8),
    "swinir": dict(embed_dim=16, depths=[2], num_heads=[2]),
    "waveletsrnet": dict(num_layers_res=1, wavelet_c=2),
    "waveletnet": dict(num_layers_res=1, wavelet_c=2),
    "waveletsrgan": dict(num_layers_res=1, wavelet_c=2, include_id_loss=False),
}


def _filled_state(jh, counts, seed):
    """The JAX handler's ``TrainState`` as ``jax.eval_shape`` of its
    ``init_state`` gives it (no flax compute), filled from a numpy seed:
    params and moments small normals, second moments and BatchNorm
    variances positive, every optax count of optimizer ``name`` at
    ``counts(name)`` (name None for a single chain). The optax state comes
    back in flax's dict layout."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if not np.issubdtype(s.dtype, np.floating):
            return np.zeros(s.shape, s.dtype)
        a = (0.05 * rng.standard_normal(s.shape)).astype(s.dtype)
        name = jax.tree_util.keystr(path)
        return np.abs(a) + 0.01 if "'nu'" in name or "'var'" in name or ".nu" in name else a

    js = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jh.init_state))
    opt = serialization.to_state_dict(js.opt_state)

    def set_counts(tree, count):
        return {k: (np.asarray(count, np.int32) if k == "count" else set_counts(v, count))
                for k, v in tree.items()} if isinstance(tree, dict) else tree

    opt = (set_counts(opt, counts(None)) if next(iter(opt)).isdigit()
           else {k: set_counts(v, counts(k)) for k, v in opt.items()})
    return js.replace(step=np.asarray(7, np.int32), opt_state=opt)


def _saved(name, kw, counts, tmp_path, seed=0, through_file=True):
    """A filled JAX state of handler ``name``, and the port's handler after
    a train-mode load of it: through the JAX package's ``save_model`` and
    the port's ``load_model``, or (``through_file=False``) straight from the
    numpy trees that the port's reader would return."""
    jh = jax_model(name)(**kw)
    js = _filled_state(jh, counts, seed)
    th = torch_model(name)(device="cpu", **kw)
    if through_file:
        jh.save_model(js, str(tmp_path), 1)
        return jh, js, th, th.load_model(str(tmp_path), 1)[0]
    loaded = {"network": js.params, "optimizer": js.opt_state, "extra": js.extra,
              "step": js.step}
    return jh, js, th, th._load_jax_checkpoint(loaded, "trees", False)


# -- the multi-optimizer handlers: moments leaf by leaf, counts, the next update -----

def _by_name(module):
    return lambda th, tree: {None: getattr(th.module, module)}


def _by_key(th, tree):
    return {k: getattr(th.module, k) for k in tree}


# handler, config, each optimizer's JAX transform by its name in opt_state (None:
# the one chain), its count, the port modules its tree splits into
MULTI = {
    "realesrgan-at-the-switch": (
        "realesrgan", dict(SMALL["realesrgan"], lr=1e-3, main_scheduler="multi_step_lr",
                           main_scheduler_params={"milestones": [1], "gamma": 0.5}),
        {"generator_pre": ("tx", 3), "generator": ("main_tx", 0),
         "discriminator": ("d_tx", 0)}, None),
    "realesrgan-adversarial": (
        "realesrgan", dict(SMALL["realesrgan"], lr=1e-3, main_scheduler="multi_step_lr",
                           main_scheduler_params={"milestones": [1], "gamma": 0.5}),
        {"generator_pre": ("tx", 3), "generator": ("main_tx", 2),
         "discriminator": ("d_tx", 2)}, None),
    "facegan": ("facegan", dict(SMALL["facegan"], lr=1e-3, discriminator_lr=2e-3),
                {"generator": ("tx", 2), "discriminator": ("d_tx", 3)}, None),
    "ikc": ("ikc", dict(SMALL["ikc"], lr=1e-3),
            {k: (k, c) for k, c in (("sr_model", 3), ("predictor", 2), ("corrector", 2))},
            None),
    "bobw-frozen": ("contrastiveblindqrcan", dict(SMALL["contrastiveblindqrcan"], lr=1e-3),
                    {None: ("tx", 3)}, _by_key),
    "bobw-joint": ("contrastiveblindqrcan", dict(
        scale=2, n_feats=16, n_resgroups=1, n_resblocks=1, contrastive_K=8, encoder_dim=64,
        block_encoder_loading=True, combined_loss_mode="moco", crop_count=2, lr=1e-3),
        {None: ("tx", 3)}, _by_key),
    "supmoco": ("supmoco", dict(SMALL["supmoco"], lr=1e-3), {None: ("tx", 3)},
                _by_name("encoder")),
}


def _jax_tx(jh, attr, key):
    return jh.child_tx[key] if attr == key else getattr(jh, attr)


@pytest.mark.parametrize("case", sorted(MULTI))
def test_multi_optimizer_handlers_resume(case, tmp_path):
    """Each optimizer's torch moments equal the JAX ones leaf by leaf, its
    ``step`` and the handler's schedule position are the optax count, and
    its next update from the same gradients is optax's."""
    name, kw, txs, split = MULTI[case]
    jh, js, th, _ = _saved(name, kw, lambda key: txs[key][1], tmp_path)
    targets = th.optax_targets()
    rng = np.random.default_rng(5)
    loaded = {k: v.clone() for k, v in th.module.state_dict().items()}
    for key, (attr, count) in txs.items():
        th.module.load_state_dict(loaded)  # optimizers sharing parameters update them
        target = targets[key]
        opt = target.optimizer()
        tree = js.opt_state if key is None else js.opt_state[key]
        moments = tree["0"]["0"]
        params = js.params if target.part is None else js.params[target.part]
        modules = (split or _by_name(target.part))(th, moments["mu"])
        if None in modules:
            moments = {f: {None: t} for f, t in moments.items() if f != "count"}
            params = {None: params}
        for sub, module in modules.items():
            for optax_field, torch_field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                _leaves_equal(_port_moments(th, opt, torch_field, module),
                              moments[optax_field][sub], f"{case}/{key}/{optax_field}/{sub}")
        assert {float(opt.state[p]["step"]) for g in opt.param_groups for p in g["params"]
                if p.requires_grad} == {count}
        if target.name is not None:
            assert th._opt_counts[target.name] == count
            for group in opt.param_groups:  # the lr of the port's schedule position
                group["lr"] = th._schedules[target.name](th._opt_counts[target.name])

        # the next update from the same gradients
        grads = jax.tree_util.tree_map(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), params)
        tx = _jax_tx(jh, attr, key)
        typed = serialization.from_state_dict(tx.init(js.params if target.part is None
                                                      else js.params[target.part]), tree)
        flat = (lambda t: t[None]) if None in modules else (lambda t: t)
        updates, _ = tx.update(flat(grads), typed, flat(params))
        want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), flat(params), updates)
        want = {None: want} if None in modules else want
        opt.zero_grad(set_to_none=True)
        for sub, module in modules.items():
            g = _bridge(grads[sub], module)
            for k, p in module.named_parameters():
                if p.requires_grad:
                    p.grad = g[k]
        opt.step()
        for sub, module in modules.items():
            _assert_close(jax_tree_from_state_dict(module.state_dict(), module), want[sub],
                          0.0, f"{case}/{key}/{sub}")


def _bridge(tree, module):
    from rumpy_tpu_torch.utils.weights import state_dict_from_jax
    return state_dict_from_jax(tree, module)


# -- a state that does not fit -----------------------------------------------------

def _add_leaf(js):
    opt = dict(js.opt_state)
    mu = dict(opt["0"]["0"]["mu"])
    mu["Conv_9"] = {"kernel": np.zeros((3, 3, 16, 16), np.float32)}
    opt["0"] = {**opt["0"], "0": {**opt["0"]["0"], "mu": mu}}
    return js.replace(opt_state=opt)


MISFITS = {
    # adam state for an sgd handler
    "optimizer type": (dict(optimizer_type="sgd"), lambda js: js,
                       r"optimizer/0/0: sgd expects \['trace'\], the checkpoint holds "
                       r"\['count', 'mu', 'nu'\]"),
    # the checkpoint clips, the handler does not
    "clip": ({}, lambda js: js.replace(opt_state={"0": {}, "1": js.opt_state["0"]}),
             r"optimizer: the handler's chain \(adam\) has entries \['0'\], "
             r"the checkpoint \['0', '1'\]"),
    # a moment leaf the bridge leaves unused
    "leaf": ({}, _add_leaf, r"optimizer/0/0/mu\|nu does not fit .*Conv_9/kernel"),
}


@pytest.mark.parametrize("case", sorted(MISFITS))
def test_a_state_that_does_not_fit_raises_and_names_the_path(case, tmp_path):
    over, edit, message = MISFITS[case]
    jh = jax_model("rcan")(**RCAN_KW)
    js = edit(_filled_state(jh, lambda key: 2, 0))
    jh.save_model(js, str(tmp_path), 1)
    th = torch_model("rcan")(device="cpu", **dict(RCAN_KW, **over))
    with pytest.raises(ValueError, match=message):
        th.load_model(str(tmp_path), 1)


@pytest.mark.parametrize("minimal", [True, False], ids=["minimal", "skipped"])
def test_a_minimal_or_skipped_optimizer_state_starts_fresh(minimal, tmp_path):
    jh = jax_model("rcan")(**RCAN_KW)
    jh.save_model(_filled_state(jh, lambda key: 2, 0), str(tmp_path), 1, minimal=minimal)
    th = torch_model("rcan")(device="cpu", optimizer_type="sgd", **RCAN_KW)
    state, _ = th.load_model(str(tmp_path), 1, skip_optimizer_load=not minimal)
    assert state.step == 7 and not th.optimizer().state


