"""The port's ``utils/torch_convert.py`` on the CPU against the JAX
package's ``rumpy_tpu/utils/torch_convert.py``.

A small RCAN's seeded torch-layout state dict (conv weights OIHW, in the
registration order the reference and both packages share) goes through the
JAX converter and the JAX forward, and through the port's converter and the
port's forward: the converted trees leaf for leaf bit for bit, the forwards
within 1e-5 (float32; the port's RCAB blocks in their plain version on the
CPU). ``load_reference_checkpoint`` reads ``{"network": ...}`` and bare
state dicts. A state dict that does not fit raises the JAX converter's
``ValueError`` word for word, and a tree whose leaf dicts are key-sorted (as
one that crossed a ``jax.jit``) converts as the tree in creation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.utils import torch_convert as jtc
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils import torch_convert as ttc
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

RCAN = dict(scale=2, n_feats=8, n_resgroups=2, n_resblocks=2, reduction=4)
F32_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """The JAX handler and state, the port handler, and a seeded
    torch-layout state dict in registration order."""
    jh = jax_model("rcan")(**RCAN)
    js = jh.init_state()
    th = torch_model("rcan")(device="cpu", **RCAN)
    th.init_state()
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
          for k, v in th.module.state_dict().items()}
    return jh, js, th, sd


def _flat(tree):
    return dict(jtc._flatten_with_paths(tree))


def _leaf_sorted(tree):
    """``tree`` with every leaf dict's keys sorted (bias first), the other
    dicts in their order (``jax.tree_util.tree_map`` would sort them all)."""
    if not isinstance(tree, dict):
        return np.asarray(tree)
    leafy = all(not isinstance(v, dict) for v in tree.values())
    keys = sorted(tree) if leafy else list(tree)
    return {k: _leaf_sorted(tree[k]) for k in keys}


def test_convert_by_order_matches_jax(pair):
    """The port's tree (from its module's template) against the JAX
    converter's on the flax params: the same paths in the same order, each
    leaf bit for bit, in the flax layout."""
    _, js, th, sd = pair
    want = _flat(jtc.convert_by_order(sd, js.params))
    got = _flat(ttc.convert_by_order(sd, th.module))
    assert list(got) == list(want) and len(got) == len(sd)
    for path, w in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=str(path))
    head = got[("Conv_0", "TConv_0", "kernel")]
    np.testing.assert_array_equal(head, sd["head.weight"].numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("payload", ["network", "bare"])
def test_loaded_checkpoint_runs_as_jax(pair, tmp_path, payload):
    """``load_reference_checkpoint`` in both packages on the same file:
    the port's module holds the converted weights on its device, and its
    forward matches the JAX forward of the JAX state."""
    jh, js, th, sd = pair
    path = tmp_path / "train_model_3"
    torch.save({"network": sd, "epoch": 3} if payload == "network" else sd, path)
    js2 = jtc.load_reference_checkpoint(str(path), jh, js)
    state = ttc.load_reference_checkpoint(str(path), th)
    assert state.step == 0
    np.testing.assert_array_equal(th.module.head.weight.detach().numpy(), sd["head.weight"])
    x = np.random.default_rng(1).random((1, 12, 10, 3)).astype(np.float32)
    want = np.asarray(jh.run_eval(js2, {"lr": jnp.asarray(x)}))
    got = th.run_eval(state, {"lr": x}).numpy()
    assert got.shape == want.shape == (1, 24, 20, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def _misfits(sd):
    wrong = dict(sd)
    wrong["head.bias"] = torch.zeros(9)
    fewer = dict(list(sd.items())[:-1])
    more = dict(sd, **{"extra.weight": torch.zeros(3), "extra.bias": torch.zeros(3)})
    return {"shape": wrong, "fewer": fewer, "more": more}


@pytest.mark.parametrize("case", ["shape", "fewer", "more"])
def test_misfits_raise_as_in_jax(pair, case):
    """A shape mismatch, a template leaf with no tensor left and tensors
    left over raise the same ValueError in both packages."""
    _, js, th, sd = pair
    bad = _misfits(sd)[case]
    with pytest.raises(ValueError) as want:
        jtc.convert_by_order(bad, js.params)
    with pytest.raises(ValueError) as got:
        ttc.convert_by_order(bad, th.module)
    assert str(got.value) == str(want.value)
    assert {"shape": "shape mismatch at", "fewer": "ran out of torch params",
            "more": "2 torch params unused"}[case] in str(got.value)


def test_key_sorted_leaves_convert_as_in_creation_order(pair, monkeypatch):
    """Leaf dicts with ``bias`` before ``kernel`` (a tree that crossed a
    ``jax.jit``) give the same tree in both packages, the port's template
    made key-sorted in the same way."""
    _, js, th, sd = pair
    plain = _flat(ttc.convert_by_order(sd, th.module))
    sorted_params = _leaf_sorted(js.params)
    assert list(sorted_params["Conv_0"]["TConv_0"]) == ["bias", "kernel"]
    want = _flat(jtc.convert_by_order(sd, sorted_params))
    template = ttc.jax_tree_from_state_dict
    monkeypatch.setattr(ttc, "jax_tree_from_state_dict",
                        lambda state, module: _leaf_sorted(template(state, module)))
    got = _flat(ttc.convert_by_order(sd, th.module))
    assert set(got) == set(want) == set(plain)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=str(path))
        np.testing.assert_array_equal(got[path], plain[path], err_msg=str(path))
