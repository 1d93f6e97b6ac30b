"""The port's pure-Python flax-msgpack reader (rumpy_tpu_torch/utils/
flax_msgpack.py) against ``flax.serialization.msgpack_restore``: every leaf
bit for bit, ``meta_json`` equal, with ``msgpack`` made unimportable while
the port reads. Then JAX-written checkpoints through the port's
``load_checkpoint`` and ``BaseHandler.load_model``."""

import glob
import os
import sys

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from rumpy_tpu.registry import get_model as jax_get_model
from rumpy_tpu_torch.registry import get_model
from rumpy_tpu_torch.utils import checkpoint as ckpt
from rumpy_tpu_torch.utils import flax_msgpack as fm
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGED = sorted(glob.glob(os.path.join(ROOT, "rumpy_tpu", "pretrained", "*",
                                         "saved_models", "train_model_*")))
TINY_RCAN = dict(scale=4, n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4)


@pytest.fixture
def no_msgpack(monkeypatch):
    """``import msgpack`` fails while the port reads, as on the card."""
    monkeypatch.setitem(sys.modules, "msgpack", None)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _bits(x):
    if torch.is_tensor(x):  # bfloat16
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    if str(getattr(x, "dtype", "")) == "bfloat16":
        return "bfloat16", tuple(x.shape), np.asarray(x).view(np.int16).tobytes()
    return str(x.dtype), tuple(np.shape(x)), np.asarray(x).tobytes()


def assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert list(g) == list(w), "paths differ (or their order)"
    for path, ref in w.items():
        val = g[path]
        if isinstance(ref, (np.ndarray, np.generic)) or hasattr(ref, "dtype"):
            if isinstance(ref, np.generic) and str(ref.dtype) != "bfloat16":
                assert type(val) is type(ref), path
            assert _bits(val) == _bits(ref), path
            if isinstance(val, np.ndarray):
                assert val.flags.writeable, path
        else:
            assert type(val) is type(ref) and val == ref, path


@pytest.mark.parametrize("path", PACKAGED, ids=[os.path.relpath(p, ROOT) for p in PACKAGED])
def test_packaged_encoders_bit_for_bit(path, no_msgpack):
    with open(path, "rb") as f:
        data = f.read()
    got = fm.msgpack_restore(data)
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "msgpack", msgpack)
        want = serialization.msgpack_restore(data)
    assert_same_tree(got, want)
    assert got["meta_json"] == want["meta_json"]
    n = len(list(_leaves(want["arrays"])))
    assert n > 50
    queue = got["arrays"]["extra"]["queue"]
    assert queue.shape == (8192, 256) and queue.dtype == np.float32
    assert ckpt.checkpoint_format(path) == "flax"
    payload = ckpt.load_checkpoint(path)
    assert payload["model_name"] == "supmoco" and "network" in payload


def test_packaged_names_resolve():
    assert len(PACKAGED) == 3
    for name in ("supmoco_heldout_d256", "supmoco_fullchain_d256"):
        d = ckpt.resolve_packaged(name)
        assert ckpt.available_epochs(d) and d.endswith(os.path.join(name, "saved_models"))
    with pytest.raises(RuntimeError, match="not available"):
        ckpt.resolve_packaged("no_such_network")


@pytest.mark.parametrize("minimal", [False, True])
def test_jax_rcan_checkpoint(tmp_path, minimal, no_msgpack):
    """A tiny RCAN saved by the JAX package's save_model reads bit for bit;
    the port's handler loads its weights through the weight bridge."""
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "msgpack", msgpack)
        jh = jax_get_model("rcan")(**TINY_RCAN)
        state = jh.init_state(seed=3)
        state = state.replace(step=jnp.asarray(7, jnp.int32))
        path = jh.save_model(state, str(tmp_path), epoch=2, minimal=minimal)
        with open(path, "rb") as f:
            want = serialization.msgpack_restore(f.read())
    with open(path, "rb") as f:
        got = fm.msgpack_restore(f.read())
    assert_same_tree(got, want)
    assert ("optimizer" in got["arrays"]) == (not minimal)

    th = get_model("rcan")(device="cpu", **TINY_RCAN)
    loaded, epoch = th.load_model(str(tmp_path), "last", skip_optimizer_load=True)
    assert epoch == 2 and loaded.step == int(np.asarray(state.step))
    tree = jax_tree_from_state_dict(loaded.params, th.module)
    ref = {k: np.asarray(v) for k, v in _leaves(jh_params_plain(state.params))}
    for p, v in _leaves(tree):
        np.testing.assert_array_equal(v, ref[p])
    # train mode: the optax state onto the torch Adam (a minimal save has none)
    th.load_model(str(tmp_path), "last")
    opt = th.optimizer()
    assert all((p in opt.state) == (not minimal) for p in th.module.parameters())


def jh_params_plain(params):
    """A flax param tree (FrozenDict or dict) as nested plain dicts."""
    return {k: jh_params_plain(v) if hasattr(v, "items") else v for k, v in params.items()}


def _tree_of_every_leaf_kind():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.standard_normal((5, 2)), jnp.bfloat16),
        "bf16_scalar": np.asarray(jnp.asarray(1.5, jnp.bfloat16))[()],
        "f16": rng.standard_normal(7).astype(np.float16),
        "f64": rng.standard_normal((2, 2, 2)),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "i32": np.asarray(-(2 ** 31), np.int32),       # 0-d array
        "i64": np.arange(3, dtype=np.int64) * (2 ** 40),
        "u8": np.arange(250, 256, dtype=np.uint8),
        "u32": np.asarray([2 ** 32 - 1, 0], np.uint32),
        "u64": np.asarray([2 ** 64 - 1], np.uint64),
        "bool": np.asarray([True, False, True]),
        "c64": (rng.standard_normal(3) + 1j).astype(np.complex64),
        "scalars": {"np_f32": np.float32(2.5), "np_i64": np.int64(-9), "np_u16": np.uint16(7)},
        "empty": {},
        "nested": {"a": {"b": {}}, "c": np.zeros((0, 3), np.float32)},
        "python": {"int": 5, "neg": -40, "big": 2 ** 62, "float": 0.1, "none": None,
                   "true": True, "str": "héllo", "complex": 1 + 2j, "list": [1, "two", 3.0]},
    }


def test_trees_with_every_leaf_kind(no_msgpack):
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "msgpack", msgpack)
        data = serialization.msgpack_serialize(_tree_of_every_leaf_kind())
        want = serialization.msgpack_restore(data)
    got = fm.msgpack_restore(data)
    assert_same_tree(got, want)
    assert got["bf16"].dtype == torch.bfloat16
    assert got["empty"] == {} and got["nested"]["a"] == {"b": {}}


def test_chunked_leaves_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((9, 7)).astype(np.float32),
            "inner": {"big16": jnp.asarray(rng.standard_normal(100), jnp.bfloat16),
                      "small": np.arange(4, dtype=np.int32)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = fm.msgpack_restore(data)
    assert_same_tree(got, want)
    assert got["big"].shape == (9, 7) and got["inner"]["big16"].shape == (100,)
    top = serialization.msgpack_serialize(rng.standard_normal((40,)).astype(np.float32))
    assert _bits(fm.msgpack_restore(top)) == _bits(serialization.msgpack_restore(top))


VALUES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)],
    "floats": [0.0, -1.5, 1e300, float("inf")],
    "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536, "ü€"],
    "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
    "arrays": [[], list(range(15)), list(range(16)), list(range(65536))],
    "maps": [{}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): None for i in range(65536)}],
    "consts": [None, True, False],
}


@pytest.mark.parametrize("kind", list(VALUES))
def test_every_msgpack_type(kind):
    for single in (False, True):
        data = msgpack.packb(VALUES[kind], use_bin_type=True, use_single_float=single)
        assert fm.unpackb(data) == msgpack.unpackb(data, raw=False)
        assert fm.unpackb(data, raw=True) == msgpack.unpackb(data, raw=True)


def test_ext_types_of_every_width():
    payloads = [b"a", b"ab", b"abcd", b"a" * 8, b"a" * 16, b"a" * 3, b"a" * 300,
                b"a" * 70000]
    data = msgpack.packb([msgpack.ExtType(42, p) for p in payloads])
    got = fm.unpackb(data)
    assert [(e.code, e.data) for e in got] == [(42, p) for p in payloads]
    with pytest.raises(fm.MsgpackError, match="truncated"):
        fm.unpackb(data[:-1])
    with pytest.raises(fm.MsgpackError, match="after"):
        fm.unpackb(data + b"\x00")
    with pytest.raises(fm.MsgpackError, match="0xc1"):
        fm.unpackb(b"\xc1")


def test_format_detection(tmp_path):
    torch.save({"a": torch.zeros(2)}, tmp_path / "t")
    (tmp_path / "f").write_bytes(serialization.msgpack_serialize({"a": np.zeros(2)}))
    (tmp_path / "x").write_bytes(b"\x00\x01junk")
    assert ckpt.checkpoint_format(str(tmp_path / "t")) == "torch"
    assert ckpt.checkpoint_format(str(tmp_path / "f")) == "flax"
    with pytest.raises(ValueError, match="neither"):
        ckpt.checkpoint_format(str(tmp_path / "x"))
