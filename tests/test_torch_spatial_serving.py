"""The port's spatial sharding (``rumpy_tpu_torch/parallel/spatial.py``) and
mesh predictor (``serving.py``'s ``mesh``) on the CPU, over gloo groups of
2 and 4 rank processes, against the JAX package on its 8-device CPU mesh
(``tests/conftest.py``) and the port in one process.

``spatial_sharded_forward`` is held to the JAX docstring's contract,
``crop(forward(reflect_pad(image, halo)))`` when ``halo`` covers the
network's receptive radius, as ``tests/test_sharding.py`` holds the JAX
function: a two-conv x2 network (radius 2, halo 4) at H 64 and one conv
(radius 1, halo 2) at the non-divisible H 61, the contract computed by the
JAX functions, and the JAX ``spatial_sharded_forward`` itself; and a
64-feature RCAN without residual groups (its convolutions alone: head,
body conv, x4 upsampler, tail; radius 3 input rows, halo 4) against the
port's own contract. ``halo_exchange``'s strips are the reflect-padded
image's rows. RCAN's channel attention pools over the whole strip, which no
halo makes exact (``chip_smoke.py`` records the seams of the full RCAN).

The mesh predictor (``tests/test_serving.py``): equal-size requests in one
bucket, mixed sizes and a metadata-conditioned QRCAN (the padded rows'
metadata repeat the last), each rank's outputs against the one-process
predictor and the JAX mesh predictor from the same weights.

Tolerances: 2e-5 absolute (``test_sharding.py``'s) against JAX, the port
against itself 1e-6 (the same convolutions on fewer rows).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from rumpy_tpu.models.base import TrainState
from rumpy_tpu.models.common import pixel_shuffle as jax_pixel_shuffle
from rumpy_tpu.parallel.mesh import get_mesh as jax_mesh
from rumpy_tpu.parallel.spatial import spatial_sharded_forward as jax_spatial
from rumpy_tpu.registry import get_model as jax_model
from rumpy_tpu.serving import BatchedPredictor as JaxPredictor
from rumpy_tpu_torch.registry import get_model as torch_model
from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict

WORLDS = (2, 4)
JAX_ATOL = 2e-5
PORT_ATOL = 1e-6
RCAN_BODYLESS = dict(scale=4, n_feats=64, n_resgroups=0, n_resblocks=0)
EDSR = dict(scale=2, num_features=8, num_blocks=1)
QRCAN = dict(scale=2, metadata=["qpi"], n_feats=8, n_resgroups=1, n_resblocks=1)


def _jax_conv_forward(kernels, scale):
    def forward(x):
        y = x
        for i, k in enumerate(kernels):
            y = jax.lax.conv_general_dilated(y, jnp.asarray(k), (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
            if i < len(kernels) - 1:
                y = jax.nn.relu(y)
        return jax_pixel_shuffle(y, scale) if scale > 1 else y
    return forward


def _contract(forward, img, halo, scale, world):
    """``crop(forward(reflect_pad(image, halo)))`` with H first reflect-padded
    to a multiple of ``world``, as the sharded function pads it."""
    h = img.shape[1]
    pimg = np.pad(img, ((0, 0), (0, (-h) % world), (0, 0), (0, 0)), mode="reflect")
    padded = np.pad(pimg, ((0, 0), (halo, halo), (0, 0), (0, 0)), mode="reflect")
    out = np.asarray(forward(padded))
    return out[:, halo * scale:out.shape[1] - halo * scale][:, :h * scale]


def _specs():
    rng = np.random.default_rng(0)
    conv2 = [(rng.standard_normal((3, 3, 3, 8)) * 0.1).astype(np.float32),
             (rng.standard_normal((3, 3, 8, 12)) * 0.1).astype(np.float32)]
    rng1 = np.random.default_rng(1)
    conv1 = [(rng1.standard_normal((3, 3, 3, 3)) * 0.2).astype(np.float32)]
    specs = {
        "h64": dict(case="spatial", net="convs", kernels=conv2, scale=2, halo=4,
                    image=np.asarray(rng.random((1, 64, 16, 3)), np.float32)),
        "h61": dict(case="spatial", net="convs", kernels=conv1, scale=1, halo=2,
                    image=np.asarray(rng1.random((2, 61, 8, 3)), np.float32)),
        "rcan": dict(case="spatial", net="rcan", model="rcan", kwargs=RCAN_BODYLESS, scale=4,
                     halo=4, image=np.random.default_rng(2).random((1, 37, 20, 3),
                                                                   ).astype(np.float32)),
    }
    rng = np.random.default_rng(42)
    specs["same_size"] = dict(case="serving", model="edsr", kwargs=EDSR, pad_multiple=16,
                              max_batch=16,
                              images=[rng.random((16, 16, 3)).astype(np.float32)
                                      for _ in range(5)])
    specs["mixed_sizes"] = dict(case="serving", model="edsr", kwargs=EDSR, pad_multiple=16,
                                max_batch=4,
                                images=[rng.random(s).astype(np.float32) for s in
                                        ((13, 17, 3), (16, 16, 3), (33, 20, 3), (14, 9, 3),
                                         (30, 31, 3))])
    specs["metadata"] = dict(case="serving", model="qrcan", kwargs=QRCAN, pad_multiple=8,
                             max_batch=4,
                             images=[rng.random((8, 8, 3)).astype(np.float32)
                                     for _ in range(3)],
                             metadata=[np.asarray([v], np.float32) for v in (0.3, 0.9, 0.6)])
    return specs


def _jax_predictions(spec):
    """The JAX mesh predictor over the 8 devices from the port's weights."""
    th = torch_model(spec["model"])(device="cpu", **spec["kwargs"])
    th.init_state(seed=0)
    jh = jax_model(spec["model"])(**spec["kwargs"])
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(
        th.module.state_dict(), th.module))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=None,
                       extra={}, rng=jax.random.PRNGKey(0))
    pred = JaxPredictor(jh, state, mesh=jax_mesh(), pad_multiple=spec["pad_multiple"],
                        max_batch=spec["max_batch"])
    return pred.predict(spec["images"], metadata=spec.get("metadata"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2- and 4-rank worlds' results (one spawn of 4 ranks, cut into two
    groups of 2 for the 2-rank world; rank 0 also runs the one-process
    predictor) and the JAX side, computed meanwhile."""
    tmp = str(tmp_path_factory.mktemp("spatial_serving"))
    specs = _specs()
    by_size = {w: dict(specs) for w in WORLDS}
    by_size[1] = {k: dict(v, first_group=True) for k, v in specs.items()
                  if v["case"] == "serving"}
    out = os.path.join(tmp, "ranks")
    ctx = worker.start_world(max(WORLDS), by_size, out)
    jax_side = {"predict": {k: _jax_predictions(v) for k, v in specs.items()
                            if v["case"] == "serving"}}
    for name in ("h64", "h61"):
        s = specs[name]
        fwd = _jax_conv_forward(s["kernels"], s["scale"])
        jax_side[name] = {w: _contract(fwd, s["image"], s["halo"], s["scale"], w)
                          for w in WORLDS}
    jax_side["h64_sharded"] = np.asarray(jax_spatial(
        _jax_conv_forward(specs["h64"]["kernels"], 2), jnp.asarray(specs["h64"]["image"]),
        scale=2, mesh=jax_mesh(), halo=4))
    ranks = worker.results(ctx, (1,) + WORLDS, out)
    return {"specs": specs, "worlds": {w: ranks[w] for w in WORLDS}, "alone": ranks[1][0],
            "jax": jax_side}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["h64", "h61"])
def test_spatial_forward_meets_the_jax_contract(runs, world, name):
    """Every rank returns the whole output, equal to the JAX functions'
    ``crop(forward(reflect_pad(image, halo)))``; at H 64 also to the JAX
    ``spatial_sharded_forward`` on its 8 devices."""
    want = runs["jax"][name][world]
    for rank in runs["worlds"][world]:
        got = rank[name]["out"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
        if name == "h64":
            np.testing.assert_allclose(got, runs["jax"]["h64_sharded"], rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_forward_of_the_rcan_convolutions(runs, world):
    """A 64-feature RCAN without residual groups (radius 3 input rows) over
    the group with halo 4, H 37 (not a multiple of 2 or 4): the port's
    whole-image contract within 1e-6."""
    spec = runs["specs"]["rcan"]
    h, state = worker._handler(spec)
    with torch.no_grad():
        want = _contract(lambda x: h.run_eval(state, {"lr": torch.from_numpy(x)}).numpy(),
                         spec["image"], spec["halo"], spec["scale"], world)
    for rank in runs["worlds"][world]:
        np.testing.assert_allclose(rank["rcan"]["out"], want, rtol=0, atol=PORT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["h64", "h61", "rcan"])
def test_halo_exchange_gives_the_reflect_padded_rows(runs, world, name):
    """Each rank's extended strip of the image (H reflect-padded to a
    multiple of the ranks) is its rows with ``halo`` more on each side from
    its neighbours, the image's first and last rows reflected at its
    edges: rows ``r * h`` to ``(r + 1) * h + 2 * halo`` of that image
    reflect-padded by ``halo``."""
    spec = runs["specs"][name]
    img, halo = spec["image"], spec["halo"]
    img = np.pad(img, ((0, 0), (0, (-img.shape[1]) % world), (0, 0), (0, 0)), mode="reflect")
    rows = img.shape[1] // world
    padded = np.pad(img, ((0, 0), (halo, halo), (0, 0), (0, 0)), mode="reflect")
    for r, rank in enumerate(runs["worlds"][world]):
        np.testing.assert_array_equal(rank[name]["ext"],
                                      padded[:, r * rows:(r + 1) * rows + 2 * halo])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["same_size", "mixed_sizes", "metadata"])
def test_mesh_predictor_matches_the_single_predictor(runs, world, name):
    """Every rank returns every request's output at its own size, equal to
    the one-process predictor's and to the JAX mesh predictor's."""
    alone = runs["alone"][name]["outs"]
    jax_outs = runs["jax"]["predict"][name]
    spec = runs["specs"][name]
    for rank in runs["worlds"][world]:
        outs = rank[name]["outs"]
        assert [o.shape for o in outs] == [(im.shape[0] * spec["kwargs"]["scale"],
                                           im.shape[1] * spec["kwargs"]["scale"], 3)
                                          for im in spec["images"]]
        for got, want, jw in zip(outs, alone, jax_outs):
            np.testing.assert_allclose(got, want, rtol=0, atol=PORT_ATOL)
            np.testing.assert_allclose(got, np.asarray(jw), rtol=0, atol=JAX_ATOL)
    if name == "metadata":
        assert not np.allclose(alone[0], alone[1])
