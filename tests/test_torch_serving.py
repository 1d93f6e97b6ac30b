"""The port's serving path (BatchedPredictor, SISRInterface in eval mode,
colour conversion, checkpoints) against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumpy_tpu.interface import SISRInterface as JaxInterface
from rumpy_tpu.serving import BatchedPredictor as JaxPredictor
from rumpy_tpu.utils import color as jcolor
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.models.base import TrainState
from rumpy_tpu_torch.serving import BatchedPredictor, plan_batches
from rumpy_tpu_torch.utils import checkpoint as ckpt
from rumpy_tpu_torch.utils import color as tcolor
from rumpy_tpu_torch.utils.weights import state_dict_from_jax
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

CONFIG = {"name": "rcan",
          "internal_params": {"scale": 2, "n_feats": 16, "n_resgroups": 1,
                              "n_resblocks": 2, "reduction": 4}}


@pytest.fixture(scope="module")
def pair():
    """JAX and port interfaces holding the same RCAN weights."""
    ji = JaxInterface(mode="eval", new_params=CONFIG)
    ti = SISRInterface(mode="eval", new_params=CONFIG, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, ji.state.params)
    ti.state = TrainState(step=0, params=state_dict_from_jax(params, ti.model.module))
    return ji, ti


def _images(rng):
    return [rng.random((13, 17, 3)).astype(np.float32),
            rng.random((16, 16, 3)).astype(np.float32),
            rng.random((33, 20, 3)).astype(np.float32)]


def test_batched_predictor_matches_jax(pair, rng):
    ji, ti = pair
    imgs = _images(rng)
    jpred = JaxPredictor(ji.model, ji.state, pad_multiple=16, max_batch=4)
    pred = BatchedPredictor(ti.model, ti.state, pad_multiple=16, max_batch=4)
    outs = pred.predict(imgs)
    assert [o.shape for o in outs] == [(26, 34, 3), (32, 32, 3), (66, 40, 3)]
    for got, want in zip(outs, jpred.predict(imgs)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
    # same-bucket batching must not change per-image results
    solo = pred.predict([imgs[0]])[0]
    np.testing.assert_array_equal(outs[0], solo)


class _Recorder:
    """A handler that records each forward as (request indices, bucket):
    request i is an image filled with the value i."""
    scale = 1

    def __init__(self, to_output):
        self.forwards, self.to_output = [], to_output

    def run_eval(self, state, batch):
        lr = batch["lr"]
        self.forwards.append(([int(v) for v in lr[:, 0, 0, 0]], lr.shape[1:3]))
        return self.to_output(lr)


def test_plan_batches_matches_jax_predictor():
    """plan_batches lists the forwards both predictors run: sorted by
    bucket, cut at max_batch (the Set5 x4 shapes plus same-bucket ones)."""
    sizes = [(128, 128), (72, 72), (64, 64), (70, 70), (86, 57), (90, 90),
             (65, 70), (95, 66)]
    imgs = [np.full((h, w, 3), i, np.float32) for i, (h, w) in enumerate(sizes)]
    plan = [(group, tuple(key)) for group, key in plan_batches(sizes, 32, 2)]
    assert plan == [([2], (64, 64)), ([4], (96, 64)), ([1, 3], (96, 96)),
                    ([5, 6], (96, 96)), ([7], (96, 96)), ([0], (128, 128))]
    jax_rec = _Recorder(lambda lr: lr)
    JaxPredictor(jax_rec, None, pad_multiple=32, max_batch=2).predict(imgs)
    port_rec = _Recorder(torch.from_numpy)
    BatchedPredictor(port_rec, None, pad_multiple=32, max_batch=2).predict(imgs)
    assert jax_rec.forwards == port_rec.forwards == plan
    assert [len(g) for g, _ in plan_batches(sizes[:5], 32, 8)] == [1, 1, 2, 1]


@pytest.mark.parametrize("pad_multiple,size_multiple", [(None, 1), (8, 1), (None, 4)])
def test_interface_eval_matches_jax(pair, rng, pad_multiple, size_multiple):
    """No padding; zero-padded shape buckets (explicit pad_multiple); and
    reflect padding up to the handler's own size_multiple."""
    ji, ti = pair
    ji.model.size_multiple = ti.model.size_multiple = size_multiple
    try:
        lr = rng.random((1, 13, 10, 3)).astype(np.float32)
        want = ji.net_run_and_process(lr=lr, pad_multiple=pad_multiple)
        got = ti.net_run_and_process(lr=lr, pad_multiple=pad_multiple,
                                     timing=True)
    finally:
        del ji.model.size_multiple, ti.model.size_multiple
    assert got[0].shape == want[0].shape == (1, 26, 20, 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert got[3] > 0


@pytest.mark.parametrize("im_type", ["jpg", "png"])
def test_color_matches_jax(rng, im_type):
    img = rng.random((2, 5, 7, 3)).astype(np.float32)
    for y_only in (False, True):
        want = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img), y_only=y_only,
                                              im_type=im_type))
        got = tcolor.rgb_to_ycbcr(torch.from_numpy(img), y_only=y_only,
                                  im_type=im_type).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(img), im_type=im_type))
    got = tcolor.ycbcr_to_rgb(torch.from_numpy(img), im_type=im_type).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_checkpoint_round_trip(tmp_path, rng):
    first = SISRInterface(model_loc=str(tmp_path), experiment="exp", mode="eval",
                          new_params=CONFIG, seed=3, device="cpu")
    first.model.save_model(first.state, first.model_save_dir, epoch=4)
    loaded = SISRInterface(model_loc=str(tmp_path), experiment="exp", mode="eval",
                           new_params=CONFIG, load_epoch="last", device="cpu")
    assert loaded.model_epoch == 5
    lr = rng.random((9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(first.net_run_and_process(lr=lr)[0],
                                  loaded.net_run_and_process(lr=lr)[0])
    payload = ckpt.load_checkpoint(ckpt.checkpoint_path(first.model_save_dir, 4))
    assert payload["model_name"] == "rcan" and payload["model_epoch"] == 4


def test_select_best_epoch_reads_summary_csv(tmp_path):
    models = tmp_path / "saved_models"
    models.mkdir()
    for e in (0, 1, 2, 5):
        (models / f"train_model_{e}").write_bytes(b"")
    summary = tmp_path / "summary.csv"
    # epoch 2's first row is from an aborted run; its last row supersedes it
    summary.write_text("epoch,train-loss,val-PSNR\n0,0.5,20.0\n1,0.4,24.5\n"
                       "2,0.3,30.0\n2,0.3,22.0\n4,0.2,24.0\n")
    assert ckpt.select_epoch(str(models), "best", str(summary)) == 1
    assert ckpt.select_epoch(str(models), "best", str(summary),
                             metric="train-loss") == 5  # epoch 4 snaps to 5
    assert ckpt.select_epoch(str(models), "last") == 5
    assert ckpt.select_epoch(str(models), "2") == 2
    with pytest.raises(FileNotFoundError):
        ckpt.select_epoch(str(models), "best", str(tmp_path / "absent.csv"))
