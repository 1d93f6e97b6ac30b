"""The plain reference against the port's CPU path at a tiny size: the
chain bit for bit, the forward and the first steps in float32."""

import pytest
import torch

from benchmark import check, seeded, window
from benchmark.reference import chain as ref_chain
from benchmark.system import Program, Ranges, reference_shapes
from benchmark.tests.tiny import TINY_SEED, cells, tiny_cell

TRAIN, EVAL = cells("train"), cells("eval")


def test_chain_bit_for_bit():
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    cell = tiny_cell(TRAIN[0])
    chain = cell["traffic"]["chain"]
    hr = seeded.hr_crops(seeded.generator("cpu", TINY_SEED, seeded.CROPS), 6, 64)
    pipe = ImagePipeline(chain["pipeline"], deg_configs=chain["deg_configs"], scale=4)
    for step in range(2):
        g1 = torch.Generator().manual_seed(100 + step)
        g2 = torch.Generator().manual_seed(100 + step)
        got, _ = pipe.degrade_batch(g1, hr)
        want = ref_chain.degrade(g2, hr, dict(chain, scale=4))
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", TRAIN)
def test_state_names_match(name):
    cfg = tiny_cell(name)["config"]
    prog = Program(cfg, "cpu", TINY_SEED, Ranges())
    shapes = reference_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in prog.state.params.items()} == shapes


@pytest.mark.parametrize("train", TRAIN)
def test_forward_float32(train):
    """Each configuration's evaluation forward and scores."""
    cell = tiny_cell(train, dtype="float32")
    prog = Program(cell["config"], "cpu", TINY_SEED, Ranges())
    pool = seeded.eval_pool("cpu", TINY_SEED, 2, [[64, 96]], 4)
    ref = check.reference_eval(cell, TINY_SEED, "cpu", pool, [0, 1])
    for i in (0, 1):
        sr, scores = prog.evaluate(*pool[i])
        assert torch.allclose(sr, ref[i], rtol=1e-4, atol=1e-5)
        want = check.reference_scores(ref[i], pool[i][1])
        assert scores["PSNR"] == pytest.approx(want["PSNR"], abs=1e-4)
        assert scores["SSIM"] == pytest.approx(want["SSIM"], abs=1e-5)


@pytest.mark.parametrize("name", TRAIN)
def test_first_steps_float32(name):
    out = window.run(tiny_cell(name, dtype="float32"), TINY_SEED, 0.0, False, ["cpu"], 0.0)
    n = out["numbers"]
    assert n["lr_gap"] == 0.0 and n.get("frozen_change", 0.0) == 0.0
    assert n["loss_gap"] < 1e-5, n
    assert all(v < 1e-4 for k, v in n.items() if k.startswith("grad_gap.")), n
    assert all(v < 1e-3 for k, v in n.items() if k.startswith("change_gap.")), n
