"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``window.run`` and ``check.judge``
with the cell's own limits) on the CPU at a tiny size, skipping only the
look for a card, with one fault planted in the port: a step that leaves
the state unchanged, half the batch left out of the loss (the mean over
the rest), the channel attentions' gradients alone altered, an LR batch
altered where the chain makes it, an SR image or a score altered where
evaluation makes it. The cells run on one card, so no
exchange between cards can be left out. The control (the reference in a
lower precision in the program's place) fails too, here at the tiny size
and, on a card, at the cell's own size."""

import pytest
import torch

from benchmark import check, control, system, window
from benchmark.tests.tiny import TINY_SEED, cells, tiny_cell

TRAIN, EVAL = cells("train"), cells("eval")


def judged(cell):
    """(correct, the names of the numbers over their limits)."""
    out = window.run(cell, TINY_SEED, 0.3, False, ["cpu"], 0.0)
    ok, rows = check.judge(out["numbers"], cell["limits"])
    over = {k for k, v, lim in rows if lim is not None and not v <= lim}
    return ok and out["failed"] == 0, over


def correct(cell) -> bool:
    return judged(cell)[0]


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_sound_tiny_run_is_correct(name):
    ok, over = judged(tiny_cell(name))
    assert ok, over


@pytest.mark.parametrize("name", TRAIN)
def test_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch(name, monkeypatch):
    from rumpy_tpu_torch.models import base
    losses = base.BaseHandler.compute_losses

    def half(self, sr, batch, aux):
        n = sr.shape[0] // 2
        return losses(self, sr[:n], {**batch, "hr": batch["hr"][:n]}, aux)

    monkeypatch.setattr(base.BaseHandler, "compute_losses", half)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("scale", [0.0, 2.0])
def test_channel_attention_gradient_altered(name, scale, monkeypatch):
    """The channel attentions' gradients alone scaled, as a fault in the
    backward's du and gate passes would: 0 drops them, 2 doubles them
    (which Adam's step all but ignores). Four of a block's eight leaves
    move, under half of all, so only their own families' medians see it."""
    init = system.Program.__init__

    def faulty(self, *a, **kw):
        init(self, *a, **kw)
        for k, p in self.handler.module.named_parameters():
            if ".ca." in k and p.requires_grad:
                p.register_hook(lambda g: g * scale)

    monkeypatch.setattr(system.Program, "__init__", faulty)
    ok, over = judged(tiny_cell(name))
    assert not ok and {"grad_gap.ca_down", "grad_gap.ca_up"} & over, over


@pytest.mark.parametrize("name", TRAIN)
def test_lr_altered(name, monkeypatch):
    from rumpy_tpu_torch.degradations import pipeline
    degrade = pipeline.ImagePipeline.degrade_batch

    def altered(self, generator_, hr, *a, **kw):
        lr, meta = degrade(self, generator_, hr, *a, **kw)
        lr = lr.clone()
        lr[0, 0, 0, 0] += 0.25
        return lr, meta

    monkeypatch.setattr(pipeline.ImagePipeline, "degrade_batch", altered)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", EVAL)
def test_sr_altered(name, monkeypatch):
    from rumpy_tpu_torch.models import base
    run_eval = base.BaseHandler.run_eval

    def altered(self, state, batch):
        sr = run_eval(self, state, batch).clone()
        sr[0, 5, 5, 1] += 0.5
        return sr

    monkeypatch.setattr(base.BaseHandler, "run_eval", altered)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", EVAL)
def test_score_altered(name, monkeypatch):
    from rumpy_tpu_torch.utils import metrics
    fetch = metrics.fetch

    def altered(values):
        out = fetch(values)
        out["SSIM"] = [v + 0.01 for v in out["SSIM"]]
        return out

    monkeypatch.setattr(metrics, "fetch", altered)
    assert not correct(tiny_cell(name))


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_control_fails_tiny(name):
    cell = tiny_cell(name)
    ok, rows = check.judge(control.control_numbers(cell, TINY_SEED, torch.device("cpu")),
                           cell["limits"])
    assert not ok, rows


@pytest.mark.chip
@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_control_fails_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from benchmark import core
    cell = core.cell(core.load_benchmark(), name)
    for seed in (11, 12, 13):
        ok, rows = check.judge(control.control_numbers(cell, seed, torch.device("cuda")),
                               cell["limits"])
        assert not ok, (seed, rows)
