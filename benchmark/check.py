"""What decides ``correct``: the plain reference run again from the seed,
and the numbers that compare the program's outputs with it.

Training (the first three steps of the object the window then drives):

* ``lr_gap``: the chain's LR batches, the largest absolute gap of a pixel
  from the reference's;
* ``loss_gap``: each step's loss, the largest gap relative to the
  reference's (each step's is in the detail, ``loss_gaps``);
* ``grad_gap.<family>``: each trained leaf's first-step gradient norm (from
  Adam's state after one step), its gap from the reference's norm over
  that norm or the family's median leaf's, whichever is larger: the median
  of the family's gaps;
* ``change_gap.<family>``: each leaf's change after three steps (parameters
  and BatchNorm statistics), its norm's gap measured the same way, leaving
  out trained leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off under Adam) and frozen leaves that
  the reference leaves unmoved: the median of the family's gaps;
* ``frozen_change``, where the configuration freezes a part: the largest
  change of a leaf that the reference leaves unmoved (0 when sound).

The families are the configuration's ``leaf_families`` (the blocks' conv1,
conv2, the channel attention's squeeze and excitation, the q-layer, the
group tails, the encoder's BatchNorm statistics, the rest), so that a fault
confined to one family, as a channel attention's gradient, moves that
family's median although it moves under half the leaves. A family's
median, not its worst leaf: the worst leaf of sound runs, a channel
attention's squeeze (R = 4 units a block) in every run read, swings from
seed to seed (``PERF.md`` gives its readings). ``grad_worst`` and
``change_worst`` in the detail name the worst leaves.

Evaluation (a sample of the window's images, drawn from the seed): the SR
image's gap from the reference's (``sr_gap``: norm of the difference over
the reference's norm; ``sr_max_gap``: the widest gap of a value over the
reference's root mean square), and the gaps of its PSNR and SSIM from the
reference's scores of the same SR image (``psnr_gap``, ``ssim_gap``): the
scores are judged apart from the image, since on random weights an SR
image lies so far from its HR image that one precision's image and
another's score nearly alike.

The reference runs once the program's state is freed, in float32 with TF32
off, in blocks of rows. ``precision`` "control" runs it in the lower
precision that stands in for the program in the control: the model's
products on fp8 operands, the chain and the scores in bfloat16.
"""

from __future__ import annotations

import math
import re
import statistics

import torch

from benchmark import seeded
from benchmark.core import reference_module
from benchmark.reference import chain as ref_chain
from benchmark.reference import scores as ref_scores
from benchmark.reference.common import Adam, exact_float32, set_precision

CONTROL = {"model": "fp8", "chain": "bf16", "scores": "bf16"}
EXACT = {"model": "f32", "chain": "f32", "scores": "f32"}


def build_reference(cfg: dict, device, seed: int, precision: str):
    ref = reference_module(cfg["reference"])
    model = ref.build(cfg).to(device)
    model.load_state_dict(seeded.weights(
        {k: tuple(v.shape) for k, v in model.state_dict().items()}, seed, device))
    return ref, set_precision(model, precision)


def reference_train(cell: dict, seed: int, device, steps: int, precision=EXACT,
                    half_batch: bool = False) -> dict:
    """The reference's first ``steps`` steps from the seed: LR batches,
    losses, first-step gradient norms, and each leaf's change norm. With
    ``half_batch`` the loss leaves out the batch's second half and takes the
    mean over the rest: a fault, planted in the reference put in the
    program's place."""
    cfg, traffic = cell["config"], cell["traffic"]
    batch, side, rows = traffic["batch"], traffic["hr_side"], traffic["reference_rows"]
    used = batch // 2 if half_batch else batch
    with exact_float32():
        ref, model = build_reference(cfg, device, seed, precision["model"])
        params = {k: p for k, p in model.named_parameters() if ref.trained(k)}
        for k, p in model.named_parameters():
            p.requires_grad_(k in params)
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        adam = Adam(params, cfg["lr"])
        g_crops = seeded.generator(device, seed, seeded.CROPS)
        g_chain = torch.Generator(device=device).manual_seed(
            seeded.stream_seed(seed, seeded.CHAIN))
        chain = dict(traffic["chain"], scale=cfg["scale"])
        out = {"lr": [], "loss": []}
        for step in range(steps):
            hr = seeded.hr_crops(g_crops, batch, side)
            lr = ref_chain.degrade(g_chain, hr, chain, precision["chain"])
            out["lr"].append(lr)
            x, target = lr.permute(0, 3, 1, 2), hr.permute(0, 3, 1, 2)
            emb = ref.embed(model, x, True)
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            loss = 0.0
            for r in range(0, used, rows):
                e = min(r + rows, used)
                sr = ref.generate(model, x[r:e], None if emb is None else emb[r:e])
                part = (sr - target[r:e]).abs().sum() / target[:used].numel()
                for k, g in zip(params, torch.autograd.grad(part, list(params.values()))):
                    grads[k] += g
                loss += float(part.detach())
            out["loss"].append(loss)
            if step == 0:
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                     for k, g in grads.items()}
            adam.step(grads)
        out["change_norms"] = {k: float(torch.linalg.vector_norm(v.float() - start[k].float()))
                               for k, v in model.state_dict().items()}
    return out


def reference_eval(cell: dict, seed: int, device, pool, indices, precision=EXACT) -> dict:
    """The reference's SR image (H, W, 3) of each pool image in
    ``indices``: {index: SR}."""
    out = {}
    with exact_float32(), torch.no_grad():
        _, model = build_reference(cell["config"], device, seed, precision["model"])
        for i in sorted(set(indices)):
            out[i] = model(pool[i][0].permute(2, 0, 1)[None], train=False)[0].permute(1, 2, 0)
    return out


def reference_scores(sr, hr, precision: str = "f32") -> dict:
    """PSNR and SSIM of the Y channels of ``sr`` (clipped) and ``hr``."""
    ya, yb = ref_scores.y_channel(sr), ref_scores.y_channel(hr)
    return {"PSNR": ref_scores.psnr(ya, yb, precision), "SSIM": ref_scores.ssim(ya, yb, precision)}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's |prog - ref| over max(ref, the median leaf's ref)."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys}


def worst_leaves(prog: dict, ref: dict, keys, top: int = 3):
    """The ``top`` leaves of the largest gap: [name, gap, prog, ref]."""
    gap = leaf_gaps(prog, ref, keys)
    return [[k, gap[k], prog[k], ref[k]] for k in sorted(gap, key=lambda k: -gap[k])[:top]]


def families(keys, patterns) -> dict:
    """{family: [leaf]}: each leaf in the first family of ``patterns``
    ([[family, regex]], the configuration's ``leaf_families``) whose regex
    it matches; families that hold no leaf are left out."""
    compiled = [(name, re.compile(rx)) for name, rx in patterns]
    out = {}
    for k in keys:
        fam = next((name for name, rx in compiled if rx.search(k)), None)
        if fam is None:
            raise ValueError(f"leaf {k!r} is in no family of the configuration")
        out.setdefault(fam, []).append(k)
    return out


def family_gaps(prog: dict, ref: dict, keys, patterns) -> dict:
    """{family: the median of its leaves' gaps}, each gap measured against
    max(the leaf's reference norm, the family's median leaf's)."""
    return {fam: statistics.median(leaf_gaps(prog, ref, leaves).values())
            for fam, leaves in families(keys, patterns).items()}


def train_numbers(prog: dict, ref: dict, patterns, detail: dict = None) -> dict:
    """The numbers; ``detail``, where given, receives each step's loss gap
    and the leaves of the largest gaps."""
    grads, changes = ref["grad_norms"], ref["change_norms"]
    median = statistics.median(grads.values())
    trained = [k for k in changes if k in grads and grads[k] >= 1e-3 * median]
    frozen = [k for k in changes if k not in grads]
    moved = trained + [k for k in frozen if changes[k] > 0.0]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    if detail is not None:
        detail["loss_gaps"] = loss_gaps
        detail["grad_worst"] = worst_leaves(prog["grad_norms"], grads, grads)
        detail["change_worst"] = worst_leaves(prog["change_norms"], changes, moved)
    numbers = {
        "lr_gap": max(float((a - b).abs().max()) for a, b in zip(prog["lr"], ref["lr"])),
        "loss_gap": max(loss_gaps),
    }
    for fam, gap in family_gaps(prog["grad_norms"], grads, grads, patterns).items():
        numbers[f"grad_gap.{fam}"] = gap
    for fam, gap in family_gaps(prog["change_norms"], changes, moved, patterns).items():
        numbers[f"change_gap.{fam}"] = gap
    unmoved = [k for k in frozen if changes[k] == 0.0]
    if unmoved:
        numbers["frozen_change"] = max(prog["change_norms"][k] for k in unmoved)
    return numbers


def eval_numbers(prog: list, ref: dict, pool) -> dict:
    """``prog``: [(pool index, SR, {"PSNR", "SSIM"})] of the sampled images;
    ``ref``: the reference's SR images by pool index."""
    gaps = {"sr_gap": 0.0, "sr_max_gap": 0.0, "psnr_gap": 0.0, "ssim_gap": 0.0}
    for i, sr, scores in prog:
        rsr = ref[i].float()
        want = reference_scores(sr, pool[i][1])
        diff = sr.float() - rsr
        rms = float(rsr.square().mean().sqrt())
        gaps["sr_gap"] = max(gaps["sr_gap"], float(torch.linalg.vector_norm(diff)
                                                    / torch.linalg.vector_norm(rsr)))
        gaps["sr_max_gap"] = max(gaps["sr_max_gap"], float(diff.abs().max()) / rms)
        gaps["psnr_gap"] = max(gaps["psnr_gap"], abs(scores["PSNR"] - want["PSNR"]))
        gaps["ssim_gap"] = max(gaps["ssim_gap"], abs(scores["SSIM"] - want["SSIM"]))
    return gaps


def judge(numbers: dict, limits: dict):
    """(correct, [[name, number, limit]]): every number finite and within
    its limit. A number whose limit is null is not compared (its control
    and faults did not read three times its sound runs: ``PERF.md`` gives
    its readings); one the limits file does not name fails."""
    rows = [[k, v, limits.get(k, float("nan"))] for k, v in numbers.items()]
    ok = all(lim is None or (math.isfinite(v) and v <= lim) for _, v, lim in rows)
    return ok, rows
