"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rumpy_tpu_torch/csrc`` into
``rumpy_tpu_torch/build/`` (one nvcc process a source, side by side), holds
each against its plain PyTorch version at the shapes the main paths give it
and at a few others (the entropy path's kernels after serving, so that their
checks do not run in the process ahead of the serving numbers), and drives
the two paths the port has, each through the entry points a user would
call, at full width (RCAN x4, 10 groups x 20 RCAB, 64 features, bf16,
seeded random weights):

* serving: registry -> handler -> checkpoint -> SISRInterface(eval,
  load_epoch="last") -> BatchedPredictor.predict over the Set5 shapes;
* training: ``cli.train_sisr`` -> TrainingHandler.run_experiment() on
  LR/HR ``.npy`` pairs written from a seed, patches chosen by local
  entropy, two epochs, then a serve from the checkpoint it wrote;
* blind training: ``cli.train_sisr`` on HR-only ``.npy`` files with the
  ``[data.online_degradations]`` table of examples/train_rcan_blind_x4.toml
  (blur of seven families -> x4 downsample -> noise -> JPEG), every batch
  degraded on the card inside the train step, validating after each epoch
  on eval pairs (four at the DIV2K x4 sizes, one at each Set5 x4 shape);
  then three steps at bench.py's batch 120 with bench.py's chain;
* evaluation: ``cli.eval_sisr`` on the blind experiment (epochs best and
  last) -> EvalHub.full_image_protocol -> individual_metrics.csv, and one
  EvalHub run that waits for the card only where it fetches an image's
  metrics; then the flax-msgpack reader on a packaged checkpoint of the
  JAX package;
* the BoBW flagship (``contrastiveblindqrcan``: a frozen DASR encoder,
  loaded from the packaged ``supmoco_fullchain_d256``, feeds QRCAN, whose
  200 blocks run on the RCAB kernels with per-image gate inputs): the
  kernels with per-image bd, bu and scale against their plain versions at
  its shapes (``qrcab_kernel``); ``cli.train_sisr`` on a copy of
  examples/train_bobw_rcan_supmoco.toml, validating each epoch, then three
  steps at bench.py's BoBW point, batch 96 (``bobw_train``); and
  ``cli.eval_sisr`` on the saved run (``bobw_eval``);
* the BoBW encoder trained in the port: the bf16 backward at C = 128
  against an f32 gradient over 16 input draws (``rcab_bwd_c128``); the
  SupMoCo predictor through ``cli.train_sisr`` on a copy of
  examples/train_supmoco_predictor.toml (dim 256, K 8192, batch 32, 5
  views of 256 x 256 HR an image degraded on the card in one pass, the
  contrastive evaluation on LR files and a metadata CSV written here), a
  fixed batch's step under sync debug mode "error", and the packaged
  supmoco_fullchain_d256 warm-started by name, its clustering scores on
  the card beside the CPU's (``contrastive_train``); and joint BoBW
  (``contrastiveblindqrcan``, ``combined_loss_mode`` "supmoco" at batch 16
  and 64, then "moco"), its trainable encoder loaded from that run, 200
  forward and 200 backward RCAB launches a step (``bobw_joint``);
* the metadata-conditioned family: examples/train_qrcan_meta_attention.toml
  (QRCAN on the chain's sigma_x, sigma_y and kernel_type, on the RCAB
  kernels) through ``cli.train_sisr`` and ``cli.eval_sisr
  --metadata_file`` on eval pairs degraded on the card with a
  degradation_metadata.csv written here, an EvalHub run with one fetch an
  image under sync debug mode "error", and the trainer's metadata matrix
  against the CSV's (``meta_attention``); contrastiveblindqedsr,
  contrastiveblindqrcan in srmd_mode (on the kernels) and in sft_mode (the
  plain route), and the softmax and extended_attention QRCAN styles beside
  max_concat (``bobw_family``); SRMD, EDSRMD and SFTMD on PCA blur-kernel
  metadata of srmdgaussianblur through both CLIs (``metadata_maps``); a
  measurement of the bf16 backward's sums over an image against f32 at the
  train shape and at 1x339x510 (``rcab_bwd_f32_sums``, no gate);
* every RCAB kernel launch of the run, recorded by shape, dtype, direction
  and which gate inputs are per image: each one that no phase held against
  the plain version is held after the paths, in the directions launched,
  and the script fails on any still not held (``launch_coverage``).

It checks that every RCAB forward and backward and every patch selection
went through the kernels (launch counts set to 0 before a path and read
after it), that the entropy kernel's fused front gives luma_u8's grey
levels and the window-sum kernel the plain pooled map, both bit for bit,
that entropy picks on the card are the CPU's (or near ties), that one
item's entropy path is at most 4 launches with at most 16 bytes copied to
the host, that a bf16 train step runs no backward pass on the CUDA cores
and no separate gate pass, that two runs of a forward or backward give the
same bits, that the forward's tensor-core conv passes launch a block on
every SM at the main-path shapes, that outputs and losses are finite, that
a fixed batch's loss went down, and that the kernel path agrees with the
plain path and with the CPU. The kernel phases print each forward's launch
plan, and at the train shape and the largest request's bucket each pass's
device time beside one cuDNN conv of the same shape. The degradation ops
(no hand kernel: PyTorch ops) are held on the card against the CPU with the
same inputs and draws at bench.py's shapes, with the TF32 flags off and on;
one chain runs under sync debug mode "error" and gives bench.py's 13
metadata keys; their device ms and launches per step are printed. The
evaluation phases check validation's and eval_sisr's columns and launch
counts, the metrics on the card against the CPU on the same fetched
arrays (PSNR within 1e-5 dB, SSIM within 1e-6, bicubic bit for bit), and
print eval images/s, one DIV2K forward's and one image's metrics' device
ms, the eval's peak memory and validation seconds per epoch; the kernel
phase holds the forward at the eval path's shapes too. The BoBW phases
check that the frozen encoder's weights stay bit for bit the packaged
ones while its BatchNorm running statistics move, that a step launches
200 forward and 200 backward kernels and no conv2d call of a QRCAB's
shape beyond the pipeline's other convs, and print step ms, HR-MP/s,
peak memory, kernels and the card's busy ms a step at batch 96, eval
images/s and one DIV2K-sized forward's device ms.

Prints the card, then one JSON line per phase, then a ``{"kernels": ...}``
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of an H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
CLOCK_HZ = 1.98e9  # H100 SXM boost clock: sleep cycles to seconds

# Kernel against plain version on the card. f32: the two sum the same
# exact products in another order (observed ~1e-6). bf16: both round h1
# and the output to bf16, so an h1 value at a rounding boundary can differ
# by one ulp and move the output by an ulp: allowed two ulps of the
# largest output, 2**-6 * max|ref|.
F32_ATOL = 1e-4
BF16_REL_ULP = 2.0 ** -6
# Full RCAN x4 f32, kernel path against the plain path (cuDNN without
# TF32) and against the CPU: 200 blocks of f32 rounding differences.
MODEL_F32_ATOL = 1e-3

SET5_X4_LR = [(128, 128), (72, 72), (64, 64), (70, 70), (86, 57)]
PAD_MULTIPLE, MAX_BATCH = 32, 8
RCAN_FULL = dict(scale=4, n_feats=64, n_resgroups=10, n_resblocks=20,
                 reduction=16)
# RCAB's input in a train step: batch 16 of 48x48 LR crops.
TRAIN_BATCH, TRAIN_CROP = 16, 48
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, RCAN_FULL["n_feats"])
# Eval pairs: four at the DIV2K x4 sizes (339x510, 172,890 pixels) and one
# at each Set5 x4 LR shape. eval_sisr runs each image alone; validation
# buckets them by shape, chunks of up to VAL_CHUNK: one forward for the four
# DIV2K images and one for each Set5 image.
DIV2K_LR = (339, 510)
EVAL_DIV2K, VAL_CHUNK = 4, 8
EVAL_LR_SHAPES = [DIV2K_LR] * EVAL_DIV2K + SET5_X4_LR


def eval_path_shapes():
    """RCAB's input shapes on the evaluation path, unpadded (RCAN's and
    QRCAN's size_multiple is 1): every (N, H, W) that eval_sisr (N = 1) and
    validation's chunks launch, in EVAL_LR_SHAPES' order."""
    shapes = []
    for (h, w), k in collections.Counter(EVAL_LR_SHAPES).items():
        chunks = {min(VAL_CHUNK, k - i) for i in range(0, k, VAL_CHUNK)}
        shapes += [(n, h, w, RCAN_FULL["n_feats"]) for n in sorted(chunks | {1})]
    return shapes


EVAL_SHAPES = eval_path_shapes()
# Kernel shapes beside the serving path's: the train step's, the eval
# path's, and other channel counts, one of them (C=24) on the CUDA-core pass
# in bf16.
EXTRA_SHAPES = [TRAIN_SHAPE, *EVAL_SHAPES, (1, 64, 64, 32), (1, 40, 33, 128),
                (1, 33, 45, 24)]

# RCAB backward kernel against autograd of the plain version on the card
# (cuDNN without TF32), per gradient, relative to that gradient's largest
# entry. f32: the same products summed in another order over up to 36,864
# pixels. bf16: both sides round h1, dh1 and dx to bf16 (and the plain
# version its conv-weight gradients), at boundaries that differ, and the
# kernel rounds dh2 to bf16 to feed the tensor cores where the plain version
# keeps it in f32: four bf16 ulps of the largest entry.
BWD_F32_REL = 2e-4
BWD_BF16_REL = 2.0 ** -6
# Backward shapes beside the train step's and the serving path's: tiles
# ragged on both axes at C=64, the other tensor-core widths (128, 32, 16),
# and C=24, which stays on the CUDA cores in bf16 too.
BWD_EXTRA_SHAPES = [(2, 45, 51, 64), (1, 40, 33, 128), (1, 30, 41, 32), (2, 37, 24, 16),
                    (1, 33, 45, 24)]
# Channel counts that the kernels run on the tensor cores in bf16. There the
# backward must beat its plain version (cuDNN in full f32) at every shape held.
MMA_WIDTHS = (16, 32, 64, 128)
# One f32 train step of full RCAN x4, parameter gradients of the kernel
# path against the plain path, relative to each gradient's largest entry:
# 200 blocks of f32 rounding differences in either direction.
MODEL_GRAD_F32_REL = 2e-3
# The same step in bf16. Either path rounds every activation and activation
# gradient of 200 blocks to bf16, at boundaries that differ between the
# paths, so they drift apart about as far as bf16 drifts from f32 (printed
# beside the check as plain_bf16_vs_plain_f32; on an H100 0.0074 between the
# paths and 0.0125 from f32): allowed eight bf16 ulps of the largest entry.
MODEL_GRAD_BF16_REL = 2.0 ** -5

# Entropy kernel against its plain version: the kernel's log2(N) - S/N with
# S in fixed point (the table's rounding moves a value by at most 2**-21),
# the plain version's float32 sum of p * log2(p) over up to 256 bins.
ENTROPY_ATOL = 1e-5
# Two entropy picks are a near tie if their plain pooled scores (sums of
# crop**2 entropies) differ by at most crop**2 times the kernel's tolerance.
ENTROPY_SHAPES = [(339, 510), (512, 512), (37, 53)]
TRAIN_LR_SHAPE, TRAIN_SCALE = ENTROPY_SHAPES[0], 4
TIE_TOL = TRAIN_CROP ** 2 * ENTROPY_ATOL
TRAIN_IMAGES, TRAIN_SETS, TRAIN_EPOCHS = 8, 5, 2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3, backlog_s: float = 0.05) -> float:
    """Device ms per call of ``fn``, by CUDA events around ``iters`` calls.
    A sleep kernel queued first holds the card while the host enqueues the
    calls, so host overhead between launches is not counted (it is, if the
    enqueue outlasts ``backlog_s``; ``backlog_s=0`` times the host-bound
    rate instead)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog_s:
        torch.cuda._sleep(int(backlog_s * CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rcab_inputs(shape, dtype, seed):
    n, h, w, c = shape
    r = max(1, c // 16)
    g = torch.Generator().manual_seed(seed)

    def t(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).cuda()

    k = (1.0 / (9 * c)) ** 0.5
    return [t(n, h, w, c).to(dtype), t(9, c, c, sc=k).to(dtype), t(c, sc=0.05),
            t(9, c, c, sc=k).to(dtype), t(c, sc=0.05), t(c, r, sc=0.3),
            t(r, sc=0.05), t(r, c, sc=0.3), t(c, sc=0.05)]


def rcab_bound_ms(shape, dtype):
    n, h, w, c = shape
    ops = 2 * (2 * n * h * w * c * c * 9)
    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * n * h * w * c * elt + 2 * 9 * c * c * elt
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main_path_shapes():
    """RCAB's input shapes in one serve of the Set5 requests: one per
    forward that BatchedPredictor plans, (batch, bucket h, bucket w, C)."""
    from rumpy_tpu_torch.serving import plan_batches
    return [(len(group), bh, bw, RCAN_FULL["n_feats"]) for group, (bh, bw)
            in plan_batches(SET5_X4_LR, PAD_MULTIPLE, MAX_BATCH)]


def library_conv_ms(shape):
    """A yardstick the port never calls: one cuDNN 3x3 ``F.conv2d`` on bf16
    channels_last tensors of RCAB's shape. The kernel computes two such
    convs, the gate and the residual add."""
    n, h, w, c = shape
    g = torch.Generator().manual_seed(301)
    inp = torch.randn(n, c, h, w, generator=g).cuda().to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn(c, c, 3, 3, generator=g).cuda().to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return cuda_ms(lambda: torch.nn.functional.conv2d(inp, weight, padding=1), 20)


def kernel_phase(rcab):
    """Every main-path shape and the extras, f32 and bf16, res_scale 1 and
    0.5, each with the kernel's launch plan and two runs compared bit for
    bit (output and workspace: h2, tile sums, gate). At the train shape and
    the largest request's bucket, each pass's device time and the library's
    conv beside it. Fails where a bf16 tensor-core plan at a main-path or
    train shape launches fewer conv blocks than the card has SMs. Returns
    the bf16 row of the largest request's bucket (the kernels line's
    numbers), the bf16 row at the train shape, the bf16 rows at the eval
    path's shapes (each with the library's conv beside it) and the largest
    bf16 error at any shape."""
    main_shapes = main_path_shapes()
    main_shape = max(main_shapes, key=lambda s: s[1] * s[2])
    rows, main, train, evals = [], None, None, []
    for i, shape in enumerate(dict.fromkeys(main_shapes + EXTRA_SHAPES)):
        for dtype in (torch.float32, torch.bfloat16):
            args = rcab_inputs(shape, dtype, seed=i)
            for res_scale in (1.0, 0.5):
                got = rcab.rcab_fused(*args, res_scale=res_scale)
                torch.cuda.synchronize()
                ref = rcab.rcab_reference(*args, res_scale=res_scale)
                err = (got.float() - ref.float()).abs().max().item()
                tol = (F32_ATOL if dtype == torch.float32
                       else BF16_REL_ULP * ref.float().abs().max().item())
                row = {"shape": shape, "main_path": shape in main_shapes,
                       "dtype": str(dtype).split(".")[-1],
                       "res_scale": res_scale, "max_abs_err": err, "tol": tol}
                if res_scale == 1.0:
                    row["plan"] = plan = rcab.plan(shape, dtype)
                    runs = [rcab._forward(*args, None, res_scale)[:2] for _ in range(2)]
                    row["bit_identical_runs"] = all(
                        torch.equal(a, b) for a, b in zip(*runs))
                    del runs
                    row["ms"] = cuda_ms(lambda: rcab.rcab_fused(*args), 20)
                    row["host_bound_ms"] = cuda_ms(lambda: rcab.rcab_fused(*args), 20,
                                                   backlog_s=0)
                    row["plain_ms"] = cuda_ms(lambda: rcab.rcab_reference(*args), 20)
                    row["bound_ms"], row["bound_by"] = rcab_bound_ms(shape, dtype)
                    if shape in (TRAIN_SHAPE, main_shape):
                        row["pass_device_us"] = traced(
                            lambda: rcab.rcab_fused(*args),
                            f"rcab_forward_trace_{row['dtype']}_{shape[1]}", 5,
                            by_kernel=True)["per_call_device_us_by_kernel"]
                        if dtype == torch.bfloat16:
                            row["library_conv_ms"] = library_conv_ms(shape)
                    if shape in EVAL_SHAPES and dtype == torch.bfloat16:
                        row["eval_path"] = True
                        row["library_conv_ms"] = library_conv_ms(shape)
                print(json.dumps({"phase": "kernel", **row}), flush=True)
                if not err <= tol:
                    raise AssertionError(f"rcab_fused disagrees with rcab_reference: {row}")
                if not row.get("bit_identical_runs", True):
                    raise AssertionError(f"rcab_fused: two runs differ at {shape} {dtype}")
                if (res_scale == 1.0 and plan["tensor_cores"]
                        and (shape in main_shapes or shape == TRAIN_SHAPE)
                        and plan["blocks"] < plan["sms"]):
                    raise AssertionError(f"rcab_fused's conv passes do not fill the SMs: {row}")
                CHECKED["forward"].add(launch_key(args[0], args[6], args[8], None))
                rows.append(row)
                if dtype == torch.bfloat16 and res_scale == 1.0:
                    if shape == main_shape:
                        main = row
                    if shape == TRAIN_SHAPE:
                        train = row
                    if shape in EVAL_SHAPES:
                        evals.append(row)
    return main, train, evals, max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")


# Every RCAB kernel launch of the run by direction and launch_key, and the
# keys that a comparison phase held against the plain version. The script
# fails if a launch's key was never held (launch_coverage).
LAUNCHED = {"forward": set(), "backward": set()}
CHECKED = {"forward": set(), "backward": set()}
RECORDING = [True]


def launch_key(x, bd, bu, scale):
    """A launch's shape, dtype and form: whether bd, bu and the scale are
    per image."""
    return (tuple(x.shape), str(x.dtype).split(".")[-1], bd.dim() == 2, bu.dim() == 2,
            scale is not None)


def record_launches(rcab):
    """Wraps the wrapper's two launch functions to add each launch's key to
    LAUNCHED; the launch counts stay the wrapper's own."""
    fwd, bwd = rcab._forward, rcab._backward

    def forward(x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale):
        if RECORDING[0]:
            LAUNCHED["forward"].add(launch_key(x, bd, bu, scale))
        return fwd(x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale)

    def backward(dout, x, workspace, kargs, res_scale, keep=None):
        if RECORDING[0]:
            LAUNCHED["backward"].add(launch_key(x, kargs[5], kargs[7], kargs[8]))
        return bwd(dout, x, workspace, kargs, res_scale, keep)

    rcab._forward, rcab._backward = forward, backward


@contextlib.contextmanager
def unrecorded():
    """Launches of a check that holds only part of a result (the
    gradients held against f32) are no launched shape of a path."""
    RECORDING[0] = False
    try:
        yield
    finally:
        RECORDING[0] = True


def launch_coverage_phase(rcab):
    """Holds each shape, dtype and form that the run launched and no phase
    held (qrcab_check, in the directions that were launched: the paths'
    own shapes and the forwards under rcab_bwd_phase's backwards), then
    fails where any launch's key is still not held. Returns the added
    rows."""
    todo = sorted({k for d in LAUNCHED for k in LAUNCHED[d] - CHECKED[d]})
    rows = [qrcab_check(rcab, shape, getattr(torch, dtype), 450 + i, tuple(form),
                        backward=(shape, dtype, *form) in LAUNCHED["backward"],
                        phase="launch_coverage_check")
            for i, (shape, dtype, *form) in enumerate(todo)]
    unchecked = {d: sorted(LAUNCHED[d] - CHECKED[d]) for d in LAUNCHED}
    print(json.dumps({"phase": "launch_coverage", "held_after_the_paths": todo,
                      "launched": {d: sorted(v) for d, v in LAUNCHED.items()},
                      "unchecked": unchecked}), flush=True)
    if any(unchecked.values()):
        raise AssertionError(f"rcab kernels launched at shapes never held against "
                             f"their plain versions: {unchecked}")
    return rows


@contextlib.contextmanager
def plain_rcab(rcab):
    """Route RCAB through the plain version on the card (for comparison
    only; launches made here are not the main path's)."""
    fused = rcab.rcab_fused
    rcab.rcab_fused = lambda x, *a, **kw: rcab.rcab_reference(x, *a, **kw)
    try:
        yield
    finally:
        rcab.rcab_fused = fused


FAMILIES = ("rcab_conv1_mma", "rcab_conv2_mma", "rcab_conv_kernel", "rcab_apply",
            "rcab_bwd_wgrad_mma", "rcab_bwd_dh1_mma", "rcab_bwd_dx_mma",
            "rcab_bwd_wgrad", "rcab_bwd_dh1", "rcab_bwd_dx", "rcab_bwd",
            "local_entropy", "window_sum")
# The backward's CUDA-core passes: a bf16 step at C=64 must launch none.
CUDA_CORE_BWD = ("rcab_bwd_wgrad", "rcab_bwd_dh1", "rcab_bwd_dx")


def kernel_name(traced_name: str) -> str:
    """A kernel's own name out of the profiler's: no return type, namespace,
    template or argument list."""
    name = traced_name.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name.replace("void ", ""))
    return m.group(1) if m else traced_name


def traced(fn, name: str, repeats: int, by_kernel: bool = False):
    """torch.profiler over ``repeats`` calls of ``fn``: device time by
    kernel family per call (with ``by_kernel``, by each kernel's own name
    too), and the share of the traced span the card sat idle. The Chrome
    trace goes to build/<name>.json."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "build", f"{name}.json")
    # A session now and then records no device event at all, right after
    # another session on this machine (kernel-phase traces of 5 x 40 us):
    # the calls are traced again, up to three times in all.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if events:
            break
        print(f"traced {name}: no device event in session {attempt + 1}", file=sys.stderr,
              flush=True)
    if not events:
        raise AssertionError("the profiler traced no kernel on the card")
    by_family, by_name, counts = {}, {}, {}
    for e in events:
        fam = next((k for k in FAMILIES if k in e["name"]), "other")
        by_family[fam] = by_family.get(fam, 0.0) + e["dur"] / repeats
        counts[fam] = counts.get(fam, 0) + 1 / repeats
        name = kernel_name(e["name"])
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / repeats
    # busy: the union of the kernels' intervals. A programmatic dependent
    # launch starts before the kernel ahead of it ends, so the families'
    # sums above count that overlap twice.
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), e["ts"] + e["dur"]
        if stop > start:
            busy += stop - start
        end = max(end, stop)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return {"per_call_device_us": by_family, "per_call_kernels_by_family": counts,
            **({"per_call_device_us_by_kernel": by_name} if by_kernel else {}),
            "kernels_per_call": len(events) / repeats, "busy_us": busy,
            "span_us": span, "idle_share": 1 - busy / span}


def trace_phase(model, state, x):
    """Two traced forwards of one request."""
    return {"phase": "trace",
            **traced(lambda: model.run_eval(state, {"lr": x}), "rcan_forward_trace", 2)}


def slice_phase(rcab, card):
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.serving import BatchedPredictor

    # a checkpoint of seeded random weights, saved the way training saves
    config = {"name": "rcan", "internal_params": dict(RCAN_FULL, dtype="bf16")}
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as exp_root:
        maker = get_model("rcan")(device="cuda", **config["internal_params"])
        maker.save_model(maker.init_state(seed=0),
                         os.path.join(exp_root, "rcan_x4", "saved_models"), epoch=0)
        del maker
        iface = SISRInterface(model_loc=exp_root, experiment="rcan_x4", mode="eval",
                              new_params=config, load_epoch="last", device="cuda")
    pred = BatchedPredictor(iface.model, iface.state, pad_multiple=PAD_MULTIPLE,
                            max_batch=MAX_BATCH)
    rng = np.random.default_rng(0)
    requests = [rng.random((h, w, 3), dtype=np.float32) for h, w in SET5_X4_LR]
    n_buckets = len(main_path_shapes())  # forwards a predict

    pred.predict(requests)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    rcab.launches = 0
    t0 = time.perf_counter()
    outs = pred.predict(requests)
    seconds = time.perf_counter() - t0
    launches = rcab.launches
    want = 200 * n_buckets
    if launches != want:
        raise AssertionError(f"rcab_fused launched {launches} times in one predict, "
                             f"expected {want} (200 RCAB x {n_buckets} buckets)")
    for (h, w), out in zip(SET5_X4_LR, outs):
        if out.shape != (4 * h, 4 * w, 3) or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} for a {h}x{w} request")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(requests)
        times.append(time.perf_counter() - t0)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict(requests[:1])
        lat.append(time.perf_counter() - t0)
    # one forward of a 128x128 request: device time against wall time
    x128 = torch.as_tensor(requests[0][None], device="cuda")
    fwd_device = cuda_ms(lambda: iface.model.run_eval(iface.state, {"lr": x128}),
                         5, backlog_s=0.5)
    fwd_wall = cuda_ms(lambda: iface.model.run_eval(iface.state, {"lr": x128}),
                       5, backlog_s=0)
    serve = {"phase": "serve", "model": "rcan x4 10x20x64 bf16", "card": card,
             "requests": len(requests), "buckets": n_buckets,
             "rcab_launches_per_predict": launches,
             "first_timed_predict_s": seconds,
             "predict_s": times, "images_per_s": len(requests) / min(times),
             "latency_128px_ms": [t * 1e3 for t in lat],
             "forward_128px_device_ms": fwd_device,
             "forward_128px_host_bound_ms": fwd_wall}
    print(json.dumps(serve), flush=True)
    print(json.dumps(trace_phase(iface.model, iface.state, x128)), flush=True)

    # f32: the kernel path against the plain path on the card, and
    # against the CPU on a small input
    f32 = get_model("rcan")(device="cuda", **RCAN_FULL)
    state = f32.init_state(seed=0)
    f32_pred = BatchedPredictor(f32, state, pad_multiple=PAD_MULTIPLE,
                                max_batch=MAX_BATCH)
    one = requests[2:3]
    got = f32_pred.predict(one)[0]
    with plain_rcab(rcab):
        plain = f32_pred.predict(one)[0]
    err_plain = float(np.abs(got - plain).max())
    small = rng.random((1, 20, 17, 3), dtype=np.float32)
    on_card = f32.run_eval(state, {"lr": small}).cpu().numpy()
    cpu = get_model("rcan")(device="cpu", **RCAN_FULL)
    on_cpu = cpu.run_eval(cpu.init_state(seed=0), {"lr": small}).numpy()
    err_cpu = float(np.abs(on_card - on_cpu).max())
    check = {"phase": "f32_check", "max_abs_err_vs_plain_on_card": err_plain,
             "max_abs_err_vs_cpu": err_cpu, "tol": MODEL_F32_ATOL,
             "out_abs_max": float(np.abs(plain).max())}
    print(json.dumps(check), flush=True)
    if not (err_plain <= MODEL_F32_ATOL and err_cpu <= MODEL_F32_ATOL):
        raise AssertionError(f"f32 RCAN kernel path disagrees: {check}")
    return launches


def entropy_image(shape, seed):
    """uint8 luma with smooth and noisy regions, on the card."""
    g = torch.Generator().manual_seed(seed)
    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    amp = 60.0 * (0.5 + 0.5 * torch.sin(xx / 17.0)) * (0.5 + 0.5 * torch.cos(yy / 11.0))
    img = 0.3 * yy + 0.2 * xx + amp * torch.randn(h, w, generator=g)
    return img.clamp(0, 255).to(torch.uint8).cuda()


def entropy_bound_ms(img):
    """Bytes over the memory rate: the image (uint8 RGB or grey levels) read
    once, the float32 map written once. The operations the function needs
    (a sliding histogram: about 2 * region updates a pixel) stay under that
    time. Returns (bound ms, bound by, bytes)."""
    h, w = img.shape[:2]
    nbytes = img.numel() * img.element_size() + 4 * h * w
    return nbytes / PEAK_BYTES * 1e3, "bytes", nbytes


def launch_floor_ms() -> float:
    """Device ms of one empty kernel among many queued back to back: what a
    launch costs the card before it does any work."""
    return cuda_ms(lambda: torch.cuda._sleep(0), 200)


def entropy_phase(ent):
    """Kernel against plain version, borders included, at the train path's
    LR size, 512x512 and a ragged small image, from the two sources the
    kernel reads: uint8 RGB (``local_entropy_rgb``, the grey levels computed
    in its load: the main path's variant) against ``local_entropy_reference``
    of the CPU's ``grey_levels_reference``, and uint8 grey levels
    (``local_entropy``). Returns the RGB row at the main path's shape and
    defaults (region 10, levels 64)."""
    main = None
    for i, shape in enumerate(ENTROPY_SHAPES):
        rgb = smoke_rgb(shape, seed=20 + i)
        grey = entropy_image(shape, seed=i)
        sources = (("rgb_u8", rgb, ent.grey_levels_reference(rgb.cpu()).cuda(),
                    ent.local_entropy_rgb, ent.grey_levels_reference),
                   ("grey_u8", grey, grey, ent.local_entropy, lambda g: g))
        for source, img, levels_of_img, kernel, plain_front in sources:
            for region in (9, 10):
                for levels in (64, 256):
                    got = kernel(img, region, levels)
                    torch.cuda.synchronize()
                    ref = ent.local_entropy_reference(levels_of_img, region, levels)
                    err = (got - ref).abs().max().item()
                    border = max((got[:region] - ref[:region]).abs().max().item(),
                                 (got[:, :region] - ref[:, :region]).abs().max().item(),
                                 (got[-region:] - ref[-region:]).abs().max().item(),
                                 (got[:, -region:] - ref[:, -region:]).abs().max().item())
                    row = {"source": source, "shape": shape, "region": region,
                           "levels": levels, "max_abs_err": err,
                           "border_max_abs_err": border, "tol": ENTROPY_ATOL,
                           "entropy_max": ref.max().item()}
                    if region == 10 and levels == 64:
                        row["ms"] = cuda_ms(lambda: kernel(img, region, levels), 50)
                        row["plain_ms"] = cuda_ms(lambda: ent.local_entropy_reference(
                            plain_front(img), region, levels), 5)
                        row["bound_ms"], row["bound_by"], row["bytes"] = entropy_bound_ms(img)
                    is_main = (source == "rgb_u8" and shape == TRAIN_LR_SHAPE
                               and region == 10 and levels == 64)
                    if is_main:
                        row["launch_floor_ms"] = launch_floor_ms()
                        main = row
                    print(json.dumps({"phase": "entropy_kernel", **row}), flush=True)
                    if not (err <= ENTROPY_ATOL and got.shape == ref.shape):
                        raise AssertionError(
                            f"local_entropy disagrees with its plain version: {row}")
    return main


def smoke_rgb(shape, seed):
    """An 8-bit RGB image with smooth and textured regions, uint8 on the card."""
    g = torch.Generator().manual_seed(seed)
    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    amp = 70.0 * (0.5 + 0.5 * torch.sin(xx / 23.0)) * (0.5 + 0.5 * torch.cos(yy / 13.0))
    img = 128.0 + amp[..., None] * torch.randn(h, w, 3, generator=g)
    return img.clamp(0, 255).to(torch.uint8).cuda()


def front_phase(ent):
    """The entropy kernel's fused front: its grey levels of uint8 RGB against
    luma_u8 of the float32 image that the dataset's conversion gives (v /
    255 in numpy), on the card, bit for bit; and the entropy from RGB
    against the entropy of those grey levels, bit for bit, from uint8 and
    from float32 RGB (whose grey levels the plain front computes on the
    card before the kernel)."""
    from rumpy_tpu_torch.ops.entropy import luma_u8
    rows = []
    for i, shape in enumerate(ENTROPY_SHAPES):
        rgb = smoke_rgb(shape, seed=40 + i)
        as_float = torch.from_numpy(rgb.cpu().numpy().astype(np.float32) / 255.0).cuda()
        want = luma_u8(as_float).to(torch.uint8)
        for src in (rgb, as_float):
            grey = ent.grey_levels(rgb) if src is rgb else ent.grey_levels_reference(src)
            flips = int((grey != want).sum().item())
            same = torch.equal(ent.local_entropy_rgb(src, 10, 64), ent.local_entropy(want, 10, 64))
            row = {"phase": "entropy_front", "shape": shape, "source": str(src.dtype),
                   "grey_level_flips": flips, "entropy_bit_identical": same}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if flips or not same:
                raise AssertionError(f"the fused front disagrees with luma_u8: {row}")
    return rows


def window_bound_ms(shape, k):
    """The window sums' least time: the map read once and the pooled map
    written once, or the adds (rows, then columns) at the float32 rate."""
    h, w = shape
    ho, wo = h - k + 1, w - k + 1
    nbytes = 4 * (h * w + ho * wo)
    ops = (k - 1) * ho * (w + wo)
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_window_ms(x, k):
    """A yardstick the port never calls: one float32 ``avg_pool2d`` of the
    map, stride 1, with ``divisor_override=1`` (the same window sums, in its
    own order)."""
    return cuda_ms(lambda: torch.nn.functional.avg_pool2d(
        x[None, None], k, stride=1, divisor_override=1), 20)


def window_phase(ent, win):
    """The window-sum kernel against its plain version (box_filter_same,
    trimmed) on the same entropy map, bit for bit, and its pick against the
    plain pick, highest and lowest, at each entropy shape and a few window
    sizes. Returns the row at the train path's LR size and crop."""
    main = None
    for i, shape in enumerate(ENTROPY_SHAPES):
        e = ent.local_entropy_rgb(smoke_rgb(shape, seed=60 + i), 10, 64)
        for k in sorted({min(TRAIN_CROP, *shape), 16, 1}):
            row = {"shape": shape, "window": k}
            for lowest in (False, True):
                pick = torch.zeros(1, dtype=torch.int64, device="cuda")
                got = win.window_sum(e, k, pick=pick, lowest=lowest)
                ref = win.window_sum_reference(e, k)
                key_index = win.pick_index(pick.item())
                want_index, _ = win.pick_reference(ref, lowest)
                row["bit_identical"] = bool(torch.equal(got, ref))
                row["max_abs_err"] = (got - ref).abs().max().item()
                row["lowest_pick" if lowest else "pick"] = [key_index, want_index]
                if not row["bit_identical"] or key_index != want_index:
                    raise AssertionError(f"window_sum disagrees with its plain version: {row}")
            if shape == TRAIN_LR_SHAPE and k == TRAIN_CROP:
                row["ms"] = cuda_ms(lambda: win.window_sum(e, k), 50)
                row["plain_ms"] = cuda_ms(lambda: win.window_sum_reference(e, k), 5)
                row["bound_ms"], row["bound_by"] = window_bound_ms(shape, k)
                row["library_ms"] = library_window_ms(e, k)
                main = row
            print(json.dumps({"phase": "window_sum_kernel", **row}), flush=True)
    return main


GRAD_NAMES = ["dx", "dw1", "db1", "dw2", "db2", "dwd", "dbd", "dwu", "dbu"]


def rcab_bwd_bound_ms(shape, dtype):
    n, h, w, c = shape
    # five conv-sized products: conv1 again (the kernel's choice: a backward
    # that kept h1 would need four), two data and two weight gradients
    ops = 5 * 2 * n * h * w * c * c * 9
    elt = torch.finfo(dtype).bits // 8
    nbytes = 3 * n * h * w * c * elt + n * h * w * c * 4 + 4 * 9 * c * c * 4
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_conv_backward_ms(shape):
    """Two yardsticks the port never calls: one ``convolution_backward`` of a
    3x3 conv on bf16 channels_last tensors of RCAB's shape, for the weight
    gradient alone and for the input gradient alone. The backward kernel
    computes two of each, and conv1 again."""
    n, h, w, c = shape
    g = torch.Generator().manual_seed(300)
    t = lambda *s: torch.randn(*s, generator=g).cuda().to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    grad_out, inp, weight = t(n, c, h, w), t(n, c, h, w), t(c, c, 3, 3)

    def call(mask):
        return lambda: torch.ops.aten.convolution_backward(
            grad_out, inp, weight, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)

    return {"library_wgrad_ms": cuda_ms(call([False, True, False]), 20),
            "library_dgrad_ms": cuda_ms(call([True, False, False]), 20)}


def rcab_bwd_phase(rcab):
    """The backward kernel against autograd of the plain version: all nine
    gradients at the train step's shape, the serving shapes and
    BWD_EXTRA_SHAPES, f32 and bf16, res_scale 1 and 0.5, and two runs of one
    backward bit for bit; fails too where a bf16 backward on the tensor
    cores is not faster than its plain version. Returns the bf16 row at the
    train shape, which also holds the device time of each pass and the
    library's yardsticks."""
    main = None
    shapes = [TRAIN_SHAPE] + main_path_shapes() + BWD_EXTRA_SHAPES
    for i, shape in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            rel_tol = BWD_F32_REL if dtype == torch.float32 else BWD_BF16_REL
            args = [a.requires_grad_(True) for a in rcab_inputs(shape, dtype, seed=100 + i)]
            g = torch.Generator().manual_seed(200 + i)
            dout = torch.randn(*shape, generator=g).cuda().to(dtype)
            for res_scale in (1.0, 0.5):
                before = rcab.backward_launches
                out = rcab.rcab_fused(*args, res_scale=res_scale)
                got = torch.autograd.grad(out, args, dout, retain_graph=True)
                torch.cuda.synchronize()
                if rcab.backward_launches != before + 1:
                    raise AssertionError("the backward kernel was not launched")
                again = torch.autograd.grad(out, args, dout, retain_graph=True)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"rcab backward: two runs differ at {shape} {dtype}")
                ref = rcab.rcab_backward_reference(dout, *args, res_scale=res_scale)
                errs, worst = {}, 0.0
                for name, a, b in zip(GRAD_NAMES, got, ref):
                    scale = b.float().abs().max().item()
                    err = (a.float() - b.float()).abs().max().item()
                    errs[name] = {"max_abs_err": err, "ref_abs_max": scale}
                    worst = max(worst, err / max(scale, 1e-30))
                    if a.dtype != b.dtype or a.shape != b.shape or not err <= rel_tol * scale:
                        raise AssertionError(
                            f"rcab backward: {name} disagrees at {shape} {dtype} "
                            f"res_scale {res_scale}: {errs[name]}, rel tol {rel_tol}")
                row = {"shape": shape, "dtype": str(dtype).split(".")[-1],
                       "res_scale": res_scale, "worst_rel_err": worst, "rel_tol": rel_tol,
                       "bit_identical_runs": True,
                       "max_abs_err": errs["dx"]["max_abs_err"], "grads": errs}
                if res_scale == 1.0:
                    ref_out = rcab.rcab_reference(*args)
                    backward = lambda: torch.autograd.grad(out, args, dout, retain_graph=True)
                    row["ms"] = cuda_ms(backward, 10)
                    row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                        ref_out, args, dout, retain_graph=True), 10)
                    row["bound_ms"], row["bound_by"] = rcab_bwd_bound_ms(shape, dtype)
                    if shape == TRAIN_SHAPE:
                        row["pass_device_us"] = traced(
                            backward, f"rcab_backward_trace_{row['dtype']}", 5,
                            by_kernel=True)["per_call_device_us_by_kernel"]
                    if shape == TRAIN_SHAPE and dtype == torch.bfloat16:
                        row.update(library_conv_backward_ms(shape))
                        main = row
                    row["faster_than_plain"] = row["ms"] < row["plain_ms"]
                print(json.dumps({"phase": "rcab_backward_kernel", **row}), flush=True)
                if (dtype == torch.bfloat16 and shape[3] in MMA_WIDTHS
                        and not row.get("faster_than_plain", True)):
                    raise AssertionError(
                        f"rcab backward on the tensor cores is no faster than its plain "
                        f"version at {shape}: {row['ms']} ms against {row['plain_ms']} ms")
                CHECKED["backward"].add(launch_key(args[0], args[6], args[8], None))
    return main


C128_SHAPE = (1, 40, 33, 128)
C128_DRAWS = 8
# At C = 128 in bf16 the backward's dw1 may stand at most this many times
# further from an f32 gradient of the same bf16-valued inputs than the bf16
# plain version's dw1 does, draw by draw.
C128_FACTOR = 2.0
F32_UNIT = 2.0 ** -24


GRADS_VS_F32 = (("dw1", 1), ("db1", 2), ("dw2", 3))  # name, index in the kernel's tuple


def f32_grads(args, dout, scale, mask=None):
    """dw1, db1 and dw2 of the block in float32 from the bf16-valued
    ``args`` (h1 not rounded), with the ReLU's derivative taken from
    ``mask`` (N, C, H, W) where given, else from the sign of conv1's
    float32 output; and that output."""
    import torch.nn.functional as F
    x, w1, b1, w2, b2, wd, bd, wu, bu = [a.detach().float() for a in args]
    c = x.shape[-1]
    with torch.enable_grad():
        for t in (w1, b1, w2):
            t.requires_grad_(True)
        k1 = w1.reshape(3, 3, c, c).permute(3, 2, 0, 1)
        xc = x.permute(0, 3, 1, 2)
        pre = F.conv2d(xc, k1, padding=1) + b1[:, None, None]
        h1 = pre * (pre.detach() > 0 if mask is None else mask).float()
        k2 = w2.reshape(3, 3, c, c).permute(3, 2, 0, 1)
        h2 = F.conv2d(h1, k2, padding=1) + b2[:, None, None]
        gap = h2.mean(dim=(2, 3))
        u = torch.sigmoid(torch.relu(gap @ wd + bd) @ wu + bu)
        s = scale.float()[:, :, None, None] if torch.is_tensor(scale) else scale
        y = h2 * u[:, :, None, None] * s + xc
        grads = torch.autograd.grad(y, [w1, b1, w2], dout.float().permute(0, 3, 1, 2))
    return dict(zip(("dw1", "db1", "dw2"), grads)), pre.detach()


def emulated_sums(args, dout, scale, split):
    """db1 and dw2 as the bf16 backward kernel forms them, in plain float32
    ops: dh2 = dout * u * s + dgap / HW rounded to bf16 before conv2's
    transposed conv and dw2, and dh1 rounded after the ReLU mask. With
    ``split`` only dout * u * s is rounded and the constant dgap / HW
    enters both products exactly: the repair that ROADMAP.md section 3
    queues."""
    import torch.nn.functional as F
    x, w1, b1, w2, b2, wd, bd, wu, bu = [a.detach().float() for a in args]
    c = x.shape[-1]
    pre = F.conv2d(x.permute(0, 3, 1, 2), w1.reshape(3, 3, c, c).permute(3, 2, 0, 1),
                   padding=1) + b1[:, None, None]
    mask = (pre > 0).float()
    with torch.enable_grad():
        h1 = (pre * mask).bfloat16().float().requires_grad_(True)
        k2 = w2.reshape(3, 3, c, c).permute(3, 2, 0, 1).requires_grad_(True)
        h2 = F.conv2d(h1, k2, padding=1) + b2[:, None, None]
        u = torch.sigmoid(torch.relu(h2.mean(dim=(2, 3)) @ wd + bd) @ wu + bu)
        g = dout.float().permute(0, 3, 1, 2) * (u * scale.float())[:, :, None, None]
        dh2, = torch.autograd.grad(h2 * (u * scale.float())[:, :, None, None], [h2],
                                   dout.float().permute(0, 3, 1, 2), retain_graph=True)
        dh2 = dh2.detach()
        if split:
            fed, exact = g.detach().bfloat16().float(), dh2 - g.detach()
        else:
            fed, exact = dh2.bfloat16().float(), None
        dh1, dw2 = torch.autograd.grad(h2, [h1, k2], fed, retain_graph=exact is not None)
        if exact is not None:
            e1, e2 = torch.autograd.grad(h2, [h1, k2], exact)
            dh1, dw2 = dh1 + e1, dw2 + e2
    db1 = (dh1 * mask).bfloat16().float().sum(dim=(0, 2, 3))
    return {"db1": db1, "dw2": dw2.permute(2, 3, 1, 0).reshape(9, c, c)}


def bwd_against_f32(rcab, args, scale, dout):
    """One bf16 backward of the kernel and of the plain version, each
    against the f32 gradient of the same bf16-valued inputs (h1
    unrounded), for dw1, db1 and dw2, relative to the f32 gradient's
    largest entry. A ReLU tie, an h1 pre-activation whose float64 value
    lies within the float32 rounding bound of its 9C + 1 terms (gamma *
    sum |terms|) of zero, may fall either way: two sum orders put it on
    different sides, and its whole gradient then enters the sums or not.
    So each version is held against the f32 gradient with its own ReLU
    mask (the kernel's from its own h1: ``rel_err``); ``rel_err_vs_f32_mask``
    holds the kernel to f32's mask. Also the kernel's mask bits that differ
    from float64's sign, and how many of them are ties."""
    import torch.nn.functional as F
    c = args[0].shape[3]
    gamma = (9 * c + 1) * F32_UNIT / (1 - (9 * c + 1) * F32_UNIT)
    res = 1.0 if scale is None else scale
    _, workspace, kargs = rcab._forward(*args, scale, 1.0)
    keep = {}
    kernel = rcab._backward(dout, args[0], workspace, kargs, 1.0, keep=keep)
    plain = rcab.rcab_backward_reference(dout, *args, res_scale=res)
    ref, pre32 = f32_grads(args, dout, res)
    mask_k = keep["h1"].permute(0, 3, 1, 2).float() > 0
    ref_k, _ = f32_grads(args, dout, res, mask_k)
    x64 = args[0].double().permute(0, 3, 1, 2)
    k64 = args[1].double().reshape(3, 3, c, c).permute(3, 2, 0, 1)
    pre64 = F.conv2d(x64, k64, padding=1) + args[2].double()[:, None, None]
    bound = gamma * (F.conv2d(x64.abs(), k64.abs(), padding=1)
                     + args[2].double().abs()[:, None, None])
    flips = mask_k != (pre64 > 0)
    ties = flips & (pre64.abs() <= bound)
    err, raw = {}, {}
    for name, i in GRADS_VS_F32:
        ref_max = ref[name].abs().max().item()
        plain_err = (plain[i].float() - ref[name]).abs().max().item() / ref_max
        err[name] = {"kernel": (kernel[i].float() - ref_k[name]).abs().max().item() / ref_max,
                     "plain_bf16": plain_err}
        raw[name] = {"kernel": (kernel[i].float() - ref[name]).abs().max().item() / ref_max,
                     "plain_bf16": plain_err}
    at = torch.nonzero(flips)[:4].tolist()
    return {"rel_err": err, "rel_err_vs_f32_mask": raw,
            "kernel_mask_flips": int(flips.sum().item()),
            "of_them_ties": int(ties.sum().item()),
            "f32_mask_flips": int(((pre32 > 0) != (pre64 > 0)).sum().item()),
            "flips_at": [{"nchw": i, "pre_f64": pre64[tuple(i)].item(),
                          "tie_bound": bound[tuple(i)].item()} for i in at]}


def ratio(r, name):
    e = r["rel_err"][name]
    return e["kernel"] / max(e["plain_bf16"], 1e-30)


def rcab_bwd_c128_phase(rcab):
    """The bf16 backward at C = 128 against an f32 gradient
    (bwd_against_f32): for C128_DRAWS input draws, in the shared and the
    per-image form. Fails where a mask bit of the kernel differs from
    float64's sign anywhere but at a tie, or where the kernel's dw1 stands
    more than C128_FACTOR times as far off as the plain version's. Returns
    the rows."""
    rows = []
    for form in ("shared", "per_image"):
        for draw in range(C128_DRAWS):
            seed = 700 + draw
            if form == "shared":
                args, scale = rcab_inputs(C128_SHAPE, torch.bfloat16, seed), None
            else:
                args, scale = qrcab_inputs(C128_SHAPE, torch.bfloat16, seed)
            g = torch.Generator().manual_seed(seed + 50)
            dout = torch.randn(*C128_SHAPE, generator=g).cuda().to(torch.bfloat16)
            r = bwd_against_f32(rcab, args, scale, dout)
            row = {"phase": "rcab_bwd_c128", "shape": C128_SHAPE, "form": form,
                   "draw": draw, "ratio": ratio(r, "dw1"), "factor": C128_FACTOR, **r}
            print(json.dumps(row), flush=True)
            rows.append(row)
    torch.cuda.empty_cache()
    faults = [r for r in rows if r["kernel_mask_flips"] != r["of_them_ties"]]
    if faults:
        raise AssertionError(f"rcab backward: a ReLU mask bit of the kernel at C = 128 differs "
                             f"from float64's sign beyond rounding: {faults[0]}")
    worst = max(rows, key=lambda r: r["ratio"])
    if worst["ratio"] > C128_FACTOR:
        raise AssertionError(f"rcab backward: dw1 at C = 128 stands {worst['ratio']} times as "
                             f"far from f32 as the bf16 plain version: {worst}")
    return rows


# The bf16 backward's sums over an image against f32: at the train shape
# (2,304 pixels an image) and at a DIV2K x4 image's 172,890 pixels, where no
# path runs the backward. bd and the scale per image with bu shared
# (max_concat with q-layers) and all three per image; qrcab_check's seeds
# from 455 on (455 with the first form: db1 at 0.0200 of its largest entry
# from the plain version's at 1x339x510, tolerance 2**-6).
F32_SUM_SHAPES = (TRAIN_SHAPE, (1, *DIV2K_LR, 64))
F32_SUM_SEEDS = (455, 456, 457)
MAX_CONCAT_Q = (True, False, True)


def rcab_bwd_f32_sums_phase(rcab):
    """A measurement, no gate: dw1, db1 and dw2 of the bf16 backward
    kernel and of the bf16 plain version against an f32 gradient
    (bwd_against_f32) at F32_SUM_SHAPES, the F32_SUM_SEEDS draws of
    qrcab_check in two forms. The kernel rounds dh2 = dout * u * s +
    dgap / HW to bf16 before conv2's transposed conv and dw2; the constant
    dgap / HW falls below half a bf16 ulp of dout * u * s as HW grows, so
    its share of db1 and dw2 is lost (ROADMAP.md section 3). Beside them,
    emulated_sums' errors: rounded as the kernel rounds, and split. Returns
    the rows."""
    rows = []
    for shape in F32_SUM_SHAPES:
        for form in (MAX_CONCAT_Q, ALL_PER_IMAGE):
            for seed in F32_SUM_SEEDS:
                args, scale = qrcab_inputs(shape, torch.bfloat16, seed, form)
                dout = torch.randn(*shape, generator=torch.Generator().manual_seed(
                    seed + 100)).cuda().to(torch.bfloat16)
                r = bwd_against_f32(rcab, args, scale, dout)
                ref, _ = f32_grads(args, dout, scale)
                r["emulated_rel_err"] = {
                    mode: {n: ((v - ref[n]).abs().max() / ref[n].abs().max()).item()
                           for n, v in emulated_sums(args, dout, scale, mode == "split").items()}
                    for mode in ("rounded", "split")}
                row = {"phase": "rcab_bwd_f32_sums", "shape": shape,
                       "per_image": [k for k, on in zip(("bd", "bu", "scale"), form) if on],
                       "seed": seed, "ratios": {n: ratio(r, n) for n, _ in GRADS_VS_F32},
                       **r}
                print(json.dumps(row), flush=True)
                rows.append(row)
                torch.cuda.empty_cache()
    return rows


def write_pairs(root, rng):
    """Seeded LR/HR pairs as uint8 .npy files: textured HR images whose
    local contrast varies over the image, LR their 4x decimation."""
    lh, lw = TRAIN_LR_SHAPE
    hh, hw = lh * TRAIN_SCALE, lw * TRAIN_SCALE
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    yy, xx = np.mgrid[:hh, :hw].astype(np.float32)
    for k in range(TRAIN_IMAGES):
        amp = 70.0 * (0.5 + 0.5 * np.sin(xx / (90.0 + 10 * k) + k)) \
            * (0.5 + 0.5 * np.cos(yy / (70.0 + 5 * k)))
        hr = 128.0 + amp[..., None] * rng.standard_normal((hh, hw, 3), dtype=np.float32)
        hr = np.clip(hr, 0, 255).astype(np.uint8)
        np.save(os.path.join(hr_dir, f"im{k}.npy"), hr)
        np.save(os.path.join(lr_dir, f"im{k}.npy"),
                np.ascontiguousarray(hr[::TRAIN_SCALE, ::TRAIN_SCALE]))
    return lr_dir, hr_dir


def selection_phase(lr_dir):
    """Entropy patch picks of the smoke's LR images on the card against the
    CPU plain path, at 1 and 3 patches: equal, or a near tie (the plain
    pooled scores at the two picks within TIE_TOL). After a near tie the
    masks differ, so later picks are not compared. Then what one item's
    entropy path puts on the card, from a trace."""
    from rumpy_tpu_torch.ops.entropy import entropy_patch_positions, pooled_entropy
    rows, ties = [], 0
    names = sorted(os.listdir(lr_dir))
    for name in names:
        lr = np.load(os.path.join(lr_dir, name))
        # on the CPU a single pick is the first of the 3-pick loop
        want3 = entropy_patch_positions(lr, TRAIN_CROP, 3, device="cpu")
        plain = None
        for n in (1, 3):
            got = entropy_patch_positions(lr, TRAIN_CROP, n)
            want = (want3[0][:n], want3[1][:n])
            row = {"image": name, "patches": n, "card": got, "cpu": want}
            for gy, gx, wy, wx in zip(*got, *want):
                if (gy, gx) == (wy, wx):
                    continue
                if plain is None:
                    plain = pooled_entropy(lr, TRAIN_CROP, device="cpu").numpy()
                gap = abs(float(plain[gy, gx]) - float(plain[wy, wx]))
                row["near_tie_gap"] = gap
                if not gap <= TIE_TOL:
                    raise AssertionError(f"entropy picks differ from the CPU's: {row}")
                ties += 1
                break
            rows.append(row)
    lr = np.load(os.path.join(lr_dir, names[0]))
    per_item = {n: device_ops(lambda: entropy_patch_positions(lr, TRAIN_CROP, n),
                              f"entropy_path_{n}") for n in (1, 3)}
    # what a torch.argmax of the pooled map would add instead of the pick
    # the window-sum kernel takes
    pooled = pooled_entropy(lr, TRAIN_CROP)
    argmax = device_ops(lambda: int(torch.argmax(pooled).item()), "torch_argmax")
    out = {"phase": "entropy_selection", "images": len(names), "near_ties": ties,
           "tie_tol": TIE_TOL, "picks": rows, "torch_argmax_launches": argmax["by_kind"],
           "entropy_launches_per_item": per_item[1]["launches"],
           "entropy_d2h_bytes_per_item": per_item[1]["d2h_bytes"],
           "entropy_path": {str(n): v for n, v in per_item.items()}}
    print(json.dumps(out), flush=True)
    one = per_item[1]
    if one["launches"] > 4 or one["d2h_bytes"] > 16 or one["d2h_copies"] != 1:
        raise AssertionError(f"one item's entropy path: {one}, expected at most 4 "
                             f"launches and one copy of at most 16 bytes to the host")
    return out


def device_ops(fn, name: str):
    """What one call of ``fn`` puts on the card, from a torch.profiler
    trace: kernels, copies and memsets (each one launch), and the bytes it
    copies from the device to the host. The trace goes to build/<name>.json."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()  # warm: libraries built, tables uploaded
    torch.cuda.synchronize()
    # a traced span's first device events can go missing while the tracer
    # starts: one call in a warm-up step, then the call that is counted. A
    # session now and then records no device event at all (as in traced):
    # the call is traced again, up to three sessions.
    path = os.path.join(ROOT, "build", f"{name}.json")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                      and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if events:
            break
        print(f"device_ops {name}: no device event in session {attempt + 1}",
              file=sys.stderr, flush=True)
    d2h = [e for e in events if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]]
    return {"launches": len(events),
            "by_kind": {k: sum(e["cat"] == k for e in events)
                        for k in ("kernel", "gpu_memcpy", "gpu_memset")},
            "kernels": sorted({kernel_name(e["name"]) for e in events
                               if e["cat"] == "kernel"}),
            "d2h_bytes": sum(int(e.get("args", {}).get("bytes", 0)) for e in d2h),
            "d2h_copies": len(d2h)}


def item_parts_ms(ds):
    """Host ms of each part of each item of ``ds``, from the laps that
    ``SuperResImages.__getitem__`` takes while its ``part_ms`` is set:
    decode (both files, the decode cache cleared first), select (the
    entropy patch corner, which waits for its device work), crop + augment
    and convert."""
    from rumpy_tpu_torch.data import datasets
    parts = {}
    for idx in range(len(ds)):
        datasets._decode_cached.cache_clear()
        ds.part_ms = {}
        ds[idx]
        for part, v in ds.part_ms.items():
            parts.setdefault(part, []).append(v)
    ds.part_ms = None
    return parts


def l1_on(model, state, batch):
    sr = model.run_eval(state, {"lr": batch["lr"]}).float()
    return (sr - batch["hr"]).abs().mean().item()


def train_phase(rcab, ent, win, card):
    """The training path through its CLI, then what it wrote serves."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.data.datasets import SuperResImages
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(0))
    selection = selection_phase(lr_dir)
    internal = dict(RCAN_FULL, dtype="bf16", lr=1e-4, optimizer_type="adam")
    seed = 1
    cfg = {
        "experiment": "rcan_x4_entropy",
        "experiment_save_loc": os.path.join(root, "experiments"),
        "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "augmentations": True,
                 "dataloader_threads": 4,
                 # the same eight pairs listed five times: 40 items, two
                 # batches of 16 an epoch and a ragged one dropped
                 "training_sets": {f"data_{i}": {
                     "lr_dir": lr_dir, "hr_dir": hr_dir,
                     "patch_selection_type": "entropy"} for i in range(TRAIN_SETS)}},
        "model": {"name": "rcan", "internal_params": internal},
        "training": {"num_epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH, "seed": seed},
    }
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES * TRAIN_SETS // TRAIN_BATCH)

    # one fixed batch (the same crop of every image, no augmentation) and its loss under
    # the weights the trainer starts from
    fixed_ds = SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=TRAIN_SCALE,
                              crop=TRAIN_CROP, patch_type="predefined",
                              predefined_patch_locations=[(TRAIN_LR_SHAPE[0] // 3, TRAIN_LR_SHAPE[1] // 3)])
    items = [fixed_ds[i] for i in range(TRAIN_IMAGES)]
    fixed = {k: torch.as_tensor(np.stack([it[k] for it in items])).cuda()
             for k in ("lr", "hr")}
    fresh = get_model("rcan")(device="cuda", seed=seed, **internal)
    loss_before = l1_on(fresh, fresh.init_state(seed), fixed)
    del fresh

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = ent.launches = win.launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches,
              "local_entropy": ent.launches, "window_sum": win.launches}
    peak_train = torch.cuda.max_memory_allocated()
    want = {"rcab_fused": 200 * steps, "rcab_fused_backward": 200 * steps,
            "local_entropy": TRAIN_BATCH * steps, "window_sum": TRAIN_BATCH * steps}
    if counts != want:
        raise AssertionError(f"kernel launches in the training run {counts}, expected {want} "
                             f"({steps} steps of batch {TRAIN_BATCH}, 200 RCAB)")
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")

    exp = os.path.join(root, "experiments")
    ckpt = os.path.join(exp, "rcan_x4_entropy", "saved_models",
                        f"train_model_{TRAIN_EPOCHS - 1}")
    if not os.path.isfile(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    iface = SISRInterface(model_loc=exp, experiment="rcan_x4_entropy", mode="eval",
                          load_epoch="last", device="cuda")
    if iface.state.step != steps:
        raise AssertionError(f"checkpoint holds step {iface.state.step}, expected {steps}")
    loss_after = l1_on(iface.model, iface.state, fixed)
    if not loss_after < loss_before:
        raise AssertionError(f"fixed-batch loss went {loss_before} -> {loss_after}")
    rgb, _, _, _ = iface.net_run_and_process(items[0]["lr"])
    if rgb.shape != (1, 4 * TRAIN_CROP, 4 * TRAIN_CROP, 3) or not np.isfinite(rgb).all():
        raise AssertionError(f"bad output {rgb.shape} from the trained checkpoint")

    # steady steps on the fixed batch (doubled to the train batch), resumed
    # from the checkpoint in train mode: device time by CUDA events
    trainer = SISRInterface(model_loc=exp, experiment="rcan_x4_entropy", mode="train",
                            load_epoch="last", device="cuda")
    batch = {k: torch.cat([v, v]) for k, v in fixed.items()}
    step = lambda: trainer.train_batch(lr=batch["lr"], hr=batch["hr"], fetch=False)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, 3, warmup=1, backlog_s=0)
    peak_step = torch.cuda.max_memory_allocated()
    hr_mp = TRAIN_BATCH * (TRAIN_CROP * TRAIN_SCALE) ** 2 / 1e6
    # host time of one item with an entropy patch: first with both files
    # read from disk (what a set larger than the decode cache pays on every
    # item), then again with both in the cache
    from rumpy_tpu_torch.data import datasets
    sel = SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=TRAIN_SCALE, crop=TRAIN_CROP,
                         patch_type="entropy", augmentations=True)
    datasets._decode_cached.cache_clear()
    item_ms = {"with_decode": [], "decode_cached": []}
    for ms in item_ms.values():
        for i in range(TRAIN_IMAGES):
            t0 = time.perf_counter()
            sel[i]
            ms.append((time.perf_counter() - t0) * 1e3)
    by_part = item_parts_ms(sel)
    row = {"phase": "train", "model": "rcan x4 10x20x64 bf16", "card": card,
           "steps": steps, "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "launches": counts,
           "epoch_train_loss": losses,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "run_experiment_s": seconds, "fixed_batch_loss_before": loss_before,
           "fixed_batch_loss_after": loss_after, "step_ms": step_ms,
           "hr_megapixels_per_s": hr_mp / (step_ms / 1e3),
           "dataset_item_ms": item_ms, "dataset_item_ms_by_part": by_part,
           "entropy_launches_per_item": selection["entropy_launches_per_item"],
           "entropy_d2h_bytes_per_item": selection["entropy_d2h_bytes_per_item"],
           "peak_memory_bytes_run": peak_train, "peak_memory_bytes_step": peak_step}
    print(json.dumps(row), flush=True)
    trace = traced(step, "rcan_train_step_trace", 1, by_kernel=True)
    passes = {k: v for k, v in trace.pop("per_call_device_us_by_kernel").items()
              if k.startswith("rcab_")}
    print(json.dumps({"phase": "train_trace", **trace, "rcab_kernels_device_us": passes}),
          flush=True)
    on_cuda_cores = [k for k in CUDA_CORE_BWD if k in trace["per_call_device_us"]]
    if on_cuda_cores:
        raise AssertionError(f"the bf16 train step ran {on_cuda_cores} on the CUDA cores")
    gate_passes = [k for k in passes if k.startswith("rcab_gate")]
    if gate_passes:  # the forward's gate is folded into its apply pass
        raise AssertionError(f"the bf16 train step ran a separate gate pass: {gate_passes}")
    del trainer, iface

    # one step at full width, f32 and bf16: parameter gradients of the
    # kernel path against the plain path
    small = {k: v[:2].contiguous() for k, v in fixed.items()}

    def grads(model, state):
        model.train_batch(state, small)
        return {k: p.grad.float().clone() for k, p in model.module.named_parameters()}

    def worst_rel(got, want):
        worst, where = 0.0, None
        for k in want:
            rel = ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
            if not rel <= worst:
                worst, where = rel, k
        return worst, where

    plain = {}
    for name, dtype, tol in (("f32", {}, MODEL_GRAD_F32_REL),
                             ("bf16", {"dtype": "bf16"}, MODEL_GRAD_BF16_REL)):
        model = get_model("rcan")(device="cuda", optimizer_type="sgd", lr=0.0, **RCAN_FULL,
                                  **dtype)
        state = model.init_state(seed=0)
        got = grads(model, state)
        with plain_rcab(rcab):
            plain[name] = grads(model, state)
        worst, where = worst_rel(got, plain[name])
        check = {"phase": f"{name}_grad_check", "worst_rel_err": worst, "at": where,
                 "rel_tol": tol, "parameters": len(got)}
        if name == "bf16":  # what bf16 itself costs: the plain path, bf16 against f32
            check["plain_bf16_vs_plain_f32"], check["plain_at"] = worst_rel(
                plain["bf16"], plain["f32"])
        print(json.dumps(check), flush=True)
        if not worst <= tol:
            raise AssertionError(f"{name} RCAN gradients, kernel path against plain path: {check}")
        del model, state
    shutil.rmtree(os.path.join(root, "data"))
    return counts


# The degradation chain (bench.py's, and the shipped blind-training
# example's) on the card against the same functions on the CPU, each op fed
# the same inputs and injected draws. Elementwise float32 ops agree to
# rounding; the blur's 441-tap sums run in another order; the resize and
# DCT products run in float64 on both sides.
BENCH_BATCH = 120  # bench.py's
DEGRADE_BATCHES = (TRAIN_BATCH, BENCH_BATCH)
HR_SIDE = TRAIN_CROP * TRAIN_SCALE
DEGRADE_ATOL = {"kernels": 1e-6, "kernel_metadata": 1e-6, "blur": 1e-5,
                "downsample": 1e-6, "gaussian_noise": 1e-6, "poisson_noise": 1e-6,
                "colour_distortion": 1e-5}
# A coefficient over its quantization step (or a reconstructed level)
# within this of a .5 boundary is a near tie: two codecs may round apart.
JPEG_TIE = 1e-3
# With the process-wide TF32 flags on, an op's error against the CPU may
# grow by no more than this (TF32's 10-bit products would move the blur by
# about 1e-3).
TF32_GROWTH = 1e-6
BENCH_CHAIN = {  # bench.py:133-143
    "pipeline": [["realesrganblur", "b"], ["downsample", "d"],
                 ["realesrgannoise", "n"], ["jpegcompress", "j"]],
    "deg_configs": {"b": {"kernel_range": ["iso", "aniso"], "kernel_size": 21,
                          "request_kernel_metadata": True},
                    "d": {"scale": TRAIN_SCALE},
                    "n": {"gaussian_noise_sigma_range": [1, 30]},
                    "j": {"quality": 60, "random_compression": True}}}
# The JAX package's fused_degrade(...).metadata_keys() for that chain.
BENCH_KEYS = [
    "0-realesrganblur-beta_g", "0-realesrganblur-beta_p", "0-realesrganblur-kernel_size",
    "0-realesrganblur-kernel_type", "0-realesrganblur-omega_c", "0-realesrganblur-rotation",
    "0-realesrganblur-sigma_x", "0-realesrganblur-sigma_y", "1-downsample-scale",
    "2-realesrgannoise-gaussian_noise_scale", "2-realesrgannoise-gray_noise",
    "2-realesrgannoise-poisson_noise_scale", "3-jpegcompress-quality"]
EXAMPLE_CONFIG = os.path.join("examples", "train_rcan_blind_x4.toml")
DEGRADE_STEPS, DEGRADE_SETS = 4, 4
BLIND_EXP = "rcan_x4_blind"
VALIDATION_FORWARDS = sum(-(-n // VAL_CHUNK)
                          for n in collections.Counter(EVAL_LR_SHAPES).values())


def card_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def to_card(x):
    if torch.is_tensor(x):
        return x.cuda()
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_card(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def flat_tensors(out, name):
    """An op's output (a tensor, or tuples and dicts of them) as
    {name[/part]: CPU tensor}."""
    if torch.is_tensor(out):
        return {name: out.cpu()}
    items = out.items() if isinstance(out, dict) else enumerate(out)
    flat = {}
    for k, v in items:
        flat.update(flat_tensors(v, f"{name}/{k}"))
    return flat


def degrade_op_cases(b, seed):
    """Each op of the chain with its CPU inputs, in chain order, every
    input the CPU output of the op before: (name, function, inputs)."""
    from rumpy_tpu_torch.ops import blur, blur_kernels as bk, color_aug, noise, resize
    g = torch.Generator().manual_seed(seed)
    hr = torch.rand(b, HR_SIDE, HR_SIDE, 3, generator=g)
    cfg = bk.BlurKernelConfig(kernel_range=bk.ALL_KERNEL_TYPES)
    draws = bk.draw_kernel_params(g, b, cfg)
    kernels, _ = bk.kernels_from_draws(cfg, draws)
    blurred = blur.apply_kernels(hr, kernels)
    lr_side = HR_SIDE // TRAIN_SCALE
    lr = resize.resize_float(blurred, (lr_side, lr_side))
    sigma = 1 + 29 * torch.rand(b, generator=g)
    gray = (torch.rand(b, generator=g) < 0.4).float()
    field = torch.randn(lr.shape, generator=g)
    rounded, gray_img, vals_c, vals_g = noise.poisson_rates(lr)
    samples = (torch.poisson(rounded * vals_c, generator=g),
               torch.poisson(gray_img * vals_g, generator=g))
    noisy = noise.apply_gaussian_noise(lr, sigma, gray, field)[0]
    return [
        ("kernels", lambda d: bk.kernels_from_draws(cfg, d), (draws,)),
        ("blur", blur.apply_kernels, (hr, kernels)),
        ("downsample", lambda x: resize.resize_float(x, (lr_side, lr_side)), (blurred,)),
        ("pil_resize", lambda x: resize.pil_resize(x, (lr_side, lr_side)),
         ((hr * 255).round().to(torch.uint8),)),
        ("gaussian_noise", noise.apply_gaussian_noise, (lr, sigma, gray, field)),
        ("poisson_vals", lambda x: noise.poisson_rates(x)[2:], (lr,)),
        ("poisson_noise", lambda x, s, gr, sc, sg: noise.apply_poisson_noise(
            x, s, gr, sc, sg, noise.poisson_rates(x)),
         (lr, 3 * torch.rand(b, generator=g), gray, *samples)),
        ("jpeg", lambda x, q: jpeg_levels(x, q, "jpeg"),
         (noisy, torch.randint(20, 81, (b,), generator=g).float())),
        ("h264", lambda x, q: jpeg_levels(x, q, "h264"),
         (noisy, torch.randint(20, 41, (b,), generator=g).float())),
        ("colour_distortion", color_aug.apply_colour_distortion,
         (hr, *color_aug.colour_distortion_draws(g, b))),
    ]


def jpeg_levels(x, q, codec):
    from rumpy_tpu_torch.ops import jpeg
    fn = jpeg.jpeg_compress if codec == "jpeg" else jpeg.h264_intra_compress
    return torch.round(fn(x, q) * 255.0)


def codec_check(name, got, want, inputs):
    """Levels of the card against the CPU's: the share of pixels that
    differ, and whether each lies where the CPU's codec has a near tie (a
    coefficient over its step in the pixel's 8x8 block, or the pixel's own
    level before rounding)."""
    from rumpy_tpu_torch.ops import jpeg
    ratios, levels = jpeg.tie_terms(*inputs, codec=name)

    def near(v):
        return ((v.abs() % 1.0) - 0.5).abs() < JPEG_TIE

    block_tie = near(ratios).any(dim=1).flatten(-2).any(dim=-1)  # (B, H/8, W/8)
    diff = (got != want).any(dim=-1)
    explained = 0
    for b, y, x in diff.nonzero().tolist():
        explained += bool(block_tie[b, y // 8, x // 8] or near(levels[b, y, x]).any())
    n = int(diff.sum())
    return {"pixels_differ_share": n / diff.numel(), "pixels_differ": n,
            "differ_at_near_tie": explained, "max_level_diff": float((got - want).abs().max()),
            "near_tie_coefficients": int(near(ratios).sum()),
            "near_tie_levels": int(near(levels).sum())}


def compare_op(name, got, want, inputs):
    if name in ("jpeg", "h264"):
        row = codec_check(name, got[name], want[name], inputs)
        row["ok"] = row["differ_at_near_tie"] == row["pixels_differ"] and row["max_level_diff"] <= 1
        return row
    if name == "pil_resize":
        d = (got[name].int() - want[name].int()).abs()
        return {"pixels_differ_share": float((d > 0).float().mean()),
                "max_level_diff": int(d.max()), "ok": bool(d.max() <= 1
                                                          and (d > 0).float().mean() <= 1e-3)}
    if name == "poisson_vals":
        same = all(torch.equal(got[k], want[k]) for k in want)
        return {"exact": same, "ok": same}
    errs, ok = {}, True
    for k in want:
        tol = DEGRADE_ATOL["kernel_metadata" if "/1/" in k and name == "kernels" else name]
        errs[k] = (got[k].double() - want[k].double()).abs().max().item()
        ok = ok and got[k].shape == want[k].shape and errs[k] <= tol
    return {"max_abs_err": max(errs.values()), "tol": DEGRADE_ATOL[name],
            "by_output": errs, "ok": ok}


HOLD_S = 0.5


def enqueue_ms(fn, hold_s: float = HOLD_S) -> float:
    """Host ms of one call of ``fn`` while a sleep kernel holds the card for
    ``hold_s``: what the call costs the host. A call that waits for the card
    (a host sync) takes at least what is left of the hold."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold_s * CLOCK_HZ))
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def held_ms(fn, iters: int = 2):
    """(device ms, host ms) of a call of ``fn``: the device time by CUDA
    events with the card held busy for longer than the host takes to
    enqueue ``iters`` calls, and the host time of one call. Few calls: the
    card's queue holds about a thousand launches, after which the host
    waits and the events time its enqueue (the chain is about 350 launches)."""
    host = enqueue_ms(fn)
    return cuda_ms(fn, iters, backlog_s=0.05 + 2e-3 * host * iters), host


def op_device_ms(pipe, b):
    """Device and host ms of each op of ``pipe`` at batch ``b`` as the chain
    runs it, and of the whole chain."""
    g = card_generator(b)
    x = torch.rand(b, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
    device, host = {}, {}
    for (step, opname), op in pipe.pipeline.items():
        key = f"{step}-{opname}"
        device[key], host[key] = held_ms(lambda: op.batch_apply(g, x))
        x = op.batch_apply(g, x)[0]
    hr = torch.rand(b, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
    device["chain"], host["chain"] = held_ms(lambda: pipe.degrade_batch(g, hr))
    if host["chain"] >= HOLD_S * 1e3 / 2:
        raise AssertionError(f"one degrade_batch took {host['chain']} ms of host time "
                             f"behind a card held for {HOLD_S} s: it waits for the card")
    return device, host


def degrade_ops_phase(card):
    """Each op of the chain on the card against the CPU at both batches,
    with the TF32 flags off and then on; one degrade_batch of bench.py's
    chain under sync debug mode "error"; its metadata keys against
    BENCH_KEYS; device ms by op, and launches per step from a trace.
    Returns the per-batch chain numbers."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)
    out = {}
    for b in DEGRADE_BATCHES:
        cases = degrade_op_cases(b, seed=b)
        for name, fn, inputs in cases:
            want = flat_tensors(fn(*inputs), name)
            rows = {}
            for flags in (False, True):
                tf32(flags)
                try:
                    got = flat_tensors(fn(*[to_card(x) for x in inputs]), name)
                finally:
                    tf32(False)
                rows[flags] = compare_op(name, got, want, inputs)
            row = {"phase": "degrade_ops", "batch": b, "op": name, **rows[False],
                   "with_tf32_flags": {k: v for k, v in rows[True].items() if k != "by_output"}}
            print(json.dumps(row), flush=True)
            grew = any(rows[True].get(k, 0) > rows[False].get(k, 0) + TF32_GROWTH
                       for k in ("max_abs_err", "pixels_differ_share", "max_level_diff"))
            if not (rows[False]["ok"] and rows[True]["ok"]) or grew:
                raise AssertionError(f"degradation op {name} on the card: {row}")
        del cases

        g = card_generator(7)
        hr = torch.rand(b, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
        pipe.degrade_batch(g, hr)  # warm: tables uploaded once
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lr, meta = pipe.degrade_batch(g, hr)
            mat, keys = pipe.metadata_matrix(meta)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if keys != BENCH_KEYS or mat.shape != (b, len(BENCH_KEYS)):
            raise AssertionError(f"bench chain metadata keys {keys}, expected {BENCH_KEYS}")
        if lr.shape != (b, HR_SIDE // TRAIN_SCALE, HR_SIDE // TRAIN_SCALE, 3) \
                or not torch.isfinite(lr).all():
            raise AssertionError(f"bench chain output {tuple(lr.shape)}")
        device_ms, host_ms = op_device_ms(pipe, b)
        ops = device_ops(lambda: pipe.degrade_batch(g, hr), f"degrade_chain_{b}")
        busy = traced(lambda: pipe.degrade_batch(g, hr), f"degrade_chain_trace_{b}", 3)
        row = {"phase": "degrade_chain", "batch": b, "card": card,
               "no_host_sync": True, "metadata_keys": len(keys),
               "device_ms_by_op": device_ms, "host_ms_by_op": host_ms,
               "launches_per_step": ops["launches"], "launches_by_kind": ops["by_kind"],
               "d2h_copies": ops["d2h_copies"], "busy_us_per_step": busy["busy_us"] / 3,
               "kernels_per_step": busy["kernels_per_call"]}
        print(json.dumps(row), flush=True)
        if ops["d2h_copies"]:
            raise AssertionError(f"the chain copies to the host: {ops}")
        out[b] = row
    return out


def write_eval_pairs(root, rng):
    """Eval pairs as uint8 .npy files at EVAL_LR_SHAPES: textured HR
    images, LR their 4x decimation."""
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for k, (lh, lw) in enumerate(EVAL_LR_SHAPES):
        yy, xx = np.mgrid[:lh * TRAIN_SCALE, :lw * TRAIN_SCALE].astype(np.float32)
        amp = 70.0 * (0.5 + 0.5 * np.sin(xx / (60.0 + 10 * k))) \
            * (0.5 + 0.5 * np.cos(yy / (50.0 + 5 * k)))
        hr = 128.0 + amp[..., None] * rng.standard_normal((*yy.shape, 3), dtype=np.float32)
        hr = np.clip(hr, 0, 255).astype(np.uint8)
        np.save(os.path.join(hr_dir, f"e{k}.npy"), hr)
        np.save(os.path.join(lr_dir, f"e{k}.npy"),
                np.ascontiguousarray(hr[::TRAIN_SCALE, ::TRAIN_SCALE]))
    return lr_dir, hr_dir


@contextlib.contextmanager
def watched(owner, name: str):
    """While the block runs, each call of ``owner.name`` appends its host
    seconds to the list it yields."""
    fn = getattr(owner, name)
    seconds = []

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, wrapper)
    try:
        yield seconds
    finally:
        setattr(owner, name, fn)


def fetch_only_at_batches(fn):
    """Runs ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``, where
    any wait for the card raises, except inside ``utils/metrics.fetch``,
    the evaluation's one copy of a batch's metrics to the host. Returns
    (fn's result, fetches, host seconds)."""
    from rumpy_tpu_torch.utils import metrics
    real, fetches = metrics.fetch, []

    def fetch(values):
        fetches.append(len(values))
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(values)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize()
    metrics.fetch = fetch
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        metrics.fetch = real
    return out, len(fetches), time.perf_counter() - t0


def degrade_train_phase(rcab, card):
    """Full-width RCAN x4 bf16 through cli.train_sisr on HR-only .npy files
    with the example config's [data.online_degradations] table (all seven
    blur families): batch 16, crop 48, 4 steps, every batch degraded on the
    card inside the step. Then steady steps with and without the chain,
    and one warm-up and 3 steps at bench.py's batch 120 with its chain."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.training.trainer import TrainingHandler

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_degrade")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(2))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(4))
    table = load_config(os.path.join(ROOT, EXAMPLE_CONFIG)).as_plain()["data"][
        "online_degradations"]
    internal = dict(RCAN_FULL, dtype="bf16", lr=1e-4, optimizer_type="adam")
    seed = 3
    cfg = {
        "experiment": BLIND_EXP, "experiment_save_loc": os.path.join(root, "experiments"),
        # the eight HR images listed four times: two batches of 16 an epoch;
        # validation on the eval pairs after each epoch
        "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "augmentations": True,
                 "dataloader_threads": 4, "online_degradations": table,
                 "training_sets": {f"data_{i}": {"hr_dir": hr_dir}
                                   for i in range(DEGRADE_SETS)},
                 "eval_sets": {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}},
        "model": {"name": "rcan", "internal_params": internal},
        "training": {"num_epochs": 2, "batch_size": TRAIN_BATCH, "seed": seed},
    }
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)

    # a fixed degraded batch: centre crops of the HR images, degraded once
    pipe = ImagePipeline(table["pipeline"], deg_configs=table["deg_configs"], scale=TRAIN_SCALE)
    names = sorted(os.listdir(hr_dir))
    crops = []
    for name in names * (TRAIN_BATCH // len(names)):
        hr = np.load(os.path.join(hr_dir, name))
        top, left = (hr.shape[0] - HR_SIDE) // 2, (hr.shape[1] - HR_SIDE) // 2
        crops.append(hr[top:top + HR_SIDE, left:left + HR_SIDE])
    fixed_hr = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    lr, _ = pipe.degrade_batch(card_generator(11), fixed_hr)
    fixed = {"lr": lr, "hr": fixed_hr}
    fresh = get_model("rcan")(device="cuda", seed=seed, **internal)
    loss_before = l1_on(fresh, fresh.init_state(seed), fixed)
    del fresh

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards, \
            watched(TrainingHandler, "eval") as validations:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    peak_run = torch.cuda.max_memory_allocated()
    want = {"rcab_fused": 200 * (DEGRADE_STEPS + len(forwards)),
            "rcab_fused_backward": 200 * DEGRADE_STEPS}
    if counts != want or len(forwards) != 2 * VALIDATION_FORWARDS:
        raise AssertionError(f"kernel launches in the blind training run {counts}, "
                             f"expected {want} ({DEGRADE_STEPS} steps and "
                             f"{len(forwards)} validation forwards, expected "
                             f"{2 * VALIDATION_FORWARDS}; 200 RCAB a forward)")
    counts["rcab_fused_validation"] = 200 * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"blind training losses {losses}")
    exp_root = os.path.join(root, "experiments")
    with open(os.path.join(exp_root, BLIND_EXP, "result_outputs", "summary.csv"),
              newline="") as f:
        summary = list(csv.DictReader(f))
    val = {k: [float(r[k]) for r in summary] for k in ("val-PSNR", "val-SSIM")
           if summary and k in summary[0]}
    if sorted(val) != ["val-PSNR", "val-SSIM"] or not all(
            len(v) == 2 and np.isfinite(v).all() for v in val.values()):
        raise AssertionError(f"summary.csv validation columns {summary[0]}: {val}")
    iface = SISRInterface(model_loc=exp_root, experiment=BLIND_EXP, mode="eval",
                          load_epoch="last", device="cuda")
    if iface.state.step != DEGRADE_STEPS:
        raise AssertionError(f"checkpoint holds step {iface.state.step}")
    loss_after = l1_on(iface.model, iface.state, fixed)
    if not loss_after < loss_before:
        raise AssertionError(f"fixed degraded batch loss went {loss_before} -> {loss_after}")
    del iface

    # steady steps on the fixed HR batch through the trainer's own input
    # pipeline, in turns with the same steps on the degraded batch without it
    # (the host's speed moves a step more than the chain does)
    h = TrainingHandler(dict(load_config(cfg_path), no_directories=True), verbose=False)
    # the trainer's validation waits for the card only where it fetches a
    # chunk's metrics
    h.eval(0)
    _, val_fetches, _ = fetch_only_at_batches(lambda: h.eval(0))
    if val_fetches != VALIDATION_FORWARDS:
        raise AssertionError(f"validation fetched {val_fetches} times, expected one "
                             f"fetch per chunk ({VALIDATION_FORWARDS})")
    model = h.model
    input_fn = model.model.input_fn
    with_chain = lambda: model.train_batch(hr=fixed_hr, fetch=False)
    without = lambda: model.train_batch(lr=fixed["lr"], hr=fixed_hr, fetch=False)

    def step_ms_of(chain_on: bool) -> float:
        model.model.set_input_pipeline(input_fn if chain_on else None)
        return cuda_ms(with_chain if chain_on else without, 3, warmup=1, backlog_s=0)

    torch.cuda.reset_peak_memory_stats()
    pairs = [(step_ms_of(True), step_ms_of(False)) for _ in range(3)]
    peak_step = torch.cuda.max_memory_allocated()
    trace_without = traced(without, "blind_train_step_trace_no_chain", 1)
    model.model.set_input_pipeline(input_fn)
    trace = traced(with_chain, "blind_train_step_trace", 1)
    chain = traced(lambda: input_fn(model.model.rng, {"hr": fixed_hr}), "blind_chain_trace", 1)
    del h, model
    step_ms, step_ms_without = (float(np.median([p[i] for p in pairs])) for i in (0, 1))
    hr_mp = TRAIN_BATCH * HR_SIDE ** 2 / 1e6
    row = {"phase": "degrade_train", "model": "rcan x4 10x20x64 bf16", "card": card,
           "config": EXAMPLE_CONFIG, "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH,
           "crop": TRAIN_CROP, "launches": counts, "epoch_train_loss": losses,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "run_experiment_s": seconds, "fixed_batch_loss_before": loss_before,
           "fixed_batch_loss_after": loss_after, "step_ms": step_ms,
           "hr_megapixels_per_s": hr_mp / (step_ms / 1e3),
           "step_ms_without_chain": step_ms_without,
           "step_ms_pairs_with_without_chain": pairs,
           "step_busy_us": trace["busy_us"], "step_busy_us_without_chain": trace_without["busy_us"],
           "chain_busy_us": chain["busy_us"],
           "chain_share_of_step_device_time": chain["busy_us"] / trace["busy_us"],
           "step_idle_share": trace["idle_share"], "kernels_per_step": trace["kernels_per_call"],
           "peak_memory_bytes_run": peak_run, "peak_memory_bytes_step": peak_step,
           "validation_forwards": len(forwards), "validation_s_per_epoch": validations,
           "validation_fetches_under_sync_debug": val_fetches, **val}
    print(json.dumps(row), flush=True)

    # bench.py's workload: batch 120, its chain in the step
    bench_pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)
    handler = get_model("rcan")(device="cuda", lr=1e-4, dtype="bf16", **RCAN_FULL)

    def input_fn(generator, batch):
        lr, _meta = bench_pipe.degrade_batch(generator, batch["hr"])
        return {"lr": lr, "hr": batch["hr"]}

    handler.set_input_pipeline(input_fn)
    state = handler.init_state()
    g = card_generator(0)
    hr120 = torch.rand(BENCH_BATCH, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
    losses120 = []

    def step120():
        _, l = handler.train_batch(state, {"hr": hr120})
        losses120.append(l["train-loss"])

    torch.cuda.reset_peak_memory_stats()
    ms120 = cuda_ms(step120, 3, warmup=1, backlog_s=0)
    peak120 = torch.cuda.max_memory_allocated()
    trace120 = traced(step120, "bench_batch_step_trace", 1)
    row120 = {"phase": "degrade_train_bench_batch", "model": "rcan x4 10x20x64 bf16",
              "card": card, "chain": "bench.py:133-143", "batch": BENCH_BATCH,
              "crop": TRAIN_CROP, "step_ms": ms120,
              "hr_megapixels_per_s": BENCH_BATCH * HR_SIDE ** 2 / 1e6 / (ms120 / 1e3),
              "peak_memory_bytes": peak120, "step_busy_us": trace120["busy_us"],
              "step_idle_share": trace120["idle_share"],
              "losses": [float(x) for x in losses120]}
    print(json.dumps(row120), flush=True)
    if not np.isfinite(row120["losses"]).all():
        raise AssertionError(f"batch-120 losses {row120['losses']}")
    del handler, state, hr120
    shutil.rmtree(os.path.join(root, "data"))
    return row, row120, (exp_root, eval_lr, eval_hr)


# Metrics on the card against the CPU on the same fetched arrays: the same
# elementwise float32 arithmetic (no convolution, so no TF32), the final
# means summed in another order.
METRIC_PSNR_TOL, METRIC_SSIM_TOL = 1e-5, 1e-6
EVAL_COLUMNS = [("bicubic", "PSNR"), ("bicubic", "SSIM"), ("bicubic", "runtime"),
                (BLIND_EXP, "PSNR"), (BLIND_EXP, "SSIM"), (BLIND_EXP, "runtime")]


def read_metrics_csv(path):
    """individual_metrics.csv as (columns, {image: [values]})."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0][0] != "model" or rows[1][0] != "metric" or rows[2][0] != "image":
        raise AssertionError(f"{path}: header rows {rows[:3]}")
    return (list(zip(rows[0][1:], rows[1][1:])),
            {r[0]: [float(v) for v in r[1:]] for r in rows[3:]})


def eval_phase(rcab, card, exp_root, lr_dir, hr_dir):
    """The blind experiment through cli.eval_sisr (epoch best, then last;
    PSNR, SSIM, --time_models) on the eval pairs: the CSV's rows and columns,
    finite values, 200 RCAB launches a forward. Then, for each eval image,
    the metrics on the card against the CPU on the same fetched SR and HR
    arrays, and bicubic against the CPU and the CSV; one DIV2K forward and
    one image's metrics by CUDA events; one EvalHub run that waits for the
    card only at its per-image fetch: images/s and peak memory."""
    from rumpy_tpu_torch.cli import eval_sisr
    from rumpy_tpu_torch.data.datasets import SuperResImages
    from rumpy_tpu_torch.device import true_div
    from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.ops.resize import pil_resize
    from rumpy_tpu_torch.utils import metrics
    from rumpy_tpu_torch.utils.color import rgb_to_ycbcr

    out_root = os.path.join(os.path.dirname(exp_root), "eval")
    images = len(EVAL_LR_SHAPES)
    want_forwards = images + len(set(EVAL_LR_SHAPES))  # a warm-up per shape
    flags = ["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir", lr_dir,
             "--hr_dir", hr_dir, "-m", "PSNR", "-m", "SSIM", "--time_models"]
    cli, launches = {}, 0
    for epoch in ("best", "last"):
        out = os.path.join(out_root, epoch)
        rcab.launches = 0
        with watched(SISRInterface, "net_run") as forwards:
            t0 = time.perf_counter()
            eval_sisr.main(flags + ["-me", BLIND_EXP, epoch, "--out_loc", out])
            seconds = time.perf_counter() - t0
        columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
        cli[epoch] = {"seconds": seconds, "forwards": len(forwards),
                      "rcab_launches": rcab.launches, "rows": len(values),
                      "mean": dict(zip([f"{m}>{k}" for m, k in columns],
                                       np.mean(list(values.values()), axis=0).tolist()))}
        launches += rcab.launches
        if columns != EVAL_COLUMNS or len(values) != images or not np.isfinite(
                list(values.values())).all():
            raise AssertionError(f"eval_sisr {epoch}: columns {columns}, {len(values)} "
                                 f"rows, expected {EVAL_COLUMNS} and {images} finite rows")
        if len(forwards) != want_forwards or rcab.launches != 200 * len(forwards):
            raise AssertionError(f"eval_sisr {epoch}: {len(forwards)} forwards (expected "
                                 f"{want_forwards}), {rcab.launches} RCAB launches")

    # the card's metrics against the CPU's on the same fetched arrays
    iface = SISRInterface(model_loc=exp_root, experiment=BLIND_EXP, mode="eval",
                          load_epoch="last", device="cuda")
    ds = SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=TRAIN_SCALE)
    hub = metrics.Metrics(["PSNR", "SSIM"])

    def y(img):
        return rgb_to_ycbcr(img.clamp(0.0, 1.0), y_only=True, im_type="jpg")[None]

    _, csv_last = read_metrics_csv(os.path.join(out_root, "last", "individual_metrics.csv"))
    err = {"model": [0.0, 0.0], "bicubic": [0.0, 0.0]}
    bicubic_vs_csv, bicubic_identical = 0.0, True
    for i in range(len(ds)):
        item = ds[i]
        lr, hr = torch.from_numpy(item["lr"]), torch.from_numpy(item["hr"])
        sr = iface.net_run(lr[None].cuda())[0][0]
        lr_u8 = (lr.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        size = (lr.shape[0] * TRAIN_SCALE, lr.shape[1] * TRAIN_SCALE)
        u8_card, u8_cpu = pil_resize(lr_u8.cuda(), size), pil_resize(lr_u8, size)
        bic_card = true_div(u8_card.float(), 255.0)
        bic_cpu = true_div(u8_cpu.float(), 255.0)
        bicubic_identical &= torch.equal(u8_card.cpu(), u8_cpu) and torch.equal(
            bic_card.cpu(), bic_cpu)
        for name, card_img in (("model", sr), ("bicubic", bic_card)):
            on_card = metrics.fetch(hub.compute(y(card_img), y(hr.cuda())))
            on_cpu = metrics.fetch(hub.compute(y(card_img.cpu()), y(hr)))
            for j, k in enumerate(("PSNR", "SSIM")):
                err[name][j] = max(err[name][j], abs(on_card[k][0] - on_cpu[k][0]))
            if name == "bicubic":
                bicubic_vs_csv = max(bicubic_vs_csv,
                                     abs(csv_last[item["tag"]][0] - on_cpu["PSNR"][0]))
    check = {"phase": "eval_metrics_card_vs_cpu", "card": card, "images": len(ds),
             "model_psnr_max_abs_db": err["model"][0], "model_ssim_max_abs": err["model"][1],
             "bicubic_psnr_max_abs_db": err["bicubic"][0],
             "bicubic_ssim_max_abs": err["bicubic"][1],
             "bicubic_resize_bit_identical": bicubic_identical,
             "bicubic_csv_vs_cpu_max_abs_db": bicubic_vs_csv,
             "tol_psnr_db": METRIC_PSNR_TOL, "tol_ssim": METRIC_SSIM_TOL}
    print(json.dumps(check), flush=True)
    if not (max(err["model"][0], err["bicubic"][0], bicubic_vs_csv) <= METRIC_PSNR_TOL
            and max(err["model"][1], err["bicubic"][1]) <= METRIC_SSIM_TOL
            and bicubic_identical):
        raise AssertionError(f"metrics on the card disagree with the CPU: {check}")

    # one DIV2K-sized forward, and one image's PSNR + SSIM, by CUDA events
    x = torch.from_numpy(ds[0]["lr"])[None].cuda()
    forward_ms, forward_host_ms = held_ms(
        lambda: iface.model.run_eval(iface.state, {"lr": x}), iters=1)
    sr_y, hr_y = y(iface.net_run(x)[0][0]), y(torch.from_numpy(ds[0]["hr"]).cuda())
    metric_ms, metric_host_ms = held_ms(lambda: hub.compute(sr_y, hr_y), iters=2)
    del iface

    # a whole evaluation that waits for the card only where it fetches an
    # image's metrics
    hub_eval = EvalHub(models=[{"experiment": BLIND_EXP, "epoch": "last"}],
                       model_loc=exp_root, data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir},
                       out_loc=os.path.join(out_root, "no_sync"), scale=TRAIN_SCALE,
                       device="cuda")
    rcab.launches = 0
    hub_eval.full_image_protocol()  # warm: resize matrices uploaded
    torch.cuda.reset_peak_memory_stats()
    table, fetches, seconds = fetch_only_at_batches(hub_eval.full_image_protocol)
    peak = torch.cuda.max_memory_allocated()
    launches += rcab.launches
    if fetches != images or len(table.images) != images:
        raise AssertionError(f"EvalHub fetched {fetches} times for {images} images")
    row = {"phase": "eval", "model": "rcan x4 10x20x64 bf16", "card": card,
           "images": images, "lr_shapes": sorted(set(EVAL_LR_SHAPES)),
           "eval_sisr": cli, "eval_images_per_s": images / seconds,
           "eval_seconds": seconds, "fetches_under_sync_debug": fetches,
           "peak_memory_bytes_eval": peak,
           "forward_div2k_device_ms": forward_ms, "forward_div2k_host_ms": forward_host_ms,
           "metrics_div2k_device_ms": metric_ms, "metrics_div2k_host_ms": metric_host_ms,
           "rcab_launches": launches}
    print(json.dumps(row), flush=True)
    shutil.rmtree(os.path.dirname(lr_dir))
    return row


READER_FILE = os.path.join("rumpy_tpu", "pretrained", "supmoco_heldout_d256", "saved_models",
                           "train_model_20")
# Its array leaves, and the sha256 of their "path shape dtype" lines in file
# order, as flax.serialization.msgpack_restore reads them.
READER_LEAVES = 85
READER_DIGEST = "c9e4728d1690a04dd6edd9e7b1556cf093d819f1b58980f3ed954a730f6c1ac3"


def reader_phase(card):
    """The port's pure-Python flax-msgpack reader on a packaged encoder
    checkpoint of the JAX package (a data file), with msgpack unimportable:
    leaf count, paths, shapes and dtypes against flax's reading, the MoCo
    queue's shape and dtype, and the read time."""
    import hashlib
    import importlib.util
    from rumpy_tpu_torch.utils import flax_msgpack
    installed = importlib.util.find_spec("msgpack") is not None
    saved = sys.modules.get("msgpack")
    sys.modules["msgpack"] = None
    try:
        t0 = time.perf_counter()
        with open(os.path.join(ROOT, READER_FILE), "rb") as f:
            blob = flax_msgpack.msgpack_restore(f.read())
        seconds = time.perf_counter() - t0
    finally:
        if saved is None:
            del sys.modules["msgpack"]
        else:
            sys.modules["msgpack"] = saved

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, tree

    lines = [f"{'/'.join(p)} {tuple(np.shape(v))} {v.dtype}" for p, v in leaves(blob["arrays"])]
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    queue = blob["arrays"]["extra"]["queue"]
    meta = json.loads(bytes(blob["meta_json"]))
    row = {"phase": "reader", "card": card, "file": READER_FILE,
           "msgpack_installed": installed, "leaves": len(lines), "digest_ok":
           digest == READER_DIGEST, "queue": [list(queue.shape), str(queue.dtype)],
           "model_name": meta.get("model_name"), "read_ms": seconds * 1e3}
    print(json.dumps(row), flush=True)
    if (len(lines) != READER_LEAVES or digest != READER_DIGEST
            or queue.shape != (8192, 256) or queue.dtype != np.float32):
        raise AssertionError(f"the flax-msgpack reader: {row}")
    return row


# -- BoBW: QRCAN's blocks on the fused kernel with per-image gate inputs -------

# A QRCAB's shapes on the BoBW path: bench.py's BoBW batch (96 of 48x48
# LR crops), the example config's batch 16, one DIV2K x4 eval image; the
# train shape in f32 too; then every batch of the joint phase (the launch
# plan depends on N) that is not among them. Tolerances as for the shared
# form (F32_ATOL, BF16_REL_ULP forward; BWD_F32_REL, BWD_BF16_REL backward).
BOBW_BENCH_BATCH = 96  # bench.py:196
# The joint step's batches: K = 8192 refuses bench.py's BoBW batch 96
JOINT_BATCHES = (16, 64)
QRCAB_SHAPES = [((BOBW_BENCH_BATCH, TRAIN_CROP, TRAIN_CROP, 64), torch.bfloat16),
                (TRAIN_SHAPE, torch.bfloat16), ((1, *DIV2K_LR, 64), torch.bfloat16),
                (TRAIN_SHAPE, torch.float32)]
QRCAB_SHAPES += [((n, TRAIN_CROP, TRAIN_CROP, 64), torch.bfloat16) for n in JOINT_BATCHES
                 if (n, TRAIN_CROP, TRAIN_CROP, 64) not in [sh for sh, _ in QRCAB_SHAPES]]
# the per-image form's other eval shapes (meta-attention and BoBW runs):
# validation's chunk of four DIV2K images and each Set5 image
QRCAB_SHAPES += [(s, torch.bfloat16) for s in EVAL_SHAPES
                 if (s, torch.bfloat16) not in QRCAB_SHAPES]
QRCAB_GRAD_NAMES = GRAD_NAMES + ["dscale"]


# A launch's per-image gate inputs (bd, bu, scale): all three here; the
# styles launch others (max_concat with a q-layer: bd and the scale;
# mini_concat: bu; modulate: the scale), which launch_coverage_phase holds
# where a path launched them.
ALL_PER_IMAGE = (True, True, True)


def qrcab_inputs(shape, dtype, seed, form=ALL_PER_IMAGE):
    """rcab_inputs with a QRCAB's per-image gate inputs where ``form``
    says: bd (N, R) as max_concat makes it, bu (N, C) as mini_concat does,
    and a q-layer's sigmoid gate (N, C) in (0, 1) as the scale (else
    None)."""
    n, _, _, c = shape
    args = rcab_inputs(shape, dtype, seed)
    r = args[5].shape[1]
    g = torch.Generator().manual_seed(seed + 1)
    bd = (args[6].cpu() + 0.3 * torch.randn(n, r, generator=g)).cuda()
    bu = (args[8].cpu() + 0.3 * torch.randn(n, c, generator=g)).cuda()
    scale = torch.sigmoid(torch.randn(n, c, generator=g)).cuda()
    if form[0]:
        args[6] = bd
    if form[1]:
        args[8] = bu
    return args, (scale if form[2] else None)


def qrcab_check(rcab, shape, dtype, seed, form=ALL_PER_IMAGE, backward=True,
                phase="qrcab_kernel"):
    """The forward kernel, and with ``backward`` the backward kernel, with
    the gate inputs of ``form`` (per image or shared) at one shape against
    their plain versions, two runs bit for bit, and the ms of a call beside the shared
    form's at the same shape and the bound. Marks the shape, dtype and form
    held in those directions. Returns the row (backward numbers None
    without ``backward``)."""
    args, scale = qrcab_inputs(shape, dtype, seed, form)
    res = 1.0 if scale is None else scale
    ref = rcab.rcab_reference(*args, res_scale=res)
    got = rcab.rcab_fused(*args, res_scale=res)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = (F32_ATOL if dtype == torch.float32
           else BF16_REL_ULP * ref.float().abs().max().item())
    runs = [rcab._forward(*args, scale, 1.0)[:2] for _ in range(2)]
    identical = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs, ref, got
    bound, bound_by = rcab_bound_ms(shape, dtype)
    iters = 5 if shape[0] * shape[1] * shape[2] > 100_000 else 20
    rel_tol = BWD_F32_REL if dtype == torch.float32 else BWD_BF16_REL
    row = {
        "phase": phase, "shape": shape, "dtype": str(dtype).split(".")[-1],
        "per_image": [k for k, on in zip(("bd", "bu", "scale"), form) if on],
        "max_abs_err": err, "tol": tol,
        "bwd_worst_rel_err": None, "bwd_rel_tol": rel_tol if backward else None,
        "grads": None,
        "ms": cuda_ms(lambda: rcab.rcab_fused(*args, res_scale=res), iters),
        "plain_ms": cuda_ms(lambda: rcab.rcab_reference(*args, res_scale=res), iters),
        "bound_ms": bound, "bound_by": bound_by,
        "backward_ms": None, "backward_plain_ms": None,
        "backward_bound_ms": None, "backward_bound_by": None,
        "library_conv_ms": library_conv_ms(shape) if dtype == torch.bfloat16 else None}
    shared = rcab_inputs(shape, dtype, seed=seed)
    with unrecorded():  # a yardstick: the shared form at this shape
        row["shared_form_ms"] = cuda_ms(lambda: rcab.rcab_fused(*shared), iters)
    row["shared_form_backward_ms"] = None

    if backward:
        leaves = [a.clone().requires_grad_(True) for a in args]
        s_leaf = None if scale is None else scale.clone().requires_grad_(True)
        s_arg = 1.0 if s_leaf is None else s_leaf
        dout = torch.randn(*shape, generator=torch.Generator().manual_seed(
            seed + 100)).cuda().to(dtype)
        before = rcab.backward_launches
        out = rcab.rcab_fused(*leaves, res_scale=s_arg)
        tensors = leaves if s_leaf is None else leaves + [s_leaf]
        grads = torch.autograd.grad(out, tensors, dout, retain_graph=True)
        again = torch.autograd.grad(out, tensors, dout, retain_graph=True)
        torch.cuda.synchronize()
        if rcab.backward_launches != before + 2:
            raise AssertionError("the backward kernel was not launched")
        identical = identical and all(torch.equal(a, b) for a, b in zip(grads, again))
        want = rcab.rcab_backward_reference(dout, *args, res_scale=res)
        errs, worst = {}, 0.0
        for name, a, b in zip(QRCAB_GRAD_NAMES, grads, want):
            ref_max = b.float().abs().max().item()
            e = (a.float() - b.float()).abs().max().item()
            errs[name] = {"max_abs_err": e, "ref_abs_max": ref_max}
            worst = max(worst, e / max(ref_max, 1e-30))
            if a.shape != b.shape or not e <= rel_tol * ref_max:
                raise AssertionError(f"qrcab backward: {name} disagrees at {shape} {dtype} "
                                     f"{form}: {errs[name]}, rel tol {rel_tol}")
        del again, want
        ref_out = rcab.rcab_reference(*leaves, res_scale=s_arg)
        shared_leaves = [a.clone().requires_grad_(True) for a in shared]
        row["backward_bound_ms"], row["backward_bound_by"] = rcab_bwd_bound_ms(shape, dtype)
        row.update(
            bwd_worst_rel_err=worst, grads=errs,
            backward_ms=cuda_ms(lambda: torch.autograd.grad(
                out, tensors, dout, retain_graph=True), iters),
            backward_plain_ms=cuda_ms(lambda: torch.autograd.grad(
                ref_out, tensors, dout, retain_graph=True), iters))
        with unrecorded():
            shared_out = rcab.rcab_fused(*shared_leaves)
            row["shared_form_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                shared_out, shared_leaves, dout, retain_graph=True), iters)
        del leaves, s_leaf, out, grads, ref_out, shared_out, shared_leaves
    row["bit_identical_runs"] = identical
    print(json.dumps(row), flush=True)
    if not err <= tol:
        raise AssertionError(f"qrcab forward disagrees with rcab_reference: {row}")
    if not identical:
        raise AssertionError(f"qrcab kernels: two runs differ at {shape} {dtype} {form}")
    for direction in ("forward", "backward") if backward else ("forward",):
        CHECKED[direction].add(launch_key(args[0], args[6], args[8], scale))
    del args, shared
    torch.cuda.empty_cache()
    return row


def qrcab_kernel_phase(rcab):
    """qrcab_check with bd, bu and the scale per image at QRCAB_SHAPES.
    Returns the rows."""
    return [qrcab_check(rcab, shape, dtype, 400 + i)
            for i, (shape, dtype) in enumerate(QRCAB_SHAPES)]


BOBW_CONFIG = os.path.join("examples", "train_bobw_rcan_supmoco.toml")
BOBW_EXP = "rcan_supmoco_bobw"  # the example's experiment name
BOBW_FULL = dict(scale=4, n_feats=64, n_resgroups=10, n_resblocks=20)  # bench.py:198-200
PACKAGED_ENCODER = "supmoco_fullchain_d256"


def conv_calls(fn):
    """Runs ``fn`` counting F.conv2d calls by (out, in, kh, kw) weight
    shape. A QRCAB on the kernel makes none; the generator's other 3x3
    64->64 convs are the ten group tails and the body tail."""
    import torch.nn.functional as F
    real, counts = F.conv2d, collections.Counter()

    def counted(x, weight, *a, **kw):
        counts[tuple(weight.shape)] += 1
        return real(x, weight, *a, **kw)

    F.conv2d = counted
    try:
        fn()
    finally:
        F.conv2d = real
    return counts


def bobw_train_phase(rcab, card):
    """The BoBW flagship through cli.train_sisr: a copy of the example
    config (full width, bf16, frozen packaged encoder, the seven-family
    chain), paths rewritten to HR-only .npy files and eval pairs, 2 epochs
    of 2 steps, validating each epoch. Then bench.py's BoBW operating
    point: batch 96, LR crop 48, block_encoder_loading, bench.py's chain,
    1 warm-up and 3 timed steps."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.training.trainer import TrainingHandler
    from rumpy_tpu_torch.utils import checkpoint as ckpt
    from rumpy_tpu_torch.utils.weights import state_dict_from_jax

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_bobw")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(5))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(6))
    cfg = load_config(os.path.join(ROOT, BOBW_CONFIG)).as_plain()
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr,
                                           "metadata_file": "on_site"}}
    cfg["training"].update(num_epochs=2)
    seed, batch = cfg["training"]["seed"], cfg["training"]["batch_size"]
    internal = cfg["model"]["internal_params"]
    if {k: internal[k] for k in BOBW_FULL} != BOBW_FULL or batch != TRAIN_BATCH:
        raise AssertionError(f"{BOBW_CONFIG} is not full-width BoBW at batch 16: {internal}")
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    table = cfg["data"]["online_degradations"]

    # a fixed degraded batch: centre crops of the HR images, degraded once
    pipe = ImagePipeline(table["pipeline"], deg_configs=table["deg_configs"], scale=TRAIN_SCALE)
    names = sorted(os.listdir(hr_dir))
    crops = []
    for name in names * (batch // len(names)):
        hr = np.load(os.path.join(hr_dir, name))
        top, left = (hr.shape[0] - HR_SIDE) // 2, (hr.shape[1] - HR_SIDE) // 2
        crops.append(hr[top:top + HR_SIDE, left:left + HR_SIDE])
    fixed_hr = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    lr, _ = pipe.degrade_batch(card_generator(12), fixed_hr)
    fixed = {"lr": lr, "hr": fixed_hr}
    fresh = get_model(cfg["model"]["name"])(device="cuda", seed=seed, **internal)
    loss_before = l1_on(fresh, fresh.init_state(seed), fixed)
    del fresh

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards, \
            watched(TrainingHandler, "eval") as validations:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    peak_run = torch.cuda.max_memory_allocated()
    want = {"rcab_fused": 200 * (DEGRADE_STEPS + len(forwards)),
            "rcab_fused_backward": 200 * DEGRADE_STEPS}
    if counts != want or len(forwards) != 2 * VALIDATION_FORWARDS:
        raise AssertionError(f"kernel launches in the BoBW run {counts}, expected {want} "
                             f"({DEGRADE_STEPS} steps, {len(forwards)} validation forwards, "
                             f"expected {2 * VALIDATION_FORWARDS}; 200 QRCAB a forward)")
    counts["rcab_fused_validation"] = 200 * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"BoBW training losses {losses}")
    with open(os.path.join(exp_root, BOBW_EXP, "result_outputs", "summary.csv"),
              newline="") as f:
        summary = list(csv.DictReader(f))
    val = {k: [float(r[k]) for r in summary] for k in ("val-PSNR", "val-SSIM")
           if summary and k in summary[0]}
    if sorted(val) != ["val-PSNR", "val-SSIM"] or not all(
            len(v) == 2 and np.isfinite(v).all() for v in val.values()):
        raise AssertionError(f"summary.csv validation columns of the BoBW run: {val}")
    iface = SISRInterface(model_loc=exp_root, experiment=BOBW_EXP, mode="eval",
                          load_epoch="last", device="cuda")
    if iface.state.step != DEGRADE_STEPS:
        raise AssertionError(f"BoBW checkpoint holds step {iface.state.step}")
    loss_after = l1_on(iface.model, iface.state, fixed)
    if not loss_after < loss_before:
        raise AssertionError(f"BoBW fixed batch loss went {loss_before} -> {loss_after}")

    # the frozen encoder: weights bit for bit the packaged ones, BatchNorm
    # running statistics moved by the train steps
    enc_dir = ckpt.resolve_packaged(PACKAGED_ENCODER)
    raw = ckpt.load_checkpoint(ckpt.checkpoint_path(enc_dir, ckpt.select_epoch(enc_dir, "last")))
    packaged = state_dict_from_jax(raw["network"], iface.model.module.encoder,
                                   batch_stats=raw["extra"]["q_bstats"])
    trained = {k[len("encoder."):]: v.cpu() for k, v in iface.state.params.items()
               if k.startswith("encoder.")}
    stat_keys = [k for k in packaged if k.endswith(("running_mean", "running_var"))]
    weights_identical = all(torch.equal(trained[k], v) for k, v in packaged.items()
                            if k not in stat_keys)
    stats_moved = sum(not torch.equal(trained[k], packaged[k]) for k in stat_keys)
    if not weights_identical or stats_moved != len(stat_keys):
        raise AssertionError(f"frozen encoder: weights identical {weights_identical}, "
                             f"{stats_moved} of {len(stat_keys)} running statistics moved")
    del iface

    # bench.py's BoBW operating point
    bench_pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)
    handler = get_model("contrastiveblindqrcan")(
        device="cuda", block_encoder_loading=True, lr=1e-4, dtype="bf16", **BOBW_FULL)

    def input_fn(generator, b):
        lr, _meta = bench_pipe.degrade_batch(generator, b["hr"])
        return {"lr": lr, "hr": b["hr"]}

    handler.set_input_pipeline(input_fn)
    state = handler.init_state()
    g = card_generator(1)
    hr96 = torch.rand(BOBW_BENCH_BATCH, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
    losses96 = []

    def step96():
        _, l = handler.train_batch(state, {"hr": hr96})
        losses96.append(l["train-loss"])

    torch.cuda.reset_peak_memory_stats()
    ms96 = cuda_ms(step96, 3, warmup=1, backlog_s=0)
    peak96 = torch.cuda.max_memory_allocated()
    rcab.launches = rcab.backward_launches = 0
    convs = conv_calls(step96)
    torch.cuda.synchronize()
    step_launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    convs_64 = convs[(64, 64, 3, 3)]
    from rumpy_tpu_torch.models.common import Conv
    # every Conv of that shape in the pipeline but the 200 QRCABs' two each
    other_64 = sum(1 for m in handler.module.modules()
                   if isinstance(m, Conv) and tuple(m.weight.shape) == (64, 64, 3, 3)) - 400
    trace96 = traced(step96, "bobw_bench_step_trace", 1)
    row = {"phase": "bobw_train", "model": "contrastiveblindqrcan x4 10x20x64 bf16, frozen "
           f"{PACKAGED_ENCODER}", "card": card, "config": BOBW_CONFIG,
           "steps": DEGRADE_STEPS, "batch": batch, "crop": TRAIN_CROP, "launches": counts,
           "epoch_train_loss": losses, "run_experiment_s": seconds,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "fixed_batch_loss_before": loss_before, "fixed_batch_loss_after": loss_after,
           "encoder_weights_bit_identical": weights_identical,
           "encoder_running_stats_moved": stats_moved, "peak_memory_bytes_run": peak_run,
           "validation_forwards": len(forwards), "validation_s_per_epoch": validations, **val,
           "bench": {"chain": "bench.py:133-143", "batch": BOBW_BENCH_BATCH,
                     "crop": TRAIN_CROP, "step_ms": ms96,
                     "hr_megapixels_per_s": BOBW_BENCH_BATCH * HR_SIDE ** 2 / 1e6 / (ms96 / 1e3),
                     "peak_memory_bytes": peak96, "launches_a_step": step_launches,
                     "conv2d_calls_64x64x3x3_a_step": convs_64,
                     "conv2d_calls_a_step": sum(convs.values()),
                     "kernels_a_step": trace96["kernels_per_call"],
                     "device_busy_ms_a_step": trace96["busy_us"] / 1e3,
                     "step_idle_share": trace96["idle_share"],
                     "device_us_by_family": trace96["per_call_device_us"],
                     "kernels_by_family": trace96["per_call_kernels_by_family"],
                     "losses": [float(x) for x in losses96]}}
    print(json.dumps(row), flush=True)
    # a QRCAB runs no cuDNN conv: the only 3x3 64->64 conv2d calls of a
    # step are the other Convs of that shape (ten group tails, the body tail
    # and the encoder's second conv), one call each
    if (step_launches != {"rcab_fused": 200, "rcab_fused_backward": 200}
            or convs_64 != other_64 or other_64 != 12):
        raise AssertionError(f"a BoBW step: {step_launches}, {convs_64} conv2d calls of "
                             f"3x3 64->64 weights (expected 200, 200 and {other_64} = 12)")
    # and the profiler sees each pass of the kernels 200 times
    traced_passes = {k: trace96["per_call_kernels_by_family"].get(k) for k in (
        "rcab_conv1_mma", "rcab_conv2_mma", "rcab_apply", "rcab_bwd_dh1_mma", "rcab_bwd_dx_mma",
        "rcab_bwd_wgrad_mma")}
    if set(traced_passes.values()) != {200}:
        raise AssertionError(f"a traced BoBW step's kernel passes: {traced_passes}")
    if not np.isfinite(row["bench"]["losses"]).all():
        raise AssertionError(f"batch-96 BoBW losses {row['bench']['losses']}")
    del handler, state, hr96
    shutil.rmtree(os.path.join(root, "data"))
    return row, (exp_root, eval_lr, eval_hr)


def bobw_eval_phase(rcab, card, exp_root, lr_dir, hr_dir):
    """The BoBW run through cli.eval_sisr (epoch best, --time_models):
    the CSV's columns and rows, 200 QRCAB launches a forward; then one
    EvalHub run's images/s and one DIV2K-sized forward's device ms."""
    from rumpy_tpu_torch.cli import eval_sisr
    from rumpy_tpu_torch.data.datasets import SuperResImages
    from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
    from rumpy_tpu_torch.interface import SISRInterface

    out = os.path.join(os.path.dirname(exp_root), "eval")
    images = len(EVAL_LR_SHAPES)
    want_forwards = images + len(set(EVAL_LR_SHAPES))  # a warm-up per shape
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        lr_dir, "--hr_dir", hr_dir, "-m", "PSNR", "-m", "SSIM",
                        "--time_models", "-me", BOBW_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    want_columns = [(m, k) for m, k in EVAL_COLUMNS if m == "bicubic"] + [
        (BOBW_EXP, k) for m, k in EVAL_COLUMNS if m == BLIND_EXP]
    if columns != want_columns or len(values) != images or not np.isfinite(
            list(values.values())).all():
        raise AssertionError(f"eval_sisr of the BoBW run: columns {columns}, {len(values)} rows")
    if len(forwards) != want_forwards or launches != 200 * len(forwards):
        raise AssertionError(f"eval_sisr of the BoBW run: {len(forwards)} forwards (expected "
                             f"{want_forwards}), {launches} QRCAB launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    hub = EvalHub(models=[{"experiment": BOBW_EXP, "epoch": "best"}], model_loc=exp_root,
                  data_cfg={"lr_dir": lr_dir, "hr_dir": hr_dir},
                  out_loc=os.path.join(out, "hub"), scale=TRAIN_SCALE, device="cuda")
    hub.full_image_protocol()  # warm
    rcab.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hub.full_image_protocol()
    torch.cuda.synchronize()
    hub_seconds = time.perf_counter() - t0
    launches += rcab.launches
    peak = torch.cuda.max_memory_allocated()

    iface = SISRInterface(model_loc=exp_root, experiment=BOBW_EXP, mode="eval",
                          load_epoch="best", device="cuda")
    ds = SuperResImages(lr_dir=lr_dir, hr_dir=hr_dir, scale=TRAIN_SCALE)
    x = torch.from_numpy(ds[0]["lr"])[None].cuda()
    forward = lambda: iface.model.run_eval(iface.state, {"lr": x})
    forward_ms = cuda_ms(forward, 1, warmup=1, backlog_s=1.0)
    # a forward is about 2,200 launches, more than the card's queue holds:
    # behind a held card the host would wait for the hold, so the host's
    # own time is the wall time of calls back to back
    forward_wall_ms = cuda_ms(forward, 3, warmup=1, backlog_s=0)
    trace = traced(forward, "bobw_eval_forward_trace", 1)
    row = {"phase": "bobw_eval", "model": "contrastiveblindqrcan x4 10x20x64 bf16",
           "card": card, "images": images, "eval_sisr_s": cli_seconds,
           "eval_sisr_forwards": len(forwards), "mean": mean,
           "eval_images_per_s": images / hub_seconds, "eval_seconds": hub_seconds,
           "peak_memory_bytes_eval": peak, "forward_div2k_device_ms": forward_ms,
           "forward_div2k_wall_ms": forward_wall_ms,
           "forward_div2k_busy_ms": trace["busy_us"] / 1e3,
           "forward_div2k_device_us_by_family": trace["per_call_device_us"],
           "forward_div2k_kernels": trace["kernels_per_call"], "rcab_launches": launches}
    print(json.dumps(row), flush=True)
    shutil.rmtree(os.path.dirname(exp_root))
    return row


PREDICTOR_CONFIG = os.path.join("examples", "train_supmoco_predictor.toml")
PREDICTOR_EXP = "supmoco_predictor"  # the example's experiment name
PREDICTOR_FULL = dict(dim=256, K=8192)
PREDICTOR_BATCH, PREDICTOR_CROP, PREDICTOR_VIEWS = 32, 64, 5
PREDICTOR_STEPS = 4  # 2 epochs of 2 steps
PREDICTOR_SETS = PREDICTOR_STEPS * PREDICTOR_BATCH // (2 * TRAIN_IMAGES)
EVAL_VIEWS_AN_IMAGE = 8
# Clustering scores on the card (float64) against the CPU's on the same
# embeddings: two float64 sums in other orders.
CLUSTER_RTOL = 1e-6


def write_predictor_eval_set(root, hr_dir, card_seed):
    """An eval set as the JAX package's offline pipeline lays it out: LR
    .npy files degraded by the example's chain on the card (64 x 64 from
    256 x 256 HR crops, EVAL_VIEWS_AN_IMAGE an HR image) and
    degradation_metadata.csv (image, then a column per metadata key),
    written with the csv module. The columns are in the sorted order of
    the online chain's metadata matrix: the regression trainer labels an
    eval set by the column indices of its training chain's keys (as the
    JAX package does), so a CSV in the offline pipeline's step order is
    read under the wrong keys. The same LR files with the CSV in that step
    order (the JAX offline pipeline's layout) go to a second folder, so
    that the run shows what the fault does. Returns both folders (sorted,
    step order)."""
    from rumpy_tpu_torch.config.loader import load_config
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    table = load_config(os.path.join(ROOT, PREDICTOR_CONFIG)).as_plain()["data"][
        "online_degradations"]
    pipe = ImagePipeline(table["pipeline"], deg_configs=table["deg_configs"], scale=TRAIN_SCALE)
    side = PREDICTOR_CROP * TRAIN_SCALE
    rng = np.random.default_rng(21)
    crops, names = [], []
    for name in sorted(os.listdir(hr_dir)):
        hr = np.load(os.path.join(hr_dir, name))
        for v in range(EVAL_VIEWS_AN_IMAGE):
            top = int(rng.integers(0, hr.shape[0] - side))
            left = int(rng.integers(0, hr.shape[1] - side))
            crops.append(hr[top:top + side, left:left + side])
            names.append(f"{os.path.splitext(name)[0]}_{v}.npy")
    hr_t = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    lr, meta = pipe.degrade_batch(card_generator(card_seed), hr_t)
    lr = (lr.clamp(0, 1) * 255.0).round().to(torch.uint8).cpu().numpy()
    dirs = []
    for folder, keys in (("lr", sorted(meta)), ("lr_step_order", list(meta))):
        lr_dir = os.path.join(root, folder)
        os.makedirs(lr_dir)
        for name, img in zip(names, lr):
            np.save(os.path.join(lr_dir, name), img)
        cols = [meta[k].float().cpu().numpy() for k in keys]
        with open(os.path.join(lr_dir, "degradation_metadata.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["image"] + keys)
            for i, name in enumerate(names):
                w.writerow([name] + [repr(float(c[i])) for c in cols])
        dirs.append(lr_dir)
    return dirs


def contrastive_train_phase(card):
    """The SupMoCo predictor through cli.train_sisr on a copy of
    examples/train_supmoco_predictor.toml at its widths (dim 256, K 8192,
    batch 32, LR crop 64 from 256 x 256 HR views, 5 crops an image: its
    crop_count of 2 would give SupMoCo one positive where it takes 4) and
    its chain on the card, 2 epochs of 2 steps, contrastive evaluation each
    epoch on an eval set written here. Then one fixed batch, 1 warm-up and
    3 steps of the trainer's own step (views degraded in one pass, classes
    on the card, train_batch); the queue, the label queue, the momentum
    update and no host sync in a step; last, a warm start from the
    packaged supmoco_fullchain_d256 by name and its clustering scores on
    the card beside the CPU's. Returns the row and the run's saved_models
    directory."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.evaluation.contrastive_eval import ContrastiveEval, clustering_scores
    from rumpy_tpu_torch.models.contrastive import momentum_update
    from rumpy_tpu_torch.training.regression_trainer import RegressionTrainingHandler

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_contrastive")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(20))
    eval_lr, eval_lr_steps = write_predictor_eval_set(os.path.join(root, "eval_data"),
                                                      hr_dir, 22)
    cfg = load_config(os.path.join(ROOT, PREDICTOR_CONFIG)).as_plain()
    internal = cfg["model"]["internal_params"]
    if ({k: internal[k] for k in PREDICTOR_FULL} != PREDICTOR_FULL
            or cfg["training"]["batch_size"] != PREDICTOR_BATCH
            or cfg["data"]["crop"] != PREDICTOR_CROP):
        raise AssertionError(f"{PREDICTOR_CONFIG} is not SupMoCo dim 256, K 8192 at batch 32, "
                             f"crop 64: {cfg}")
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    del cfg["data"]["crop_count"]  # the trainer takes SupMoCo's 4 positives: 5 crops
    cfg["data"]["dataloader_threads"] = 8
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir}
                                    for i in range(PREDICTOR_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "metadata_file": "on_site"}}
    cfg["training"].update(num_epochs=2)
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with watched(RegressionTrainingHandler, "eval") as evals:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    scores = {k: [stats[e].get(k) for e in sorted(stats)]
              for k in ("val-davies_bouldin", "val-calinski_harabasz", "val-silhouette")}
    if len(losses) != 2 or not np.isfinite(losses).all() or not all(
            np.isfinite(v).all() for v in scores.values() if None not in v):
        raise AssertionError(f"predictor run: losses {losses}, scores {scores}")
    if any(None in v for v in scores.values()):
        raise AssertionError(f"predictor run: no clustering scores {scores}")
    saved = os.path.join(exp_root, PREDICTOR_EXP, "saved_models")
    enc = os.path.join(exp_root, PREDICTOR_EXP, "result_outputs", "encodings_epoch_1.npz")
    if not os.path.isfile(os.path.join(saved, "train_model_1")) or not os.path.isfile(enc):
        raise AssertionError("predictor run: no checkpoint or embedding dump of epoch 1")

    # the trainer's own step on one fixed batch
    cfg_fixed = dict(cfg, no_directories=True)
    trainer = RegressionTrainingHandler(load_config_from(cfg_fixed, root, "fixed.toml"),
                                        verbose=False)
    handler = trainer.model.model
    side = PREDICTOR_CROP * TRAIN_SCALE
    rng = np.random.default_rng(23)
    views = []
    for k in range(PREDICTOR_BATCH):
        hr = np.load(os.path.join(hr_dir, f"im{k % TRAIN_IMAGES}.npy"))
        for _ in range(PREDICTOR_VIEWS):
            top = int(rng.integers(0, hr.shape[0] - side))
            left = int(rng.integers(0, hr.shape[1] - side))
            views.append(hr[top:top + side, left:left + side])
    hr_views = torch.from_numpy(np.stack(views).astype(np.float32) / 255.0).cuda().reshape(
        PREDICTOR_BATCH, PREDICTOR_VIEWS, side, side, 3)
    step_losses = []

    def step():
        db = trainer._assemble_contrastive_batch(trainer._degrade_views({"hr": hr_views}))
        trainer.model.state, losses = handler.train_batch(trainer.model.state, db)
        step_losses.append(losses["train-loss"])
        return db

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, 3, warmup=1, backlog_s=0)
    peak = torch.cuda.max_memory_allocated()
    trace = traced(step, "contrastive_step_trace", 1)
    # one step checked: no host sync, the queue and label queue, the
    # momentum update
    mod = handler.module
    ptr = int(mod.queue_ptr)
    key_before = [p.detach().clone() for p in mod.key_encoder.parameters()]
    want_key = [p.detach().clone() for p in mod.key_encoder.parameters()]
    query = torch.nn.Module()
    query.p = torch.nn.ParameterList([torch.nn.Parameter(p.detach().clone())
                                      for p in mod.encoder.parameters()])
    key = torch.nn.Module()
    key.p = torch.nn.ParameterList([torch.nn.Parameter(p) for p in want_key])
    momentum_update(key, query, handler.m)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        db = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    new_ptr = int(mod.queue_ptr)
    labels_written = torch.equal(mod.queue_labels[ptr:ptr + PREDICTOR_BATCH], db["labels"])
    momentum_exact = all(torch.equal(a, b.detach()) for a, b in zip(
        mod.key_encoder.parameters(), key.p))
    key_moved = not all(torch.equal(a, b) for a, b in zip(mod.key_encoder.parameters(),
                                                           key_before))
    fixed_losses = [float(x) for x in step_losses]

    # the packaged encoder, warm-started by name, on the eval set
    cfg_warm = dict(cfg, no_directories=True)
    cfg_warm["training"] = dict(cfg["training"], warm_start=PACKAGED_ENCODER)
    warm = RegressionTrainingHandler(load_config_from(cfg_warm, root, "warm.toml"),
                                     verbose=False)
    ce = ContrastiveEval(warm.model.model, warm.model.state, m_map=warm._m_map,
                         valid=warm._valid, mags=warm._mags, num_classes=warm._num_classes)
    emb, labels = ce.generate_data_encoding(warm.eval_data)
    t1 = time.perf_counter()
    card_scores = clustering_scores(emb, labels)
    card_scores_s = time.perf_counter() - t1
    cpu_scores = clustering_scores(emb.cpu(), labels.cpu())
    score_rel = {k: abs(card_scores[k] - cpu_scores[k]) / max(abs(cpu_scores[k]), 1e-30)
                 for k in cpu_scores}
    # the same eval images with the CSV in the JAX offline pipeline's step
    # order: labelled by the chain's sorted key indices (a fault of both
    # packages, ROADMAP.md section 3), they fall into other classes
    cfg_steps = dict(cfg_warm, data=dict(cfg["data"], eval_sets={
        "data_1": {"lr_dir": eval_lr_steps, "metadata_file": "on_site"}}))
    steps_run = RegressionTrainingHandler(load_config_from(cfg_steps, root, "steps.toml"),
                                          verbose=False)
    ce_steps = ContrastiveEval(steps_run.model.model, steps_run.model.state,
                               m_map=steps_run._m_map, valid=steps_run._valid,
                               mags=steps_run._mags, num_classes=steps_run._num_classes)
    emb_steps, labels_steps = ce_steps.generate_data_encoding(steps_run.eval_data)
    step_order = {"classes_present": int(torch.unique(labels_steps).numel()),
                  "same_embeddings": bool(torch.equal(emb_steps, emb)),
                  "scores_card": clustering_scores(emb_steps, labels_steps)}
    del steps_run, ce_steps
    row = {"phase": "contrastive_train", "model": "supmoco dim 256, K 8192, DASR encoder",
           "card": card, "config": PREDICTOR_CONFIG, "batch": PREDICTOR_BATCH,
           "crop": PREDICTOR_CROP, "views_an_image": PREDICTOR_VIEWS,
           "classes": trainer._num_classes, "steps": PREDICTOR_STEPS,
           "epoch_train_loss": losses, "val_scores": scores, "run_experiment_s": seconds,
           "contrastive_eval_s": evals,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "peak_memory_bytes_run": peak_run,
           "fixed_batch": {"step_ms": ms,
                           "views_per_s": PREDICTOR_BATCH * PREDICTOR_VIEWS / (ms / 1e3),
                           "peak_memory_bytes": peak, "kernels_a_step": trace["kernels_per_call"],
                           "device_busy_ms_a_step": trace["busy_us"] / 1e3,
                           "step_idle_share": trace["idle_share"],
                           "device_us_by_family": trace["per_call_device_us"],
                           "queue_ptr": [ptr, new_ptr], "label_queue_written": labels_written,
                           "key_encoder_moved": key_moved,
                           "momentum_update_bit_identical": momentum_exact,
                           "losses": fixed_losses, "no_host_sync_in_a_step": True},
           "packaged_warm_start": {"name": PACKAGED_ENCODER, "eval_images": int(emb.shape[0]),
                                   "classes_present": int(torch.unique(labels).numel()),
                                   "scores_card": card_scores, "scores_cpu": cpu_scores,
                                   "scores_rel_diff": score_rel, "scores_card_s": card_scores_s,
                                   "step_order_csv": step_order}}
    print(json.dumps(row), flush=True)
    if new_ptr != (ptr + PREDICTOR_BATCH) % PREDICTOR_FULL["K"] or not labels_written:
        raise AssertionError(f"predictor step: queue_ptr {ptr} -> {new_ptr}, labels written "
                             f"{labels_written}")
    if not (momentum_exact and key_moved):
        raise AssertionError(f"predictor step: key encoder moved {key_moved}, by the momentum "
                             f"update bit for bit {momentum_exact}")
    if not np.isfinite(fixed_losses).all():
        raise AssertionError(f"predictor fixed-batch losses {fixed_losses}")
    if set(card_scores) != set(cpu_scores) or len(cpu_scores) != 3 or max(
            score_rel.values()) > CLUSTER_RTOL:
        raise AssertionError(f"clustering scores on the card {card_scores}, CPU {cpu_scores}")
    del trainer, handler, warm, hr_views
    torch.cuda.empty_cache()
    return row, saved


def load_config_from(cfg, root, name):
    """``cfg`` written to ``root/name`` and read back as the trainer reads
    a config file."""
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    path = os.path.join(root, name)
    dump_toml(cfg, path)
    return load_config(path)


JOINT_CROP_COUNT = 3


def joint_batch(pipe, hr_dir, batch, seed, m_map, valid, mags, classes):
    """A joint BoBW batch: JOINT_CROP_COUNT HR crops of 192 x 192 an
    image, degraded in one pass by bench.py's chain with one set of draws
    an image (crop 0 is the SR and query view, its HR the target), and
    the images' classes from the port's assign_classes."""
    from rumpy_tpu_torch.models import contrastive_labelling as cl
    rng = np.random.default_rng(seed)
    views = []
    for k in range(batch):
        hr = np.load(os.path.join(hr_dir, f"im{k % TRAIN_IMAGES}.npy"))
        for _ in range(JOINT_CROP_COUNT):
            top = int(rng.integers(0, hr.shape[0] - HR_SIDE))
            left = int(rng.integers(0, hr.shape[1] - HR_SIDE))
            views.append(hr[top:top + HR_SIDE, left:left + HR_SIDE])
    hr_t = torch.from_numpy(np.stack(views).astype(np.float32) / 255.0).cuda()
    with torch.no_grad():
        lr, meta = pipe.degrade_batch(card_generator(seed), hr_t, views=JOINT_CROP_COUNT)
    mat, _ = pipe.metadata_matrix(meta)
    labels = cl.assign_classes(mat, m_map, valid, mags, classes)
    lr = lr.reshape(batch, JOINT_CROP_COUNT, TRAIN_CROP, TRAIN_CROP, 3)
    hr_t = hr_t.reshape(batch, JOINT_CROP_COUNT, HR_SIDE, HR_SIDE, 3)[:, 0].contiguous()
    return {"lr": lr, "hr": hr_t, "labels": labels}


def bobw_joint_phase(rcab, card, predictor_dir):
    """Joint BoBW at full width (QRCAN 10x20x64, max_concat with q-layers,
    pre-q, bf16): combined_loss_mode "supmoco" with a trainable encoder
    warm-started by load_encoder from the predictor run that
    contrastive_train wrote, LR crop 48, crop_count 3, K 8192, batch 16 and
    64: 1 warm-up and 3 steps each, then one step of "moco". Each step:
    200 forward and 200 backward RCAB launches, the encoder's convs (key
    forward and pipeline forward) and its running statistics advanced once,
    the queue and its labels written, finite losses. Returns the row."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.models import contrastive_labelling as cl
    from rumpy_tpu_torch.models.common import BatchNorm
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_joint")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(30))
    pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)
    _, keys = pipe.metadata_matrix(pipe.degrade_batch(
        card_generator(0), torch.zeros(1, 32, 32, 3, device="cuda"))[1])
    m_map = {k: i for i, k in enumerate(cl.register_metadata(keys))}
    valid, mags, classes = cl.partition_metadata(m_map)
    common = dict(device="cuda", dtype="bf16", lr=1e-4, crop_count=JOINT_CROP_COUNT,
                  contrastive_K=PREDICTOR_FULL["K"], num_classes=classes,
                  pre_trained_encoder_weights=predictor_dir, **BOBW_FULL)
    rcab.launches = rcab.backward_launches = 0
    rows = []
    for mode, batches, steps in (("supmoco", JOINT_BATCHES, 3), ("moco", JOINT_BATCHES[:1], 1)):
        handler = get_model("contrastiveblindqrcan")(combined_loss_mode=mode, **common)
        state = handler.init_state()
        mod = handler.module
        counts = collections.Counter()
        hooks = [c.register_forward_pre_hook(lambda m, a: counts.update(["encoder_conv"]))
                 for enc in (mod.encoder, mod.key_encoder) for c in enc.convs]
        hooks += [m.register_forward_pre_hook(
            lambda m, a: counts.update(["stats_update"] if len(a) > 1 and a[1]
                                       and (len(a) < 3 or a[2]) else []))
            for enc in (mod.encoder, mod.key_encoder) for m in enc.modules()
            if isinstance(m, BatchNorm)]
        for b in batches:
            batch = joint_batch(pipe, hr_dir, b, 31 + b, m_map, valid, mags, classes)
            losses = []

            def step():
                nonlocal state
                state, l = handler.train_batch(state, batch)
                losses.append(l)

            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, steps, warmup=1 if steps > 1 else 0, backlog_s=0)
            peak = torch.cuda.max_memory_allocated()
            counts.clear()
            before = (rcab.launches, rcab.backward_launches)
            ptr = int(mod.queue_ptr)
            stats0 = [n.running_mean.clone() for n in mod.encoder.norms]
            step()
            torch.cuda.synchronize()
            launches = {"rcab_fused": rcab.launches - before[0],
                        "rcab_fused_backward": rcab.backward_launches - before[1]}
            step_counts = dict(counts)
            new_ptr = int(mod.queue_ptr)
            stats_moved = sum(not torch.equal(s, n.running_mean)
                              for s, n in zip(stats0, mod.encoder.norms))
            labels_ok = (mode != "supmoco" or torch.equal(
                mod.queue_labels[ptr:ptr + b], batch["labels"]))
            trace = traced(step, f"bobw_joint_{mode}_{b}_trace", 1) if steps > 1 else None
            vals = {k: [float(l[k]) for l in losses] for k in losses[0]}
            row = {"mode": mode, "batch": b, "step_ms": ms,
                   "hr_megapixels_per_s": b * HR_SIDE ** 2 / 1e6 / (ms / 1e3),
                   "peak_memory_bytes": peak, "launches_a_step": launches,
                   "encoder_conv2d_calls_a_step": step_counts.get("encoder_conv", 0),
                   "encoder_stats_updates_a_step": step_counts.get("stats_update", 0),
                   "encoder_running_means_moved": stats_moved,
                   "queue_ptr": [ptr, new_ptr], "label_queue_written": labels_ok,
                   "losses": vals}
            if trace is not None:
                row.update(kernels_a_step=trace["kernels_per_call"],
                           device_busy_ms_a_step=trace["busy_us"] / 1e3,
                           step_idle_share=trace["idle_share"],
                           device_us_by_family=trace["per_call_device_us"])
            print(json.dumps({"phase": "bobw_joint", "card": card, **row}), flush=True)
            rows.append(row)
            if launches != {"rcab_fused": 200, "rcab_fused_backward": 200}:
                raise AssertionError(f"a joint BoBW step launched {launches}")
            if (row["encoder_conv2d_calls_a_step"] != 12
                    or row["encoder_stats_updates_a_step"] != 6 or stats_moved != 6):
                raise AssertionError(f"a joint BoBW step's encoder: {row}")
            if new_ptr != (ptr + b) % PREDICTOR_FULL["K"] or not labels_ok:
                raise AssertionError(f"a joint BoBW step's queue: {row}")
            if not all(np.isfinite(v).all() for v in vals.values()):
                raise AssertionError(f"joint BoBW losses {vals}")
        for h in hooks:
            h.remove()
        del handler, state, batch
        torch.cuda.empty_cache()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    shutil.rmtree(root)
    return {"phase": "bobw_joint_total", "launches": launches, "rows": rows}


META_CONFIG = os.path.join("examples", "train_qrcan_meta_attention.toml")
META_EXP = "qrcan_x4_bobw"  # the example's experiment name
META_FULL = dict(scale=4, style="max_concat", include_q_layer=True, dtype="bf16",
                 metadata=["sigma_x", "sigma_y", "kernel_type"])


def degrade_eval_set(root, table, card_seed, rng):
    """Eval pairs at EVAL_LR_SHAPES as the JAX package's offline pipeline
    lays them out: HR .npy files, their LR made on the card by the chain in
    ``table`` one image at a time (each its own draws), quantised to uint8,
    and degradation_metadata.csv (image, then each step's metadata keys in
    step order; a list value as JSON), written with the csv module.
    Returns (lr_dir, hr_dir, {key: the images' values stacked})."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    lr_dir, hr_dir = write_eval_pairs(root, rng)
    pipe = ImagePipeline(table["pipeline"], deg_configs=table["deg_configs"], scale=TRAIN_SCALE)
    g = card_generator(card_seed)
    names = sorted(os.listdir(hr_dir))
    metas = []
    for name in names:
        hr = torch.from_numpy(np.load(os.path.join(hr_dir, name)).astype(np.float32) / 255.0)
        with torch.no_grad():
            lr, meta = pipe.degrade_batch(g, hr[None].cuda())
        np.save(os.path.join(lr_dir, name),
                (lr[0].clamp(0, 1) * 255.0).round().to(torch.uint8).cpu().numpy())
        metas.append(meta)
    keys = list(metas[0])
    with open(os.path.join(lr_dir, "degradation_metadata.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["image"] + keys)
        for name, meta in zip(names, metas):
            w.writerow([name] + [json.dumps(meta[k][0].tolist()) if meta[k].dim() > 1
                                 else repr(float(meta[k][0])) for k in keys])
    return lr_dir, hr_dir, {k: torch.cat([m[k] for m in metas]) for k in keys}


def fixed_hr_batch(hr_dir, batch):
    """Centre crops of HR_SIDE of the HR images, on the card."""
    names = sorted(os.listdir(hr_dir))
    crops = []
    for name in (names * batch)[:batch]:
        hr = np.load(os.path.join(hr_dir, name))
        top, left = (hr.shape[0] - HR_SIDE) // 2, (hr.shape[1] - HR_SIDE) // 2
        crops.append(hr[top:top + HR_SIDE, left:left + HR_SIDE])
    return torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()


def step_row(rcab, handler, state, batch, name, steps=2):
    """One warm-up and ``steps`` timed train steps of ``handler`` on
    ``batch`` (its input pipeline on), then one counted step: step ms,
    HR-MP/s, peak memory, RCAB launches and conv2d calls a step, losses."""
    losses = []

    def step():
        _, l = handler.train_batch(state, batch)
        losses.append(l["train-loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, steps, warmup=1, backlog_s=0)
    peak = torch.cuda.max_memory_allocated()
    rcab.launches = rcab.backward_launches = 0
    convs = conv_calls(step)
    torch.cuda.synchronize()
    n = batch["hr"].shape[0]
    row = {"model": name, "batch": n, "step_ms": ms,
           "hr_megapixels_per_s": n * HR_SIDE ** 2 / 1e6 / (ms / 1e3),
           "peak_memory_bytes": peak,
           "launches_a_step": {"rcab_fused": rcab.launches,
                               "rcab_fused_backward": rcab.backward_launches},
           "conv2d_calls_a_step": sum(convs.values()),
           "losses": [float(x) for x in losses]}
    if not np.isfinite(row["losses"]).all():
        raise AssertionError(f"{name}: losses {row['losses']}")
    return row


def meta_attention_phase(rcab, card):
    """The paper's non-blind meta-attention setting at full width: a copy of
    examples/train_qrcan_meta_attention.toml (QRCAN 10x20x64, max_concat
    with q-layers, bf16, on the chain's sigma_x, sigma_y and kernel_type)
    through cli.train_sisr, 2 epochs of 2 steps on HR-only .npy files,
    validating each epoch on eval pairs whose LR the example's chain makes
    on the card and whose degradation_metadata.csv is written here; then
    cli.eval_sisr --metadata_file on the run, an EvalHub run that waits for
    the card only where it fetches an image's metrics, the trainer's
    metadata matrix against the CSV's for the same images and draws, and
    steady steps at batch 16. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.data.datasets import SuperResImages
    from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.training.trainer import TrainingHandler

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_meta")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(40))
    cfg = load_config(os.path.join(ROOT, META_CONFIG)).as_plain()
    internal = cfg["model"]["internal_params"]
    if ({k: internal[k] for k in META_FULL} != META_FULL or any(
            k in internal for k in ("n_feats", "n_resgroups", "n_resblocks"))
            or cfg["training"]["batch_size"] != TRAIN_BATCH):
        raise AssertionError(f"{META_CONFIG} is not full-width QRCAN max_concat bf16 at "
                             f"batch 16: {internal}")
    table = cfg["data"]["online_degradations"]
    eval_lr, eval_hr, eval_meta = degrade_eval_set(os.path.join(root, "eval_data"), table, 41,
                                                   np.random.default_rng(42))
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr,
                                           "metadata_file": "on_site"}}
    cfg["training"].update(num_epochs=2)
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    train_launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    want = {"rcab_fused": 200 * (DEGRADE_STEPS + len(forwards)),
            "rcab_fused_backward": 200 * DEGRADE_STEPS}
    if train_launches != want or len(forwards) != 2 * VALIDATION_FORWARDS:
        raise AssertionError(f"kernel launches in the meta-attention run {train_launches}, "
                             f"expected {want} ({len(forwards)} validation forwards, "
                             f"expected {2 * VALIDATION_FORWARDS})")
    train_launches["rcab_fused_validation"] = 200 * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    if len(losses) != 2 or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]).all():
        raise AssertionError(f"meta-attention run: losses {losses}, validation {val}")

    # the run through cli.eval_sisr, the CSV given by --metadata_file
    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "--metadata_file",
                        os.path.join(eval_lr, "degradation_metadata.csv"), "-m", "PSNR",
                        "-m", "SSIM", "--time_models", "-me", META_EXP, "best",
                        "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    want_columns = [(m, k) for m, k in EVAL_COLUMNS if m == "bicubic"] + [
        (META_EXP, k) for m, k in EVAL_COLUMNS if m == BLIND_EXP]
    if columns != want_columns or len(values) != images or not np.isfinite(
            list(values.values())).all():
        raise AssertionError(f"eval_sisr of the meta-attention run: columns {columns}, "
                             f"{len(values)} rows")
    want_forwards = images + len(set(EVAL_LR_SHAPES))  # a warm-up a shape
    if len(eval_forwards) != want_forwards or eval_launches != 200 * want_forwards:
        raise AssertionError(f"eval_sisr: {len(eval_forwards)} forwards, {eval_launches} "
                             f"launches (expected {want_forwards} and 200 each)")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))
    hub = EvalHub(models=[{"experiment": META_EXP, "epoch": "best"}], model_loc=exp_root,
                  data_cfg={"lr_dir": eval_lr, "hr_dir": eval_hr, "metadata_file": "on_site"},
                  out_loc=os.path.join(out, "hub"), scale=TRAIN_SCALE, device="cuda")
    hub.full_image_protocol()  # warm
    rcab.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _, fetches, hub_seconds = fetch_only_at_batches(hub.full_image_protocol)
    eval_launches += rcab.launches
    peak_eval = torch.cuda.max_memory_allocated()
    if fetches != images or rcab.launches != 200 * images:
        raise AssertionError(f"EvalHub with metadata: {fetches} fetches, {rcab.launches} "
                             f"launches for {images} images")
    del hub

    # the matrix the model trains on against the one it is scored on, for
    # the eval images and their draws: the trainer's own input function
    # (its chain's output replaced by the eval set's) against the CSV read
    # by SuperResImages and narrowed by the handler
    trainer = TrainingHandler(dict(load_config(cfg_path), no_directories=True), verbose=False)
    handler, state = trainer.model.model, trainer.model.state
    trainer.online_pipeline.degrade_batch = lambda g, hr, views=1: (hr, eval_meta)
    train_mat = handler.input_fn(handler.rng, {"hr": torch.zeros(images, 8, 8, 3,
                                                                 device="cuda")})["metadata"]
    del trainer.online_pipeline.degrade_batch
    train_mat = train_mat.cpu().numpy()
    ds = SuperResImages(lr_dir=eval_lr, hr_dir=eval_hr, scale=TRAIN_SCALE,
                        metadata_file="on_site")
    eval_mat = handler.select_metadata(np.stack([ds[i]["metadata"] for i in range(images)]),
                                       keys=ds.metadata_keys)
    lo, hi = train_mat.min(0), train_mat.max(0)
    csv_keys = [k for k in ds.metadata_keys if any(
        k == r or k.endswith(f"-{r}") for r in handler.metadata_keys)]
    comparison = {
        "train_columns": handler.metadata_keys, "eval_columns": csv_keys,
        "max_abs_diff_by_column": np.abs(eval_mat - train_mat).max(0).tolist(),
        "train_range_by_column": [lo.tolist(), hi.tolist()],
        "eval_is_train_min_max_normalised": bool(np.allclose(
            eval_mat, (train_mat - lo) / np.where(hi > lo, hi - lo, 1.0), atol=1e-6))}

    # steady steps at batch 16: the trainer's input pipeline (chain and
    # metadata columns) on a fixed HR batch
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    steps = step_row(rcab, handler, state, {"hr": hr16},
                     "qrcan x4 10x20x64 max_concat q-layer bf16")
    if steps["launches_a_step"] != {"rcab_fused": 200, "rcab_fused_backward": 200}:
        raise AssertionError(f"a meta-attention step launched {steps['launches_a_step']}")
    trace = traced(lambda: handler.train_batch(state, {"hr": hr16}),
                   "meta_attention_step_trace", 1)
    del trainer, handler, state
    row = {"phase": "meta_attention", "model": "qrcan x4 10x20x64 max_concat q-layer bf16",
           "card": card, "config": META_CONFIG, "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH,
           "crop": TRAIN_CROP, "launches": train_launches, "epoch_train_loss": losses,
           **val, "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "eval_sisr_s": cli_seconds, "eval_mean": mean, "eval_rcab_launches": eval_launches,
           "eval_images_per_s": images / hub_seconds, "eval_seconds": hub_seconds,
           "metadata_fetches_under_sync_debug": fetches, "peak_memory_bytes_eval": peak_eval,
           "train_vs_eval_metadata": comparison, "fixed_batch": steps,
           "step_busy_ms": trace["busy_us"] / 1e3, "step_idle_share": trace["idle_share"],
           "kernels_a_step": trace["kernels_per_call"]}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


STYLE_SHAPES = [(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP), (1, *DIV2K_LR)]


def bobw_family_phase(rcab, card):
    """The rest of the BoBW family at full width, bf16, batch 16, crop 48,
    bench.py's chain in the step: contrastiveblindqedsr (QEDSR 16x64 with
    q-layers) on the packaged frozen encoder, contrastiveblindqrcan in
    srmd_mode (the 256-wide embedding tiled and concatenated to the input;
    its QRCABs stay on the kernel) and in sft_mode (an SFT layer in every
    QRCAB: the plain route). One warm-up and one timed step each, then one
    counted step. Then one forward of QRCAN 10x20x64 (256 metadata values,
    q-layers) in the softmax and extended_attention styles (plain route)
    beside max_concat (the kernel) at 16x48x48 and 1x339x510. Returns the
    rows."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.registry import get_model

    bench_pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)

    def input_fn(generator, b):
        lr, _meta = bench_pipe.degrade_batch(generator, b["hr"])
        return {"lr": lr, "hr": b["hr"]}

    g = card_generator(50)
    hr = torch.rand(TRAIN_BATCH, HR_SIDE, HR_SIDE, 3, device=g.device, generator=g)
    cases = [("contrastiveblindqedsr", "qedsr x4 16x64 q-layers, frozen packaged encoder",
              dict(pre_trained_encoder_weights=PACKAGED_ENCODER), 0),
             ("contrastiveblindqrcan", "qrcan x4 10x20x64 srmd_mode",
              dict(srmd_mode=True, block_encoder_loading=True, **BOBW_FULL), 200),
             ("contrastiveblindqrcan", "qrcan x4 10x20x64 sft_mode",
              dict(sft_mode=True, block_encoder_loading=True, **BOBW_FULL), 0)]
    rows = []
    for name, label, kw, launches in cases:
        handler = get_model(name)(device="cuda", dtype="bf16", lr=1e-4, **kw)
        handler.set_input_pipeline(input_fn)
        row = step_row(rcab, handler, handler.init_state(), {"hr": hr}, label, steps=1)
        rows.append(row)
        print(json.dumps({"phase": "bobw_family", "card": card, **row}), flush=True)
        if row["launches_a_step"] != {"rcab_fused": launches, "rcab_fused_backward": launches}:
            raise AssertionError(f"{label}: {row['launches_a_step']}, expected {launches} each")
        del handler
        torch.cuda.empty_cache()

    forwards = []
    for style in ("max_concat", "softmax", "extended_attention"):
        handler = get_model("qrcan")(device="cuda", dtype="bf16", style=style,
                                     metadata_bypass_len=256, include_q_layer=True)
        state = handler.init_state()
        for n, h, w in STYLE_SHAPES:
            x = torch.rand(n, h, w, 3, device="cuda")
            meta = torch.rand(n, 256, device="cuda")
            fwd = lambda: handler.run_eval(state, {"lr": x, "metadata": meta})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rcab.launches = 0
            fwd()
            torch.cuda.synchronize()
            counted, peak = rcab.launches, torch.cuda.max_memory_allocated()
            ms = cuda_ms(fwd, 1, warmup=0, backlog_s=0)  # warmed by the counted call
            trace = traced(fwd, f"qrcan_{style}_{n}x{h}x{w}_forward_trace", 1)
            forwards.append({"style": style, "shape": [n, h, w, 64], "wall_ms": ms,
                             "busy_ms": trace["busy_us"] / 1e3,
                             "kernels": trace["kernels_per_call"], "rcab_launches": counted,
                             "peak_memory_bytes": peak})
            want = 200 if style == "max_concat" else 0
            if counted != want:
                raise AssertionError(f"a {style} QRCAN forward launched {counted}, not {want}")
        del handler, state
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "bobw_family_forwards", "card": card, "forwards": forwards}),
          flush=True)
    return {"phase": "bobw_family", "rows": rows, "forwards": forwards,
            "launches": sum(r["launches_a_step"]["rcab_fused"] for r in rows)
            + sum(f["rcab_launches"] for f in forwards),
            "backward_launches": sum(r["launches_a_step"]["rcab_fused_backward"] for r in rows)}


MAPS_CHAIN = {"pipeline": [["srmdgaussianblur", "b"], ["downsample", "d"]],
              "deg_configs": {"b": {"random": True, "rate_iso": 0.5,
                                    "request_pca_kernels": True,
                                    "load_pca_matrix": "standard"},
                              "d": {"scale": TRAIN_SCALE}}}
MAPS_MODELS = ("srmd", "edsrmd", "sftmd")  # full width: 12x128; 16x64; 16x64 standard


def metadata_maps_phase(rcab, card):
    """SRMD, EDSRMD and SFTMD at full width, bf16, on the 10-value PCA
    blur-kernel metadata (the packaged ``standard`` matrix) of
    srmdgaussianblur (iso and aniso) then x4: each through cli.train_sisr,
    one epoch of 2 steps at batch 16, crop 48 (DEGRADE_SETS copies of the
    eight HR images); then the three scored
    together by cli.eval_sisr --metadata_file on eval pairs whose LR the
    chain makes on the card (the CSV's blur_kernel column a JSON list, as
    the JAX offline pipeline writes it); then steady steps of each. No
    RCAB kernel runs here. Returns the rows."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.training.trainer import TrainingHandler

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_maps")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(60))
    eval_lr, eval_hr, _ = degrade_eval_set(os.path.join(root, "eval_data"), MAPS_CHAIN, 61,
                                           np.random.default_rng(62))
    exp_root = os.path.join(root, "experiments")
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    rows = []
    rcab.launches = rcab.backward_launches = 0
    for name in MAPS_MODELS:
        cfg = {"experiment": name, "experiment_save_loc": exp_root,
               "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "dataloader_threads": 4,
                        "metadata": ["blur_kernel"], "online_degradations": MAPS_CHAIN,
                        "training_sets": {f"data_{i}": {"hr_dir": hr_dir}
                                          for i in range(DEGRADE_SETS)}},
               "model": {"name": name, "internal_params": {
                   "scale": TRAIN_SCALE, "lr": 1e-4, "dtype": "bf16",
                   "metadata": ["blur_kernel"]}},
               "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 0}}
        cfg_path = os.path.join(root, f"{name}.toml")
        dump_toml(cfg, cfg_path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = train_sisr.main(["-p", cfg_path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_run = torch.cuda.max_memory_allocated()
        trainer = TrainingHandler(dict(load_config(cfg_path), no_directories=True),
                                  verbose=False)
        handler = trainer.model.model
        if handler.num_metadata != 10:
            raise AssertionError(f"{name} takes {handler.num_metadata} metadata values, not 10")
        row = step_row(rcab, handler, trainer.model.state, {"hr": hr16}, name)
        row.update(train_loss=stats[0]["train-loss"], run_experiment_s=seconds,
                   peak_memory_bytes_run=peak_run,
                   parameters=sum(p.numel() for p in handler.module.parameters()))
        rows.append(row)
        print(json.dumps({"phase": "metadata_maps", "card": card, **row}), flush=True)
        if not np.isfinite(row["train_loss"]):
            raise AssertionError(f"{name}: train loss {row['train_loss']}")
        del trainer, handler
        torch.cuda.empty_cache()
    out = os.path.join(root, "eval")
    flags = ["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir", eval_lr,
             "--hr_dir", eval_hr, "--metadata_file", "on_site", "-m", "PSNR", "-m", "SSIM",
             "--out_loc", out]
    for name in MAPS_MODELS:
        flags += ["-me", name, "last"]
    t0 = time.perf_counter()
    eval_sisr.main(flags)
    cli_seconds = time.perf_counter() - t0
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    want = sorted([("bicubic", k) for k in ("PSNR", "SSIM", "runtime")]
                  + [(m, k) for m in MAPS_MODELS for k in ("PSNR", "SSIM")])
    if columns != want or len(values) != len(EVAL_LR_SHAPES) or not np.isfinite(
            list(values.values())).all():
        raise AssertionError(f"eval_sisr of the metadata-map models: {columns}, "
                             f"{len(values)} rows")
    if rcab.launches or rcab.backward_launches:
        raise AssertionError("an RCAB kernel ran in the metadata-map models")
    summary = {"phase": "metadata_maps", "card": card, "chain": MAPS_CHAIN,
               "eval_sisr_s": cli_seconds,
               "eval_mean": dict(zip([f"{m}>{k}" for m, k in columns],
                                     np.mean(list(values.values()), axis=0).tolist()))}
    print(json.dumps(summary), flush=True)
    shutil.rmtree(root)
    return {**summary, "rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rumpy_tpu_torch.ops.cuda import build
    from rumpy_tpu_torch.ops.cuda import local_entropy as ent
    from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab
    from rumpy_tpu_torch.ops.cuda import window_sum as win

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)

    t0 = time.perf_counter()
    build.build_all(["rcab_fused", "rcab_fused_bwd", "local_entropy", "window_sum"])
    record_launches(rcab)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "nvcc_seconds": build.build_seconds}), flush=True)

    main_row, train_row, eval_rows, bf16_err = kernel_phase(rcab)
    bwd_row = rcab_bwd_phase(rcab)
    serve_launches = slice_phase(rcab, card)
    ent_row = entropy_phase(ent)
    front_phase(ent)
    win_row = window_phase(ent, win)
    train_launches = train_phase(rcab, ent, win, card)
    degrade_ops_phase(card)
    blind_row, _, eval_dirs = degrade_train_phase(rcab, card)
    blind_launches = blind_row["launches"]
    eval_row = eval_phase(rcab, card, *eval_dirs)
    reader_phase(card)
    qrcab_rows = qrcab_kernel_phase(rcab)
    bobw_row, bobw_dirs = bobw_train_phase(rcab, card)
    bobw_eval_row = bobw_eval_phase(rcab, card, *bobw_dirs)
    bobw_launches = bobw_row["launches"]
    with unrecorded():
        rcab_bwd_c128_phase(rcab)
        rcab_bwd_f32_sums_phase(rcab)
    _, predictor_dir = contrastive_train_phase(card)
    joint = bobw_joint_phase(rcab, card, predictor_dir)
    print(json.dumps(joint), flush=True)
    shutil.rmtree(os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_contrastive"))
    joint_launches = joint["launches"]
    meta_row = meta_attention_phase(rcab, card)
    meta_launches = meta_row["launches"]
    family = bobw_family_phase(rcab, card)
    metadata_maps_phase(rcab, card)
    qrcab_rows += [r for r in launch_coverage_phase(rcab) if r["per_image"]]
    per_image = [{k: r[k] for k in (
        "shape", "dtype", "per_image", "ms", "shared_form_ms", "plain_ms", "bound_ms", "max_abs_err",
        "backward_ms", "shared_form_backward_ms", "backward_plain_ms", "backward_bound_ms",
        "bwd_worst_rel_err")} for r in qrcab_rows]

    kernels = [{
        "name": "rcab_fused", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/rcab_fused.cu",
        "replaces": "rumpy_tpu/ops/pallas/rcab_fused.py:73",
        "launches": (serve_launches + train_launches["rcab_fused"]
                     + blind_launches["rcab_fused"] + eval_row["rcab_launches"]
                     + bobw_launches["rcab_fused"] + bobw_eval_row["rcab_launches"]
                     + joint_launches["rcab_fused"] + meta_launches["rcab_fused"]
                     + meta_row["eval_rcab_launches"] + family["launches"]),
        "launches_serving_path": serve_launches,
        "launches_training_path": train_launches["rcab_fused"],
        "launches_blind_training_path": blind_launches["rcab_fused"],
        "launches_validation": blind_launches["rcab_fused_validation"],
        "launches_eval_path": eval_row["rcab_launches"],
        "launches_bobw_training_path": bobw_launches["rcab_fused"],
        "launches_bobw_validation": bobw_launches["rcab_fused_validation"],
        "launches_bobw_eval_path": bobw_eval_row["rcab_launches"],
        "launches_bobw_joint_path": joint_launches["rcab_fused"],
        "launches_meta_attention_training_path": meta_launches["rcab_fused"],
        "launches_meta_attention_validation": meta_launches["rcab_fused_validation"],
        "launches_meta_attention_eval_path": meta_row["eval_rcab_launches"],
        "launches_bobw_family_path": family["launches"],
        # QRCAB: per-image bd, bu and scale (qrcab_kernel phase)
        "per_image_gate_inputs": per_image,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "at": [main_row["shape"], main_row["dtype"]],
        # no single call computes the fused block; one cuDNN 3x3 conv of
        # this shape alone (the kernel computes two, the gate and the add)
        "library_conv_ms": main_row["library_conv_ms"],
        "plan": main_row["plan"], "pass_device_us": main_row["pass_device_us"],
        "bit_identical_runs": main_row["bit_identical_runs"],
        "train_shape": {k: train_row[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "library_conv_ms", "plan",
            "pass_device_us", "max_abs_err")},
        "eval_shapes": [{k: r[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_conv_ms", "plan",
            "max_abs_err")} for r in eval_rows],
    }, {
        "name": "rcab_fused_backward", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/rcab_fused_bwd.cu",
        "replaces": "rumpy_tpu/ops/pallas/rcab_fused.py:73",
        "launches": (train_launches["rcab_fused_backward"]
                     + blind_launches["rcab_fused_backward"]
                     + bobw_launches["rcab_fused_backward"]
                     + joint_launches["rcab_fused_backward"]
                     + meta_launches["rcab_fused_backward"] + family["backward_launches"]),
        "launches_training_path": train_launches["rcab_fused_backward"],
        "launches_blind_training_path": blind_launches["rcab_fused_backward"],
        "launches_bobw_training_path": bobw_launches["rcab_fused_backward"],
        "launches_bobw_joint_path": joint_launches["rcab_fused_backward"],
        "launches_meta_attention_training_path": meta_launches["rcab_fused_backward"],
        "launches_bobw_family_path": family["backward_launches"],
        "per_image_gate_inputs": per_image,
        "max_abs_err": bwd_row["max_abs_err"],
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": None, "at": [bwd_row["shape"], bwd_row["dtype"]],
        # no single call computes the block's gradient; one 3x3 conv's
        # weight gradient and input gradient alone (the kernel has two of
        # each, and conv1 again), and the kernel's own passes
        "library_wgrad_ms": bwd_row["library_wgrad_ms"],
        "library_dgrad_ms": bwd_row["library_dgrad_ms"],
        "worst_rel_err": bwd_row["worst_rel_err"],
        "pass_device_us": bwd_row["pass_device_us"],
    }, {
        "name": "local_entropy", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/local_entropy.cu",
        "replaces": "rumpy_tpu/ops/pallas/entropy_kernel.py:59",
        "launches": train_launches["local_entropy"],
        "max_abs_err": ent_row["max_abs_err"],
        "ms": ent_row["ms"], "plain_ms": ent_row["plain_ms"],
        "bound_ms": ent_row["bound_ms"], "bound_by": ent_row["bound_by"],
        "library_ms": None, "at": [ent_row["shape"], "uint8 rgb"],
        # one empty kernel's device time: the floor a launch puts under ms
        "launch_floor_ms": ent_row["launch_floor_ms"],
    }, {
        "name": "window_sum", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/window_sum.cu",
        # XLA code, no Pallas kernel: the pooled map's box filter and trim
        "replaces": "rumpy_tpu/ops/entropy.py:88",
        "launches": train_launches["window_sum"],
        "max_abs_err": win_row["max_abs_err"],
        "ms": win_row["ms"], "plain_ms": win_row["plain_ms"],
        "bound_ms": win_row["bound_ms"], "bound_by": win_row["bound_by"],
        # one avg_pool2d with divisor_override=1: the same sums
        "library_ms": win_row["library_ms"],
        "at": [win_row["shape"], "float32", win_row["window"]],
        "bit_identical": win_row["bit_identical"],
    }]
    print(json.dumps({"phase": "kernels_at", "shape": main_row["shape"],
                      "dtype": main_row["dtype"],
                      "bf16_max_abs_err_all_shapes": bf16_err}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
