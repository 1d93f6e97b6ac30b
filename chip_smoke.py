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
  train shape and at 1x339x510, within twice the plain version's error
  (``rcab_bwd_f32_sums``);
* iterative blind SR: examples/train_dan_qrcan_blind.toml (DAN v1QRCAN:
  QRCAN 10x20x64 float32 on the f32 per-image RCAB kernels, 4 x 200
  forward and 200 backward launches a step at loop 4), its chain
  corrected to the PCA kernel code, through cli.train_sisr with
  validation and cli.eval_sisr, then steps of DAN v1 and DANv2
  (``dan_train``); IKC through its SFTMD pretrain epoch and an IKC epoch
  with seven corrections a step (``ikc_train``); DASR's encoder pretrain
  and joint steps on two views a crop of bench.py's chain, and DCLS
  (``dasr_train``); each with step ms, HR-MP/s, busy ms, idle share,
  kernels, peak memory, RCAB launches and conv2d calls a step and a fixed
  batch's loss before and after its steps;
* the BoBW generator families without a GAN: HAN x4 (10 x 20 x 64 bf16,
  its 200 RCABs on the shared-form kernels, LAM and CSAM) through
  cli.train_sisr on LR/HR pairs with validation and cli.eval_sisr, and
  the LAM attention's largest entry (``han_train``); the slice's main path,
  contrastiveblindqhan (QHAN's standard style with q-layers: shared bd and
  bu, a per-image scale) through cli.train_sisr on a copy of the BoBW
  example, steady steps with bench.py's chain and cli.eval_sisr, and the
  kernels in that form against their plain versions (``bobw_qhan``); ELAN
  x4 at its defaults (36 x 180, windows 4/8/16) with a DIV2K-sized eval
  reflect-padded to 352 x 512 and a contrastiveblindqelan step
  (``elan_train``); SAN x4 at its defaults (20 x 10 x 64) with its
  always-tiled eval through forward_chop and a contrastiveblindqsan step
  (``san_train``); each with step ms, HR-MP/s, busy ms, idle share,
  kernels, peak memory, RCAB launches a step by form, a fixed batch's loss
  before and after its steps and eval images/s;
* the GAN group (no RCAB kernel: cuDNN convs and PyTorch ops): the slice's
  main path, realesrgan x4 at its defaults (RRDBNet 23 x 64, gc 32, the
  U-Net SN discriminator, 64 features, bf16) through cli.train_sisr on
  examples/train_rcan_blind_x4.toml's chain with the model table swapped,
  an L1 pre-training epoch, then an adversarial epoch, validating each,
  cli.eval_sisr on the run, and steady steps of both phases
  (``realesrgan_train``); contrastiveblindqrealesrgan (QRRDBNet 23 x 64
  behind the frozen packaged encoder) through a copy of the BoBW example
  and cli.eval_sisr (``bobw_qrealesrgan``); esrgan (LR 32 for VGG-128,
  the VGG-19 conv5_4 content term from a seeded npz), bsrgan, qrealesrgan
  and danv1qrealesrgan (nb 23, loop 4, the PCA chain) steps
  (``gan_family``); Metabed with each meta type, its autoencoder's phase
  flip, metabedesrgan and contrastiveblindmetabed steps (``metabed``);
  each with step ms by phase, HR-MP/s, busy ms, idle share, kernels, peak
  memory, conv2d calls a step, a fixed batch's generator L1 and
  discriminator loss before and after, and the discriminator's train-mode
  calls a step (4);
* the face group, on CelebA-format sets written here as .npy images with a
  list_attr_celeba.txt table: the data layer read back (the 40 attributes,
  a blacklist CSV, a patch-location CSV, loss masks, CelebaSplitSampler's
  order, VideoSequenceImages' bundles under threads) with neither pandas
  nor PIL (``face_data``); the slice's main path, rcansplitceleb x4 (two
  RCANs 10 x 20 x 64, bf16: 400 forward RCAB launches a forward and 400
  backward a step) through cli.train_sisr with per-set attributes and
  CelebaSplitSampler on gender, validating each epoch, cli.eval_sisr with
  the attributes from its config, steady steps, the update hook's cost and
  a single-allocation step under sync debug "error" that leaves the absent
  expert bit for bit (``rcansplit_train``); SPARNet and QSPARNet at their
  defaults (bf16; QSPARNet on the 40 attributes, also through
  cli.train_sisr), their BatchNorm statistics moving (``sparnet_train``);
  FaceGAN at its defaults through cli.train_sisr and steady steps, its
  images in [0, 1] (``facegan_train``);
* the general-SR zoo's last models and the direct regressors (no RCAB
  kernel: cuDNN convs and PyTorch ops; each phase fails on any RCAB
  launch): the slice's main path, SwinIR-M x4 (embed 180, 6 RSTB x 6
  blocks, 6 heads, window 8, pixelshuffle; bf16) through cli.train_sisr on
  LR/HR pairs, validating each epoch, and cli.eval_sisr with PSNR, SSIM and
  LPIPS from a seeded npz, steady steps, a DIV2K-sized forward's device ms,
  peak memory and top kernels, LPIPS on the card against the CPU and one
  step at SwinIR's defaults (``swinir_train``); SRCNN and VDSR at their
  defaults on bicubic-upsampled Y input through both CLIs, VDSR's gradient
  norm before its clip (``basic_train``); basicnn, resnet18, resnet50,
  densenet, efficientnet and manet (kernel 21, x4, invariant kernel) at
  their defaults on LR patches degraded on the card by bench.py's chain,
  their predictions on the card against the CPU, and resnet18 through
  cli.train_sisr with ``data.task_type = "regression"`` and a contrastive
  evaluation (``regressor_train``); each with step ms, busy ms, idle share,
  kernels, peak memory, a fixed batch's loss before and after and one step
  under sync debug "error";
* the trainer's leftovers: full-width blind RCAN x4 bf16 with the
  example's Adam and multi_step_lr resumed from the JAX package's trees of
  a run (weights and optax state, through ``_load_jax_checkpoint``), its
  step under sync debug "error" held bit for bit against an uninterrupted
  run, each moment on the card in its parameter's layout; then
  ``TrainingHandler`` for an epoch of 6 steps with ``profile_steps = 2``
  and ``logging = "aim"`` (not installed), the trace's step spans, RCAB
  launches and top kernels (``trainer_resume``);
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
import pickle
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


def library_conv_ms(shape, dtype=torch.bfloat16):
    """A yardstick the port never calls: one cuDNN 3x3 ``F.conv2d`` on
    channels_last tensors of RCAB's shape and type (float32 as the run
    sets TF32). The kernel computes two such convs, the gate and the
    residual add."""
    n, h, w, c = shape
    g = torch.Generator().manual_seed(301)
    inp = torch.randn(n, c, h, w, generator=g).cuda().to(dtype).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn(c, c, 3, 3, generator=g).cuda().to(dtype).contiguous(
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
# launches by direction and form ("forward/shared", "backward/per_image:scale",
# ...), cleared by a phase where it reads them
FORM_LAUNCHES = collections.Counter()


def launch_key(x, bd, bu, scale):
    """A launch's shape, dtype and form: whether bd, bu and the scale are
    per image."""
    return (tuple(x.shape), str(x.dtype).split(".")[-1], bd.dim() == 2, bu.dim() == 2,
            scale is not None)


def form_name(direction, key):
    """A launch key's direction and form: "forward/shared",
    "backward/per_image:bd,scale", ..."""
    per = [n for n, on in zip(("bd", "bu", "scale"), key[2:]) if on]
    return f"{direction}/" + ("per_image:" + ",".join(per) if per else "shared")


def record_launches(rcab):
    """Wraps the wrapper's two launch functions to add each launch's key to
    LAUNCHED and count it by form in FORM_LAUNCHES; the launch counts stay
    the wrapper's own."""
    fwd, bwd = rcab._forward, rcab._backward

    def record(direction, key):
        if RECORDING[0]:
            LAUNCHED[direction].add(key)
            FORM_LAUNCHES[form_name(direction, key)] += 1

    def forward(x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale):
        record("forward", launch_key(x, bd, bu, scale))
        return fwd(x, w1, b1, w2, b2, wd, bd, wu, bu, scale, res_scale)

    def backward(dout, x, workspace, kargs, res_scale, keep=None):
        record("backward", launch_key(x, kargs[5], kargs[7], kargs[8]))
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
# In bf16 the backward's dw1 (at C = 128), and its dw1, db1 and dw2 over
# whole images (rcab_bwd_f32_sums), may stand at most this many times
# further from an f32 gradient of the same bf16-valued inputs than the bf16
# plain version's do, draw by draw.
F32_FACTOR = 2.0
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


def relu_ties(args):
    """conv1's pre-activation in float64 from the block's (bf16-valued)
    inputs, and the float32 rounding bound of its 9C + 1 terms (gamma *
    sum |terms|): a pre-activation within the bound of zero is a ReLU tie,
    which two sum orders may put on either side. (N, C, H, W) each."""
    import torch.nn.functional as F
    c = args[0].shape[3]
    gamma = (9 * c + 1) * F32_UNIT / (1 - (9 * c + 1) * F32_UNIT)
    x64 = args[0].double().permute(0, 3, 1, 2)
    k64 = args[1].double().reshape(3, 3, c, c).permute(3, 2, 0, 1)
    pre64 = F.conv2d(x64, k64, padding=1) + args[2].double()[:, None, None]
    bound = gamma * (F.conv2d(x64.abs(), k64.abs(), padding=1)
                     + args[2].double().abs()[:, None, None])
    return pre64, bound


def masked_plain_backward(dout, args, res_scale, mask):
    """``rcab_backward_reference`` with conv1's ReLU derivative taken from
    ``mask`` (N, C, H, W) in place of the sign of its own pre-activation:
    the same ops as ``rcab_reference`` otherwise."""
    import torch.nn.functional as F
    tensors = list(args) + ([res_scale] if torch.is_tensor(res_scale) else [])
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in tensors]
        x, w1, b1, w2, b2, wd, bd, wu, bu = leaves[:9]
        s = leaves[9].float()[:, :, None, None] if len(leaves) > 9 else res_scale
        dt, c = x.dtype, x.shape[-1]

        def conv(a, w, b):
            k = w.to(dt).float().reshape(3, 3, c, c).permute(3, 2, 0, 1)
            return F.conv2d(a.float(), k, padding=1) + b.float()[:, None, None]

        xc = x.permute(0, 3, 1, 2)
        h1 = (conv(xc, w1, b1) * mask).to(dt)
        h2 = conv(h1, w2, b2)
        u = torch.sigmoid(torch.relu(h2.mean(dim=(2, 3)) @ wd.float() + bd.float())
                          @ wu.float() + bu.float())
        y = (h2 * u[:, :, None, None] * s + xc.float()).to(dt).permute(0, 2, 3, 1)
        return torch.autograd.grad(y, leaves, dout)


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
    res = 1.0 if scale is None else scale
    _, workspace, kargs = rcab._forward(*args, scale, 1.0)
    keep = {}
    kernel = rcab._backward(dout, args[0], workspace, kargs, 1.0, keep=keep)
    plain = rcab.rcab_backward_reference(dout, *args, res_scale=res)
    ref, pre32 = f32_grads(args, dout, res)
    mask_k = keep["h1"].permute(0, 3, 1, 2).float() > 0
    ref_k, _ = f32_grads(args, dout, res, mask_k)
    pre64, bound = relu_ties(args)
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
    more than F32_FACTOR times as far off as the plain version's. Returns
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
                   "draw": draw, "ratio": ratio(r, "dw1"), "factor": F32_FACTOR, **r}
            print(json.dumps(row), flush=True)
            rows.append(row)
    torch.cuda.empty_cache()
    faults = [r for r in rows if r["kernel_mask_flips"] != r["of_them_ties"]]
    if faults:
        raise AssertionError(f"rcab backward: a ReLU mask bit of the kernel at C = 128 differs "
                             f"from float64's sign beyond rounding: {faults[0]}")
    worst = max(rows, key=lambda r: r["ratio"])
    if worst["ratio"] > F32_FACTOR:
        raise AssertionError(f"rcab backward: dw1 at C = 128 stands {worst['ratio']} times as "
                             f"far from f32 as the bf16 plain version: {worst}")
    return rows


# The bf16 backward's sums over an image against f32: at the train shape
# (2,304 pixels an image) and at a DIV2K x4 image's 172,890 pixels. bd and
# the scale per image with bu shared (max_concat with q-layers) and all
# three per image; qrcab_check's seeds from 455 on.
F32_SUM_SHAPES = (TRAIN_SHAPE, (1, *DIV2K_LR, 64))
F32_SUM_SEEDS = (455, 456, 457)
MAX_CONCAT_Q = (True, False, True)


def rcab_bwd_f32_sums_phase(rcab):
    """dw1, db1 and dw2 of the bf16 backward kernel and of the bf16 plain
    version against an f32 gradient (bwd_against_f32) at F32_SUM_SHAPES,
    the F32_SUM_SEEDS draws of qrcab_check in two forms. The kernel feeds
    round_bf16(dout * u * s) to conv2's transposed conv and dw2 and adds the
    constant dgap / HW exactly, which falls below half a bf16 ulp of
    dout * u * s as HW grows (rounding the sum lost its share of db1 and dw2
    on whole images). Beside them, emulated_sums' errors: rounded as the
    kernel once did, and split as it does now. Fails where a gradient of
    the kernel stands more than F32_FACTOR times as far off as the plain
    version's. Returns the rows."""
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
                       "factor": F32_FACTOR, **r}
                print(json.dumps(row), flush=True)
                rows.append(row)
                torch.cuda.empty_cache()
    worst = max(((r["ratios"][n], n, r) for r in rows for n, _ in GRADS_VS_F32),
                key=lambda t: t[0])
    print(json.dumps({"phase": "rcab_bwd_f32_sums_worst", "ratio": worst[0], "grad": worst[1],
                      "shape": worst[2]["shape"], "seed": worst[2]["seed"],
                      "factor": F32_FACTOR}), flush=True)
    if worst[0] > F32_FACTOR:
        raise AssertionError(
            f"rcab backward: {worst[1]} stands {worst[0]} times as far from the f32 gradient "
            f"as the bf16 plain version at {worst[2]['shape']} seed {worst[2]['seed']}")
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
    form's at the same shape and the bound. In bf16, where a gradient
    disagrees and the kernel's ReLU mask differs from the plain version's
    at ReLU ties only (``relu_ties``), the plain version is taken with the
    kernel's mask (``masked_plain_backward``) and held to the same
    tolerance; the row records the ties. Marks the shape, dtype and form
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
        "library_conv_ms": library_conv_ms(shape, dtype)}
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

        def compare(want):
            errs = {name: {"max_abs_err": (a.float() - b.float()).abs().max().item(),
                           "ref_abs_max": b.float().abs().max().item()}
                    for name, a, b in zip(QRCAB_GRAD_NAMES, grads, want)}
            bad = [n for n, e in errs.items() if not e["max_abs_err"] <= rel_tol * e["ref_abs_max"]]
            return errs, bad

        errs, bad = compare(want)
        if bad and dtype == torch.bfloat16:
            # A ReLU tie falls either way in two sum orders (bwd_against_f32).
            # Where the kernel's mask and the plain version's differ at ties
            # only, the plain version is taken with the kernel's mask.
            keep = {}
            with unrecorded():
                _, workspace, kargs = rcab._forward(*args, scale, 1.0)
                rcab._backward(dout, args[0], workspace, kargs, 1.0, keep=keep)
            mask_k = keep["h1"].permute(0, 3, 1, 2) > 0
            pre64, bound = relu_ties(args)
            c = shape[3]
            pre32 = torch.nn.functional.conv2d(
                args[0].float().permute(0, 3, 1, 2),
                args[1].float().reshape(3, 3, c, c).permute(3, 2, 0, 1), padding=1) \
                + args[2].float()[:, None, None]
            differ = mask_k != (pre32 > 0)
            non_ties = int((differ & (pre64.abs() > bound)).sum().item())
            row["relu_ties_kernel_vs_plain"] = {"differ": int(differ.sum().item()),
                                                "not_ties": non_ties, "first_errors": errs}
            if differ.any() and not non_ties:
                errs, bad = compare(masked_plain_backward(dout, args, res, mask_k.float()))
            del keep, workspace, kargs, mask_k, pre64, bound, pre32, differ
        worst = max(e["max_abs_err"] / max(e["ref_abs_max"], 1e-30) for e in errs.values())
        if bad or any(a.shape != b.shape for a, b in zip(grads, want)):
            raise AssertionError(f"qrcab backward: {bad} disagree at {shape} {dtype} {form}: "
                                 f"{errs}, rel tol {rel_tol}, "
                                 f"{row.get('relu_ties_kernel_vs_plain')}")
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
        if dtype == torch.bfloat16:  # one 3x3 conv's weight and input gradients
            row.update(library_conv_backward_ms(shape))
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
    FORM_LAUNCHES.clear()
    convs = conv_calls(step)
    torch.cuda.synchronize()
    n, side_h, side_w = batch["hr"].shape[:3]
    if side_h != HR_SIDE and handler.input_fn is not None:  # HR-only crops
        raise AssertionError(f"{name}: HR crops {side_h} x {side_w}")
    row = {"model": name, "batch": n, "step_ms": ms,
           "hr_megapixels_per_s": n * side_h * side_w / 1e6 / (ms / 1e3),
           "peak_memory_bytes": peak,
           "launches_a_step": {"rcab_fused": rcab.launches,
                               "rcab_fused_backward": rcab.backward_launches},
           "launches_a_step_by_form": dict(FORM_LAUNCHES),
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


DAN_CONFIG = os.path.join("examples", "train_dan_qrcan_blind.toml")
DAN_EXP = "rcan_dan_blind"  # the example's experiment name
DAN_LOOP = 4
DAN_FULL = dict(mode="v1QRCAN", scale=4, loop=DAN_LOOP)
# DAN v1 at examples/convergence_run.py:115-120's widths, DANv2 at its defaults
DAN_VARIANTS = {"dan_v1": dict(mode="v1", nf=64, nb=40, loop=DAN_LOOP, dtype="bf16"),
                "dan_v2": dict(mode="v2", nf=64, nb=10, ng=5, loop=DAN_LOOP, dtype="bf16")}
# IKC at examples/convergence_run.py:126-131's widths, one pretrain epoch
IKC_FULL = dict(scale=4, lr=2e-4, num_features=64, num_blocks=16, code_length=10,
                sftmd_pretrain_epochs=1, correction_steps=7, dtype="bf16")
DASR_VIEWS = 2


def pca_kernel_chain(table):
    """A copy of the srmdgaussianblur -> downsample chain ``table`` that
    asks for the 10 PCA values of the kernel in place of the full kernel:
    examples/train_dan_qrcan_blind.toml's request_full_kernels gives DAN v1
    a (N, 442) target for its (N, 10) estimate, and its first step fails in
    both packages (ROADMAP.md section 3)."""
    t = json.loads(json.dumps(table))
    b = t["deg_configs"]["b"]
    b.pop("request_full_kernels", None)
    b.update(request_pca_kernels=True, pca_length=10)
    return t


def without_grad(fn):
    with torch.no_grad():
        return fn()


def trained_handler(cfg, root, name):
    """``cfg`` written to ``root/name.toml`` and read back by the trainer
    without directories: its handler (its input pipeline set) and state."""
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.training.trainer import TrainingHandler
    path = os.path.join(root, f"{name}.toml")
    dump_toml(cfg, path)
    trainer = TrainingHandler(dict(load_config(path), no_directories=True), verbose=False)
    return trainer.model.model, trainer.model.state


def phase_step_row(rcab, handler, state, batch, name, loss_of):
    """step_row with a fixed batch's loss before and after its steps
    (``loss_of(state)``), and one traced step: busy ms, kernels and idle
    share a step."""
    before = loss_of(state)
    row = step_row(rcab, handler, state, batch, name)
    after = loss_of(state)
    trace = traced(lambda: handler.train_batch(state, batch), f"{name}_step_trace", 1)
    row.update(fixed_batch_loss=[before, after], loss_lower_after_steps=after < before,
               step_busy_ms=trace["busy_us"] / 1e3, step_idle_share=trace["idle_share"],
               kernels_a_step=trace["kernels_per_call"])
    if not np.isfinite([before, after]).all():
        raise AssertionError(f"{name}: fixed-batch loss {before} -> {after}")
    return row


def dan_train_phase(rcab, card):
    """DAN v1QRCAN: examples/train_dan_qrcan_blind.toml at its widths (QRCAN
    10x20x64 float32 as the restorer, the estimator nf 64 with 5 blocks,
    loop 4, batch 16, crop 48) with its chain corrected to the PCA kernel
    (pca_kernel_chain, metadata ["blur_kernel"]), through cli.train_sisr:
    2 epochs of 2 steps on HR-only .npy files, validating each epoch on
    eval pairs degraded on the card; then cli.eval_sisr on the run, and
    steady steps at batch 16. Each step launches the f32 per-image RCAB
    forward 4 x 200 times and its backward 200 times (only the last
    iteration takes a gradient); a forward of the eval, 800. Then 2 steps
    each of DAN v1 and DANv2 (DAN_VARIANTS). Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.interface import SISRInterface

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_dan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(70))
    cfg = load_config(os.path.join(ROOT, DAN_CONFIG)).as_plain()
    internal = cfg["model"]["internal_params"]
    if ({k: internal[k] for k in DAN_FULL} != DAN_FULL or "generator_params" in internal
            or cfg["training"]["batch_size"] != TRAIN_BATCH
            or cfg["data"]["crop"] != TRAIN_CROP):
        raise AssertionError(f"{DAN_CONFIG} is not v1QRCAN loop 4 at full width, batch 16, "
                             f"crop 48: {internal}")
    table = pca_kernel_chain(cfg["data"]["online_degradations"])
    eval_lr, eval_hr, _ = degrade_eval_set(os.path.join(root, "eval_data"), table, 71,
                                           np.random.default_rng(72))
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    cfg["data"].update(online_degradations=table, metadata=["blur_kernel"])
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr,
                                           "metadata_file": "on_site"}}
    cfg["training"].update(num_epochs=2)
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)

    per_forward = 200 * DAN_LOOP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    want = {"rcab_fused": per_forward * (DEGRADE_STEPS + len(forwards)),
            "rcab_fused_backward": 200 * DEGRADE_STEPS}
    if launches != want or len(forwards) != 2 * VALIDATION_FORWARDS:
        raise AssertionError(f"kernel launches in the DAN run {launches}, expected {want} "
                             f"({len(forwards)} validation forwards)")
    launches["rcab_fused_validation"] = per_forward * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    iters = {k: stats[max(stats)][k] for k in stats[max(stats)] if "-iter-" in k}
    if (len(losses) != 2 or len(iters) != 2 * DAN_LOOP
            or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]
                               + list(iters.values())).all()):
        raise AssertionError(f"DAN run: losses {losses}, {iters}, validation {val}")

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", DAN_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    want_forwards = images  # one forward an image (no --time_models warm-ups)
    if (len(values) != images or (DAN_EXP, "PSNR") not in columns
            or not np.isfinite(list(values.values())).all()
            or len(eval_forwards) != want_forwards
            or eval_launches != per_forward * want_forwards):
        raise AssertionError(f"eval_sisr of the DAN run: columns {columns}, {len(values)} rows, "
                             f"{len(eval_forwards)} forwards, {eval_launches} launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    # steady steps at batch 16, the trainer's input pipeline on a fixed HR batch
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    cfg_steps = dict(load_config(cfg_path).as_plain(), experiment_save_loc=root)

    def loss_of(handler):
        def loss(state):
            b = without_grad(lambda: handler.input_fn(card_generator(73), {"hr": hr16}))
            out_, aux, _ = without_grad(lambda: handler.apply(state.params, b, train=True))
            return float(handler.compute_losses(out_, b, aux)["train-loss"])
        return loss

    handler, state = trained_handler(cfg_steps, root, "steps")
    steps = phase_step_row(rcab, handler, state, {"hr": hr16}, "dan v1QRCAN 10x20x64 f32",
                           loss_of(handler))
    if steps["launches_a_step"] != {"rcab_fused": per_forward, "rcab_fused_backward": 200}:
        raise AssertionError(f"a DAN v1QRCAN step launched {steps['launches_a_step']}")
    del handler, state
    torch.cuda.empty_cache()
    variants = []
    for name, params in DAN_VARIANTS.items():
        c = json.loads(json.dumps(cfg_steps))
        c["model"]["internal_params"] = dict(params, scale=TRAIN_SCALE, lr=2e-4)
        if params["mode"] == "v2":  # the full kernel, flattened, is DANv2's target
            b = c["data"]["online_degradations"]["deg_configs"]["b"]
            b.pop("request_pca_kernels")
            b.pop("pca_length")
            b["request_full_kernels"] = True
            c["data"]["metadata"] = ["unmodified_blur_kernel"]
        handler, state = trained_handler(c, root, name)
        row = phase_step_row(rcab, handler, state, {"hr": hr16}, name, loss_of(handler))
        if any(row["launches_a_step"].values()):
            raise AssertionError(f"{name} launched an RCAB kernel: {row['launches_a_step']}")
        variants.append(row)
        del handler, state
        torch.cuda.empty_cache()
    row = {"phase": "dan_train", "model": "dan v1QRCAN (QRCAN 10x20x64 f32)", "card": card,
           "config": DAN_CONFIG, "chain": table, "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH,
           "crop": TRAIN_CROP, "loop": DAN_LOOP, "launches": launches,
           "epoch_train_loss": losses, "last_epoch_iteration_losses": iters, **val,
           "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "eval_sisr_s": cli_seconds, "eval_images_per_s": images / cli_seconds,
           "eval_mean": mean, "eval_rcab_launches": eval_launches, "fixed_batch": steps,
           "variants": variants}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def ikc_train_phase(rcab, card):
    """IKC at examples/convergence_run.py:126-131's widths (SFTMD 64 x 16
    blocks, code 10, 7 correction steps, bf16) on the PCA kernel chain,
    through cli.train_sisr: epoch 0 pretrains SFTMD on the true code (2
    steps), epoch 1 runs 2 IKC steps (the predictor's update, then 7 SFTMD
    forwards without a gradient and corrector updates each), validating
    after each epoch; the eval's two branches on a fixed batch; steady
    steps of each kind. No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_ikc")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(80))
    table = pca_kernel_chain(MAPS_CHAIN)
    eval_lr, eval_hr, _ = degrade_eval_set(os.path.join(root, "eval_data"), table, 81,
                                           np.random.default_rng(82))
    # IKC selects no metadata columns: its pretrain-phase validation takes
    # the CSV's whole row as the code, so the CSV keeps the kernel code only
    # (a scale column beside it fails in both packages: ROADMAP.md section 3)
    csv_path = os.path.join(eval_lr, "degradation_metadata.csv")
    with open(csv_path, newline="") as fh:
        rows = list(csv.reader(fh))
    keep = [i for i, k in enumerate(rows[0]) if i == 0 or k.endswith("-blur_kernel")]
    with open(csv_path, "w", newline="") as fh:
        csv.writer(fh).writerows([[r[i] for i in keep] for r in rows])
    cfg = {"experiment": "ikc", "experiment_save_loc": os.path.join(root, "experiments"),
           "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "dataloader_threads": 4,
                    "metadata": ["blur_kernel"], "online_degradations": table,
                    "training_sets": {f"data_{i}": {"hr_dir": hr_dir}
                                      for i in range(DEGRADE_SETS)},
                    "eval_sets": {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr,
                                             "metadata_file": "on_site"}}},
           "model": {"name": "ikc", "internal_params": dict(IKC_FULL)},
           "training": {"num_epochs": 2, "batch_size": TRAIN_BATCH, "seed": 0,
                        "metrics": ["PSNR", "SSIM"]}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    epochs = [stats[e] for e in sorted(stats)]
    if (len(epochs) != 2 or "sftmd_loss_6" in epochs[0] or "sftmd_loss_6" not in epochs[1]
            or not np.isfinite([v for e in epochs for v in e.values()]).all()):
        raise AssertionError(f"IKC run: {epochs}")

    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    handler, state = trained_handler(dict(cfg, experiment_save_loc=root), root, "steps")
    b = without_grad(lambda: handler.input_fn(card_generator(83), {"hr": hr16}))

    def loss_of(state):  # the blind SR's L1 on the fixed batch
        return float((handler.run_eval(state, {"lr": b["lr"]}).float() - hr16).abs().mean())

    handler.set_epoch(0)
    sr_true = handler.run_eval(state, {"lr": b["lr"], "metadata": b["metadata"]})
    pretrain = phase_step_row(rcab, handler, state, {"hr": hr16}, "ikc pretrain", loss_of)
    handler.set_epoch(1)
    blind = handler.run_eval(state, {"lr": b["lr"], "metadata": b["metadata"]})
    ikc = phase_step_row(rcab, handler, state, {"hr": hr16}, "ikc", loss_of)
    steps = {name: int(next(iter(opt["state"].values()))["step"])
             for name, opt in handler.optimizer_state().items()}
    if (rcab.launches or rcab.backward_launches
            or not (torch.isfinite(sr_true).all() and torch.isfinite(blind).all())
            or set(steps) != {"sr_model", "predictor", "corrector"}
            or steps["corrector"] != IKC_FULL["correction_steps"] * steps["predictor"]):
        raise AssertionError(f"IKC: RCAB launches {rcab.launches}, optimizer steps {steps}")
    row = {"phase": "ikc_train", "model": "ikc (SFTMD 64x16, 7 corrections, bf16)",
           "card": card, "chain": table, "run_experiment_s": seconds,
           "peak_memory_bytes_run": peak_run,
           "epochs": [{k: v for k, v in e.items() if k in (
               "train-loss", "predictor-loss", "val-PSNR", "val-SSIM", "sftmd_loss_0",
               "sftmd_loss_6", "corrector_loss_6")} for e in epochs],
           "optimizer_steps": steps, "pretrain_step": pretrain, "ikc_step": ikc}
    print(json.dumps(row), flush=True)
    del handler, state
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return row


def multi_view_batch(pipe, hr_dir, batch, views, seed):
    """``views`` HR crops of HR_SIDE an image, degraded in one pass by
    ``pipe`` with one draw set an image (the chain's multi-view mode): lr
    (batch, views, h, w, C), crop 0 the query, and crop 0's HR."""
    rng = np.random.default_rng(seed)
    crops = []
    for k in range(batch):
        hr = np.load(os.path.join(hr_dir, f"im{k % TRAIN_IMAGES}.npy"))
        for _ in range(views):
            top = int(rng.integers(0, hr.shape[0] - HR_SIDE))
            left = int(rng.integers(0, hr.shape[1] - HR_SIDE))
            crops.append(hr[top:top + HR_SIDE, left:left + HR_SIDE])
    hr_t = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    with torch.no_grad():
        lr, _ = pipe.degrade_batch(card_generator(seed), hr_t, views=views)
    return {"lr": lr.reshape(batch, views, *lr.shape[1:]), "hr": hr_t[::views].contiguous()}


def dasr_train_phase(rcab, card):
    """DASR at its defaults (5 groups x 5 blocks x 64, K 8192) on batches of
    two views of each image crop degraded by bench.py's chain (the JAX
    trainer cannot feed it an online chain: ROADMAP.md section 3), driven
    through the handler: one encoder-pretrain step (the SR net untouched,
    its Adam moments advanced on zero gradients), then steady joint steps
    at batch 16, then an eval forward at DIV2K x4 size. Then DCLS at its
    defaults (kernel 21, nf 64) on the flattened full kernels of
    srmdgaussianblur, steady steps. No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_dasr")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(90))
    pipe = ImagePipeline(BENCH_CHAIN["pipeline"], deg_configs=BENCH_CHAIN["deg_configs"],
                         scale=TRAIN_SCALE)
    batch = multi_view_batch(pipe, hr_dir, TRAIN_BATCH, DASR_VIEWS, 91)
    fixed = multi_view_batch(pipe, hr_dir, TRAIN_BATCH, DASR_VIEWS, 92)
    handler = get_model("dasr")(scale=TRAIN_SCALE, encoder_pretrain_epochs=1)
    state = handler.init_state()

    def loss_of(state):  # the SR's L1 on the fixed batch's query crops
        sr = handler.run_eval(state, {"lr": fixed["lr"][:, 0]})
        return float((sr.float() - fixed["hr"]).abs().mean())

    sr_before = {k: v.clone() for k, v in state.params.items() if k.startswith("sr_net.")}
    rcab.launches = rcab.backward_launches = 0
    handler.set_epoch(0)
    pretrain_ms = cuda_ms(lambda: handler.train_batch(state, batch), 1, warmup=0, backlog_s=0)
    opt = handler.optimizer()
    sr_params = list(handler.module.sr_net.parameters())
    if (not all(torch.equal(state.params[k], v) for k, v in sr_before.items())
            or {int(opt.state[p]["step"]) for p in sr_params} != {1}):
        raise AssertionError("the encoder-pretrain step moved the SR net or skipped its Adam "
                             "state")
    handler.set_epoch(1)
    joint = phase_step_row(rcab, handler, state, batch, "dasr", loss_of)
    lr_eval = batch["lr"].new_tensor(np.random.default_rng(93).random(
        (1, *DIV2K_LR, 3), dtype=np.float32))
    handler.run_eval(state, {"lr": lr_eval})  # warm
    eval_ms = cuda_ms(lambda: handler.run_eval(state, {"lr": lr_eval}), 2, warmup=0, backlog_s=0)
    sr = handler.run_eval(state, {"lr": lr_eval})
    if sr.shape != (1, DIV2K_LR[0] * 4, DIV2K_LR[1] * 4, 3) or not torch.isfinite(sr).all():
        raise AssertionError(f"DASR eval forward: {tuple(sr.shape)}")
    queue_ptr = int(handler.module.queue_ptr)
    del handler, state
    torch.cuda.empty_cache()

    chain = pca_kernel_chain(MAPS_CHAIN)
    b = chain["deg_configs"]["b"]
    b.pop("request_pca_kernels")
    b.pop("pca_length")
    b["request_full_kernels"] = True
    cfg = {"experiment": "dcls", "experiment_save_loc": root,
           "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "online_degradations": chain,
                    "metadata": ["unmodified_blur_kernel"],
                    "training_sets": {"data_1": {"hr_dir": hr_dir}}},
           "model": {"name": "dcls", "internal_params": {"scale": TRAIN_SCALE, "lr": 1e-4}},
           "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 0}}
    dcls, dstate = trained_handler(cfg, root, "dcls")
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)

    def dcls_loss(state):
        bb = without_grad(lambda: dcls.input_fn(card_generator(94), {"hr": hr16}))
        k, _, _ = without_grad(lambda: dcls.apply(state.params, bb))
        return float(dcls.compute_losses(k, bb, {})["train-loss"])

    dcls_row = phase_step_row(rcab, dcls, dstate, {"hr": hr16}, "dcls", dcls_loss)
    if rcab.launches or rcab.backward_launches:
        raise AssertionError("an RCAB kernel ran in DASR or DCLS")
    row = {"phase": "dasr_train", "model": "dasr 5x5x64 K 8192", "card": card,
           "views": DASR_VIEWS, "pretrain_step_ms": pretrain_ms, "joint": joint,
           "queue_ptr_after": queue_ptr, "eval_forward_ms_1x339x510": eval_ms,
           "dcls": dcls_row}
    print(json.dumps(row), flush=True)
    del dcls, dstate
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return row


HAN_FULL = dict(scale=4, n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16)
HAN_EXP = "han_x4"
QHAN_EXP = "qhan_supmoco_bobw"
# QHAN's default block (the standard style with a q-layer): shared bd and bu,
# the q-layer's gate as a per-image scale
QHAN_FORM = (False, False, True)
ELAN_FULL = dict(scale=4, m_elan=36, c_elan=180, window_sizes=(4, 8, 16))  # its defaults
SAN_FULL = dict(scale=4, n_feats=64, n_resgroups=20, n_resblocks=10)  # its defaults


def fixed_pair_batch(lr_dir, hr_dir, batch, crop=TRAIN_CROP):
    """Centre crops of ``crop`` LR pixels and the matching HR pixels of
    the LR/HR pairs, on the card."""
    names = sorted(os.listdir(hr_dir))
    lrs, hrs = [], []
    side = crop * TRAIN_SCALE
    for name in (names * batch)[:batch]:
        lr = np.load(os.path.join(lr_dir, name))
        top, left = (lr.shape[0] - crop) // 2, (lr.shape[1] - crop) // 2
        lrs.append(lr[top:top + crop, left:left + crop])
        hr = np.load(os.path.join(hr_dir, name))
        t, l_ = top * TRAIN_SCALE, left * TRAIN_SCALE
        hrs.append(hr[t:t + side, l_:l_ + side])
    return {k: torch.from_numpy(np.stack(v).astype(np.float32) / 255.0).cuda()
            for k, v in (("lr", lrs), ("hr", hrs))}


@contextlib.contextmanager
def buffers_kept(module):
    """The module's buffers (BatchNorm running statistics) as they were
    after the block: a loss taken in train mode leaves the model alone."""
    saved = {k: v.clone() for k, v in module.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in module.named_buffers():
                v.copy_(saved[k])


def running_stats(module, prefix=""):
    return {k: v.clone() for k, v in module.named_buffers()
            if k.startswith(prefix) and k.endswith(("running_mean", "running_var"))}


def pair_loss(handler, batch, train=False):
    """The L1 of ``handler`` on an LR/HR ``batch``: the state's loss."""
    def loss(state):
        out, _, _ = without_grad(lambda: handler.apply(state.params, batch, train=train))
        return float((out.float() - batch["hr"]).abs().mean())
    return loss


def lam_attention(handler, state, lr):
    """LAM's attention (B, 11, 11) in a forward of ``lr``, from the stacked
    layers it receives, and the same from float32 energies of those layers."""
    taken = []
    hook = handler.module.lam.register_forward_pre_hook(lambda m, a: taken.append(a[0]))
    try:
        without_grad(lambda: handler.apply(state.params, {"lr": lr}))
    finally:
        hook.remove()
    out = []
    for x in (taken[0], taken[0].float()):
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        energy = torch.bmm(flat, flat.transpose(1, 2))
        out.append(torch.softmax(energy.amax(-1, keepdim=True) - energy, dim=-1).float())
    return out


def eval_images(handler, state, lr_dir, images):
    """Each LR image of ``lr_dir`` through ``handler.run_eval`` alone, as
    eval_sisr runs them: images/s (host clock, the card waited for), the
    outputs' shapes and whether all are finite, peak memory."""
    names = sorted(n for n in os.listdir(lr_dir) if n.endswith(".npy"))[:images]
    lrs = [torch.from_numpy(np.load(os.path.join(lr_dir, n)).astype(np.float32)
                            / 255.0)[None].cuda() for n in names]
    handler.run_eval(state, {"lr": lrs[0]})  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [handler.run_eval(state, {"lr": x}) for x in lrs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    shapes_ok = all(tuple(o.shape) == (1, x.shape[1] * TRAIN_SCALE, x.shape[2] * TRAIN_SCALE, 3)
                    for o, x in zip(outs, lrs))
    if not (finite and shapes_ok):
        raise AssertionError(f"eval outputs: finite {finite}, shapes {[tuple(o.shape) for o in outs]}")
    return {"eval_images": len(lrs), "eval_images_per_s": len(lrs) / seconds,
            "eval_seconds": seconds, "peak_memory_bytes_eval": torch.cuda.max_memory_allocated()}


def one_bobw_step(rcab, name, hr16, card_seed, **kw):
    """One step of the BoBW handler ``name`` (bf16, its defaults, the
    packaged encoder frozen) with bench.py's chain in the step at batch 16:
    its host ms, loss, RCAB launches, and which BatchNorm running statistics
    moved (the encoder's in a train step; the generator's never, as the
    pipeline calls it without ``train``)."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.registry import get_model
    handler = get_model(name)(device="cuda", dtype="bf16", lr=1e-4,
                              pre_trained_encoder_weights=PACKAGED_ENCODER, **kw)
    pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)
    handler.set_input_pipeline(lambda g, b: {"lr": pipe.degrade_batch(g, b["hr"])[0],
                                             "hr": b["hr"]})
    state = handler.init_state()
    handler.rng.manual_seed(card_seed)
    gen0, enc0 = (running_stats(handler.module, p) for p in ("generator.", "encoder."))
    torch.cuda.synchronize()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    _, losses = handler.train_batch(state, {"hr": hr16})
    loss = float(losses["train-loss"])
    step_s = time.perf_counter() - t0
    gen1, enc1 = (running_stats(handler.module, p) for p in ("generator.", "encoder."))
    row = {"model": f"{name} x4 bf16, frozen {PACKAGED_ENCODER}", "batch": TRAIN_BATCH,
           "first_step_host_s": step_s, "loss": loss,
           "launches": {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches},
           "generator_running_stats": len(gen0),
           "generator_running_stats_moved": sum(not torch.equal(gen0[k], gen1[k]) for k in gen0),
           "encoder_running_stats_moved": sum(not torch.equal(enc0[k], enc1[k]) for k in enc0)}
    if not np.isfinite(loss) or row["encoder_running_stats_moved"] != len(enc0) \
            or row["generator_running_stats_moved"] or any(row["launches"].values()):
        raise AssertionError(f"{name} step: {row}")
    del handler, state
    torch.cuda.empty_cache()
    return row


def han_train_phase(rcab, card):
    """HAN x4 at full width (10 x 20 x 64 bf16: RCAN's 200 RCABs on the
    shared-form kernels, LAM over the 11 stacked layers, CSAM's conv3d)
    through cli.train_sisr on LR/HR pairs (batch 16, crop 48, 2 epochs of 2
    steps, validating each epoch on the 9 eval pairs), cli.eval_sisr on the
    run, steady steps on a fixed batch, and the LAM attention's largest
    entry. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_han")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(80))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(81))
    internal = dict(HAN_FULL, dtype="bf16", lr=1e-4, optimizer_type="adam")
    seed, exp_root = 3, os.path.join(root, "experiments")
    cfg = {"experiment": HAN_EXP, "experiment_save_loc": exp_root,
           "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "augmentations": True,
                    "dataloader_threads": 4,
                    "training_sets": {f"data_{i}": {"lr_dir": lr_dir, "hr_dir": hr_dir}
                                      for i in range(TRAIN_SETS)},
                    "eval_sets": {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}},
           "model": {"name": "han", "internal_params": internal},
           "training": {"num_epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH, "seed": seed}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES * TRAIN_SETS // TRAIN_BATCH)
    fixed = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    FORM_LAUNCHES.clear()
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    want = {"rcab_fused": 200 * (steps + len(forwards)), "rcab_fused_backward": 200 * steps}
    forms = dict(FORM_LAUNCHES)
    if (launches != want or len(forwards) != 2 * VALIDATION_FORWARDS
            or set(forms) != {"forward/shared", "backward/shared"}):
        raise AssertionError(f"kernel launches in the HAN run {launches} by form {forms}, "
                             f"expected {want} ({len(forwards)} validation forwards)")
    launches["rcab_fused_validation"] = 200 * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses + val["val-PSNR"]
                                                      + val["val-SSIM"]).all():
        raise AssertionError(f"HAN run: losses {losses}, validation {val}")

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", HAN_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    if (len(values) != images or (HAN_EXP, "PSNR") not in columns
            or not np.isfinite(list(values.values())).all()
            or len(eval_forwards) != images or eval_launches != 200 * images):
        raise AssertionError(f"eval_sisr of the HAN run: columns {columns}, {len(values)} rows, "
                             f"{len(eval_forwards)} forwards, {eval_launches} launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    handler = get_model("han")(device="cuda", seed=seed, **internal)
    state = handler.init_state()
    steps_row = phase_step_row(rcab, handler, state, fixed, "han x4 10x20x64 bf16",
                               pair_loss(handler, fixed))
    if steps_row["launches_a_step"] != {"rcab_fused": 200, "rcab_fused_backward": 200} \
            or set(steps_row["launches_a_step_by_form"]) != {"forward/shared", "backward/shared"}:
        raise AssertionError(f"a HAN step launched {steps_row['launches_a_step_by_form']}")
    att16, att32 = lam_attention(handler, state, fixed["lr"])
    lam = {"largest_entry": float(att16.max()), "mean_row_max": float(att16.amax(-1).mean()),
           "largest_entry_f32_energies": float(att32.max()),
           "row_winners_agree_with_f32": float((att16.argmax(-1) == att32.argmax(-1))
                                               .float().mean())}
    row = {"phase": "han_train", "model": "han x4 10x20x64 bf16", "card": card,
           "steps": steps, "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "launches": launches,
           "launches_by_form": forms, "epoch_train_loss": losses, **val,
           "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "eval_sisr_s": cli_seconds, "eval_images_per_s": images / cli_seconds,
           "eval_mean": mean, "eval_rcab_launches": eval_launches,
           "lam_attention_bf16": lam, "fixed_batch": steps_row}
    print(json.dumps(row), flush=True)
    if not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"HAN fixed-batch loss {steps_row['fixed_batch_loss']}")
    del handler, state
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return row


def bobw_qhan_phase(rcab, card):
    """The slice's main path: contrastiveblindqhan (QHAN 10 x 20 x 64 bf16,
    standard style with q-layers: each of its 200 blocks launches the RCAB
    kernels with shared bd and bu and a per-image scale; the frozen packaged
    encoder) through cli.train_sisr on a copy of
    examples/train_bobw_rcan_supmoco.toml with the model's name changed (2
    epochs of 2 steps, validating each epoch), steady steps at batch 16 with
    bench.py's chain in the step, cli.eval_sisr on the run; then the
    kernels in that form against their plain versions at its shapes.
    Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_bobw_qhan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(90))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(91))
    cfg = load_config(os.path.join(ROOT, BOBW_CONFIG)).as_plain()
    cfg["model"]["name"] = "contrastiveblindqhan"
    cfg["experiment"] = QHAN_EXP
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}
    cfg["training"].update(num_epochs=2)
    internal = cfg["model"]["internal_params"]
    if ({k: internal[k] for k in BOBW_FULL} != BOBW_FULL or internal.get("dtype") != "bf16"
            or cfg["training"]["batch_size"] != TRAIN_BATCH or cfg["data"]["crop"] != TRAIN_CROP):
        raise AssertionError(f"{BOBW_CONFIG} is not full-width bf16 BoBW at batch 16, crop 48")
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    FORM_LAUNCHES.clear()
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    want = {"rcab_fused": 200 * (DEGRADE_STEPS + len(forwards)),
            "rcab_fused_backward": 200 * DEGRADE_STEPS}
    forms = dict(FORM_LAUNCHES)
    qhan_forms = {"forward/per_image:scale", "backward/per_image:scale"}
    if launches != want or len(forwards) != 2 * VALIDATION_FORWARDS or set(forms) != qhan_forms:
        raise AssertionError(f"kernel launches in the QHAN BoBW run {launches} by form {forms}, "
                             f"expected {want} in {qhan_forms}")
    launches["rcab_fused_validation"] = 200 * len(forwards)
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    if len(losses) != 2 or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]).all():
        raise AssertionError(f"QHAN BoBW run: losses {losses}, validation {val}")

    # steady steps at batch 16 with bench.py's chain in the step
    handler = get_model("contrastiveblindqhan")(device="cuda", seed=cfg["training"]["seed"],
                                                **internal)
    pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)

    def input_fn(generator, b):
        return {"lr": pipe.degrade_batch(generator, b["hr"])[0], "hr": b["hr"]}

    handler.set_input_pipeline(input_fn)
    state = handler.init_state()
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    fixed = without_grad(lambda: input_fn(card_generator(92), {"hr": hr16}))
    steps_row = phase_step_row(rcab, handler, state, {"hr": hr16},
                               "contrastiveblindqhan x4 10x20x64 bf16", pair_loss(handler, fixed))
    if steps_row["launches_a_step"] != {"rcab_fused": 200, "rcab_fused_backward": 200} \
            or set(steps_row["launches_a_step_by_form"]) != qhan_forms:
        raise AssertionError(f"a QHAN BoBW step launched {steps_row['launches_a_step_by_form']}")
    del handler, state
    torch.cuda.empty_cache()

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", QHAN_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    if (len(values) != images or (QHAN_EXP, "PSNR") not in columns
            or not np.isfinite(list(values.values())).all()
            or len(eval_forwards) != images or eval_launches != 200 * images):
        raise AssertionError(f"eval_sisr of the QHAN BoBW run: columns {columns}, "
                             f"{len(values)} rows, {len(eval_forwards)} forwards, "
                             f"{eval_launches} launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))
    kernel_rows = [qrcab_check(rcab, TRAIN_SHAPE, torch.bfloat16, 480, QHAN_FORM)] + [
        qrcab_check(rcab, shape, torch.bfloat16, 481 + i, QHAN_FORM, backward=False)
        for i, shape in enumerate(EVAL_SHAPES)]
    row = {"phase": "bobw_qhan", "model": "contrastiveblindqhan x4 10x20x64 bf16 (standard, "
           f"q-layers), frozen {PACKAGED_ENCODER}", "card": card, "config": BOBW_CONFIG,
           "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "launches": launches, "launches_by_form": forms, "epoch_train_loss": losses, **val,
           "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "eval_sisr_s": cli_seconds, "eval_images_per_s": images / cli_seconds,
           "eval_mean": mean, "eval_rcab_launches": eval_launches,
           "fixed_batch": dict(steps_row, chain="bench.py:133-143"),
           "kernel_form_rows": [{k: r[k] for k in ("shape", "ms", "shared_form_ms", "plain_ms",
                                                   "bound_ms", "max_abs_err", "backward_ms",
                                                   "shared_form_backward_ms", "backward_plain_ms",
                                                   "bwd_worst_rel_err")} for r in kernel_rows]}
    print(json.dumps(row), flush=True)
    if not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"QHAN BoBW fixed-batch loss {steps_row['fixed_batch_loss']}")
    shutil.rmtree(root)
    return row


def elan_train_phase(rcab, card):
    """ELAN x4 at its defaults (36 blocks, 180 channels, windows 4/8/16,
    bf16): steady steps on a fixed LR/HR batch (batch 16, crop 48; a step's
    BatchNorm runs on the batch's statistics and moves the running ones), a
    DIV2K-sized LR 339 x 510 (reflect-padded to 352 x 512 inside) and the
    9 eval pairs through run_eval, one image a forward; then one
    contrastiveblindqelan step (its generator's running statistics stay).
    No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_elan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(100))
    eval_lr, _ = write_eval_pairs(os.path.join(root, "eval_data"), np.random.default_rng(101))
    fixed = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)
    handler = get_model("elan")(device="cuda", dtype="bf16", lr=1e-4, seed=5, **ELAN_FULL)
    state = handler.init_state()
    stats0 = running_stats(handler.module)

    def loss_of(state):  # batch statistics, as the step's loss, the running ones kept
        with buffers_kept(handler.module):
            return pair_loss(handler, fixed, train=True)(state)

    steps_row = phase_step_row(rcab, handler, state, fixed, "elan x4 36x180 bf16", loss_of)
    stats1 = running_stats(handler.module)
    moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
    if any(steps_row["launches_a_step"].values()) or moved != len(stats0):
        raise AssertionError(f"ELAN steps: launches {steps_row['launches_a_step']}, "
                             f"{moved} of {len(stats0)} running statistics moved")
    x = torch.from_numpy(np.load(os.path.join(eval_lr, sorted(os.listdir(eval_lr))[0]))
                         .astype(np.float32) / 255.0)[None].cuda()
    if tuple(x.shape[1:3]) != DIV2K_LR:
        raise AssertionError(f"the first eval image is {tuple(x.shape)}")
    forward = lambda: handler.run_eval(state, {"lr": x})
    forward_ms = cuda_ms(forward, 2, warmup=1, backlog_s=0)
    trace = traced(forward, "elan_div2k_forward_trace", 1, by_kernel=True)
    top = sorted(trace["per_call_device_us_by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    evals = eval_images(handler, state, eval_lr, len(EVAL_LR_SHAPES))
    del handler, state
    torch.cuda.empty_cache()
    bobw = one_bobw_step(rcab, "contrastiveblindqelan", fixed["hr"], 102)
    row = {"phase": "elan_train", "model": "elan x4 m36 c180 windows 4/8/16 bf16", "card": card,
           "fixed_batch": steps_row, "running_stats_moved": moved,
           "div2k_lr": DIV2K_LR, "div2k_padded_to": (352, 512),
           "forward_div2k_wall_ms": forward_ms, "forward_div2k_busy_ms": trace["busy_us"] / 1e3,
           "forward_div2k_kernels": trace["kernels_per_call"],
           "forward_div2k_top_kernels_us": dict(top), **evals,
           "contrastiveblindqelan_step": bobw}
    print(json.dumps(row), flush=True)
    if not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"ELAN fixed-batch loss {steps_row['fixed_batch_loss']}")
    shutil.rmtree(root)
    return row


def san_train_phase(rcab, card):
    """SAN x4 at its defaults (20 groups x 10 blocks x 64, bf16): steady
    steps on a fixed LR/HR batch (batch 16, crop 48), then its evaluation,
    which always tiles (forward_chop with a forced split, tiles one after
    another), on the 9 eval pairs one image a forward; then one
    contrastiveblindqsan step. No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.models import san as san_module
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_san")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(110))
    eval_lr, _ = write_eval_pairs(os.path.join(root, "eval_data"), np.random.default_rng(111))
    fixed = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)
    handler = get_model("san")(device="cuda", dtype="bf16", lr=1e-4, seed=6, **SAN_FULL)
    state = handler.init_state()
    steps_row = phase_step_row(rcab, handler, state, fixed, "san x4 20x10x64 bf16",
                               pair_loss(handler, fixed))
    if any(steps_row["launches_a_step"].values()):
        raise AssertionError(f"a SAN step launched {steps_row['launches_a_step']}")
    with watched(san_module, "forward_chop") as chops, watched(handler, "apply") as tiles:
        evals = eval_images(handler, state, eval_lr, len(EVAL_LR_SHAPES))
    images = len(EVAL_LR_SHAPES)
    # one warm-up and one call an image, each at least four tiles
    if len(chops) != images + 1 or len(tiles) < 4 * len(chops):
        raise AssertionError(f"SAN eval: {len(chops)} forward_chop calls, {len(tiles)} tiles")
    del handler, state
    torch.cuda.empty_cache()
    bobw = one_bobw_step(rcab, "contrastiveblindqsan", fixed["hr"], 112)
    row = {"phase": "san_train", "model": "san x4 20x10x64 bf16", "card": card,
           "fixed_batch": steps_row, **evals, "eval_forward_chop_calls": len(chops),
           "eval_tile_forwards": len(tiles), "contrastiveblindqsan_step": bobw}
    print(json.dumps(row), flush=True)
    if not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"SAN fixed-batch loss {steps_row['fixed_batch_loss']}")
    shutil.rmtree(root)
    return row


# the GAN group: RRDBNet and the U-Net SN discriminator at their defaults
GAN_FULL = dict(scale=4, nf=64, nb=23, gc=32, d_nf=64)
REALESRGAN_EXP = "realesrgan_x4_blind"
QREALESRGAN_EXP = "qrealesrgan_supmoco_bobw"
GAN_CROP = 32  # esrgan and metabedesrgan: VGG-128 takes HR 128 x 128
META_LEN = 5  # Metabed's metadata values in the metabed phase


def gan_losses(handler, fixed):
    """A fixed LR/HR batch's generator L1 (the eval forward) and
    discriminator loss (train mode, its statistics and spectral-norm state
    put back), as floats."""
    def losses(state):
        sr = without_grad(lambda: handler.apply(state.params, fixed)[0])
        with buffers_kept(handler.module):
            pred_real = without_grad(lambda: handler._disc(fixed["hr"]))
            pred_fake = without_grad(lambda: handler._disc(sr))
        real, fake = handler._adv_d_loss(pred_fake, pred_real)
        return float((sr.float() - fixed["hr"]).abs().mean()), float(real + fake)
    return losses


def gan_phase_rows(rcab, handler, state, batch, name, fixed, epochs, steps=2):
    """For each epoch of ``epochs`` (below ``pretrain_epochs`` the L1 step,
    else the adversarial step): step_row's numbers (``steps`` timed after a
    warm-up), one traced step (busy ms, idle share, kernels), the fixed
    batch's generator L1 and discriminator loss before and after, and the
    discriminator's train-mode calls in that step. No RCAB kernel runs."""
    losses_of = gan_losses(handler, fixed)
    rows = {}
    for epoch in epochs:
        handler.set_epoch(epoch)
        phase = "pretrain" if epoch < handler.pretrain_epochs else "adversarial"
        before = losses_of(state)
        row = step_row(rcab, handler, state, batch, f"{name} {phase}", steps=steps)
        after = losses_of(state)
        calls = []
        hook = handler.discriminator.register_forward_pre_hook(
            lambda m, a, kw: calls.append(bool(kw.get("train"))), with_kwargs=True)
        try:
            trace = traced(lambda: handler.train_batch(state, batch),
                           f"{re.sub(r'[^a-z0-9]+', '_', name)}_{phase}_trace", 1)
        finally:
            hook.remove()
        row.update(phase=phase, fixed_batch_g_l1=[before[0], after[0]],
                   fixed_batch_d_loss=[before[1], after[1]],
                   d_train_calls_a_step=sum(calls), step_busy_ms=trace["busy_us"] / 1e3,
                   step_idle_share=trace["idle_share"], kernels_a_step=trace["kernels_per_call"])
        want_calls = 4 if phase == "adversarial" else 0
        if (not np.isfinite(before + after).all() or any(row["launches_a_step"].values())
                or row["d_train_calls_a_step"] != want_calls
                or (phase == "pretrain" and not after[0] < before[0])):
            raise AssertionError(f"{name} {phase}: {row}")
        rows[phase] = row
    return rows


def realesrgan_train_phase(rcab, card):
    """The slice's main path: realesrgan x4 at its defaults (RRDBNet 23 x
    64, gc 32; the U-Net SN discriminator, 64 features; bf16) through
    cli.train_sisr on examples/train_rcan_blind_x4.toml with the model table
    swapped: HR-only .npy files degraded on the card by the example's chain
    in each step, batch 16, crop 48, epoch 0 the L1 pre-training, epoch 1
    adversarial (2 steps each), validating each epoch; cli.eval_sisr on the
    run; then steady steps of both phases on a fixed batch with the chain.
    Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.interface import SISRInterface

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_realesrgan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(120))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(121))
    cfg = load_config(os.path.join(ROOT, EXAMPLE_CONFIG)).as_plain()
    if cfg["training"]["batch_size"] != TRAIN_BATCH or cfg["data"]["crop"] != TRAIN_CROP:
        raise AssertionError(f"{EXAMPLE_CONFIG} is not batch 16, crop 48")
    exp_root = os.path.join(root, "experiments")
    cfg["experiment"], cfg["experiment_save_loc"] = REALESRGAN_EXP, exp_root
    cfg["model"] = {"name": "realesrgan", "internal_params": dict(
        GAN_FULL, dtype="bf16", lr=1e-4, pretrain_epochs=1)}
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}
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
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    epochs = [stats[e] for e in sorted(stats)]
    losses = {k: [r.get(k) for r in epochs] for k in ("train-loss", "l1-loss", "gan-loss",
                                                      "d-loss-real", "d-loss-fake")}
    val = {k: [r.get(k) for r in epochs] for k in ("val-PSNR", "val-SSIM")}
    if (any(launches.values()) or len(forwards) != 2 * VALIDATION_FORWARDS or len(epochs) != 2
            or losses["gan-loss"][0] != 0.0 or not losses["gan-loss"][1] > 0
            or not np.isfinite(sum(losses.values(), []) + val["val-PSNR"]
                               + val["val-SSIM"]).all()):
        raise AssertionError(f"realesrgan run: launches {launches}, {len(forwards)} validation "
                             f"forwards, losses {losses}, validation {val}")

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", REALESRGAN_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    if (len(values) != images or (REALESRGAN_EXP, "PSNR") not in columns
            or not np.isfinite(list(values.values())).all() or len(eval_forwards) != images):
        raise AssertionError(f"eval_sisr of the realesrgan run: columns {columns}, "
                             f"{len(values)} rows, {len(eval_forwards)} forwards")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    handler, state = trained_handler(dict(load_config(cfg_path).as_plain(),
                                          experiment_save_loc=root), root, "steps")
    fixed = without_grad(lambda: handler.input_fn(card_generator(122), {"hr": hr16}))
    steps = gan_phase_rows(rcab, handler, state, {"hr": hr16},
                           "realesrgan x4 23x64 bf16, U-Net SN 64", fixed, (0, 1))
    del handler, state
    torch.cuda.empty_cache()
    row = {"phase": "realesrgan_train", "model": "realesrgan x4 RRDBNet 23x64 gc32 bf16, "
           "U-Net SN discriminator 64", "card": card, "config": EXAMPLE_CONFIG,
           "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "launches": launches, "epoch_losses": losses, **val, "run_experiment_s": seconds,
           "peak_memory_bytes_run": peak_run, "eval_sisr_s": cli_seconds,
           "eval_images_per_s": images / cli_seconds, "eval_mean": mean,
           "fixed_batch": steps}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def bobw_qrealesrgan_phase(rcab, card):
    """contrastiveblindqrealesrgan: QRRDBNet 23 x 64 (gc 32, bf16; the BoBW
    example's QRCAN widths swapped for RRDBNet's defaults) behind the frozen
    packaged encoder, through cli.train_sisr on a copy of
    examples/train_bobw_rcan_supmoco.toml (2 epochs of 2 steps, validating
    each), steady steps at batch 16 with bench.py's chain, cli.eval_sisr on
    the run. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_bobw_qrealesrgan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(123))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(124))
    cfg = load_config(os.path.join(ROOT, BOBW_CONFIG)).as_plain()
    cfg["model"]["name"] = "contrastiveblindqrealesrgan"
    cfg["experiment"] = QREALESRGAN_EXP
    exp_root = os.path.join(root, "experiments")
    cfg["experiment_save_loc"] = exp_root
    cfg["data"]["training_sets"] = {f"data_{i}": {"hr_dir": hr_dir} for i in range(DEGRADE_SETS)}
    cfg["data"]["eval_sets"] = {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}
    cfg["training"].update(num_epochs=2)
    internal = cfg["model"]["internal_params"]
    for k in BOBW_FULL:  # QRCAN's widths; QRRDBNet takes nf, nb, gc
        if k != "scale":
            internal.pop(k)
    internal.update({k: GAN_FULL[k] for k in ("nf", "nb", "gc")})
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
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    if (any(launches.values()) or len(forwards) != 2 * VALIDATION_FORWARDS or len(losses) != 2
            or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]).all()):
        raise AssertionError(f"QRRDBNet BoBW run: launches {launches}, losses {losses}, "
                             f"validation {val}")

    handler = get_model("contrastiveblindqrealesrgan")(
        device="cuda", seed=cfg["training"]["seed"], **internal)
    pipe = ImagePipeline(**BENCH_CHAIN, scale=TRAIN_SCALE)

    def input_fn(generator, b):
        return {"lr": pipe.degrade_batch(generator, b["hr"])[0], "hr": b["hr"]}

    handler.set_input_pipeline(input_fn)
    state = handler.init_state()
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    fixed = without_grad(lambda: input_fn(card_generator(125), {"hr": hr16}))
    steps_row = phase_step_row(rcab, handler, state, {"hr": hr16},
                               "contrastiveblindqrealesrgan x4 23x64 bf16",
                               pair_loss(handler, fixed))
    if any(steps_row["launches_a_step"].values()) or not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"a QRRDBNet BoBW step: {steps_row}")
    del handler, state
    torch.cuda.empty_cache()

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", QREALESRGAN_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    if (len(values) != images or not np.isfinite(list(values.values())).all()
            or len(eval_forwards) != images):
        raise AssertionError(f"eval_sisr of the QRRDBNet BoBW run: {len(values)} rows, "
                             f"{len(eval_forwards)} forwards")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))
    row = {"phase": "bobw_qrealesrgan", "model": "contrastiveblindqrealesrgan x4 QRRDBNet "
           f"23x64 gc32 bf16, frozen {PACKAGED_ENCODER}", "card": card, "config": BOBW_CONFIG,
           "steps": DEGRADE_STEPS, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "launches": launches, "epoch_train_loss": losses, **val,
           "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "eval_sisr_s": cli_seconds, "eval_images_per_s": images / cli_seconds,
           "eval_mean": mean, "fixed_batch": dict(steps_row, chain="bench.py:133-143")}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def seeded_vgg19_npz(path, seed):
    """VGG-19 weights in the flax-layout npz the port reads (``Conv_<i>/
    kernel`` HWIO, ``Conv_<i>/bias``), He-scaled normal draws from a seed:
    pretrained VGG weights stay gated."""
    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for c in (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512, 512, 512, 512):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((3, 3, cin, c), dtype=np.float32)
                                   * np.float32(np.sqrt(2.0 / (9 * cin))))
        out[f"Conv_{i}/bias"] = np.zeros(c, np.float32)
        cin, i = c, i + 1
    np.savez(path, **out)
    return path


def gan_family_phase(rcab, card):
    """The rest of the GAN group at full width, bf16, batch 16: esrgan (RRDBNet
    23 x 64, VGG-128 discriminator 64, LR 32 so that HR is 128 x 128, the
    VGG-19 conv5_4 content term from a seeded npz): a pre-train and an
    adversarial step; bsrgan and qrealesrgan (U-Net SN): an adversarial
    step each; danv1qrealesrgan (DAN v1 on QRRDBNet 23 x 64, loop 4, the DAN
    example's chain corrected to the PCA code): a pre-train and an
    adversarial step. Returns the row."""
    from rumpy_tpu_torch.config.loader import load_config
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_gan_family")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(126))
    npz = seeded_vgg19_npz(os.path.join(root, "vgg19_seeded.npz"), 127)
    rows = {}
    batch32 = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH, crop=GAN_CROP)
    handler = get_model("esrgan")(device="cuda", dtype="bf16", lr=1e-4, vgg_weights=npz,
                                  **GAN_FULL)
    state = handler.init_state()
    rows["esrgan"] = gan_phase_rows(rcab, handler, state, batch32,
                                    "esrgan x4 23x64 bf16 VGG-128 64 vgg conv5_4", batch32,
                                    (0, handler.pretrain_epochs), steps=1)
    del handler, state
    torch.cuda.empty_cache()
    batch48 = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)
    batch48["metadata"] = torch.rand(TRAIN_BATCH, 1, generator=card_generator(128),
                                     device="cuda")
    for name in ("bsrgan", "qrealesrgan"):
        handler = get_model(name)(device="cuda", dtype="bf16", lr=1e-4, **GAN_FULL)
        state = handler.init_state()
        rows[name] = gan_phase_rows(rcab, handler, state, batch48,
                                    f"{name} x4 23x64 bf16 U-Net SN 64", batch48, (0,), steps=1)
        del handler, state
        torch.cuda.empty_cache()
    cfg = load_config(os.path.join(ROOT, DAN_CONFIG)).as_plain()
    cfg["data"].update(online_degradations=pca_kernel_chain(cfg["data"]["online_degradations"]),
                       metadata=["blur_kernel"])
    cfg["data"]["training_sets"] = {"data_1": {"hr_dir": hr_dir}}
    cfg["data"].pop("eval_sets", None)
    cfg["experiment_save_loc"] = root
    cfg["model"] = {"name": "danv1qrealesrgan", "internal_params": dict(
        GAN_FULL, loop=DAN_LOOP, dtype="bf16", lr=1e-4, pretrain_epochs=1)}
    handler, state = trained_handler(cfg, root, "danv1qrealesrgan")
    hr16 = fixed_hr_batch(hr_dir, TRAIN_BATCH)
    fixed = without_grad(lambda: handler.input_fn(card_generator(129), {"hr": hr16}))
    rows["danv1qrealesrgan"] = gan_phase_rows(
        rcab, handler, state, {"hr": hr16}, "danv1qrealesrgan x4 QRRDBNet 23x64 loop 4 bf16",
        fixed, (0, 1), steps=1)
    del handler, state
    torch.cuda.empty_cache()
    row = {"phase": "gan_family", "card": card, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "esrgan_crop": GAN_CROP, "vgg_weights": "seeded random npz (pretrained gated)",
           "steps": rows}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def metabed_phase(rcab, card):
    """Metabed at its defaults (8 blocks x 64, res_scale 0.1, bf16) on a
    fixed LR/HR batch (16 x 48) with 5 metadata values: two steps with
    each of its six meta types; the autoencoder (use_encoder, one pretrain
    epoch) before and after its phase flip; metabedesrgan (LR 32, VGG-128):
    a pre-train and an adversarial step; one contrastiveblindmetabed step
    (front_only q-layer, the frozen packaged encoder, bench.py's chain).
    Returns the row."""
    from rumpy_tpu_torch.models.metabed import META_TYPES
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_metabed")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(130))
    batch = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)
    batch["metadata"] = torch.rand(TRAIN_BATCH, META_LEN, generator=card_generator(131),
                                   device="cuda")
    by_type = {}
    for meta in META_TYPES:
        handler = get_model("metabed")(device="cuda", dtype="bf16", lr=1e-4, meta_block=meta,
                                       metadata_bypass_len=META_LEN)
        state = handler.init_state()
        r = step_row(rcab, handler, state, batch, f"metabed {meta}")
        if any(r["launches_a_step"].values()):
            raise AssertionError(f"metabed {meta}: {r}")
        by_type[meta] = {k: r[k] for k in ("step_ms", "hr_megapixels_per_s", "peak_memory_bytes",
                                           "conv2d_calls_a_step", "losses")}
        del handler, state
        torch.cuda.empty_cache()
    handler = get_model("metabed")(device="cuda", dtype="bf16", lr=1e-4, meta_block="q-layer",
                                   metadata_bypass_len=META_LEN, use_encoder=True,
                                   encoder_pretrain_epochs=1)
    state = handler.init_state()
    ae = {}
    for epoch in (0, 1):
        handler.set_epoch(epoch)
        state, l = handler.train_batch(state, batch)
        ae[epoch] = {k: float(v) for k, v in l.items()}
    if not (ae[0]["scaled-l1-loss-ae"] > 0 and ae[1]["scaled-l1-loss-ae"] == 0):
        raise AssertionError(f"Metabed autoencoder phases: {ae}")
    del handler, state
    torch.cuda.empty_cache()
    batch32 = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH, crop=GAN_CROP)
    batch32["metadata"] = batch["metadata"][:, :1]
    handler = get_model("metabedesrgan")(device="cuda", dtype="bf16", lr=1e-4,
                                         meta_block="q-layer", pretrain_epochs=1)
    state = handler.init_state()
    esrgan = gan_phase_rows(rcab, handler, state, batch32,
                            "metabedesrgan x4 8x64 bf16 VGG-128 64", batch32, (0, 1), steps=1)
    del handler, state
    torch.cuda.empty_cache()
    bobw = one_bobw_step(rcab, "contrastiveblindmetabed", fixed_hr_batch(hr_dir, TRAIN_BATCH), 132)
    row = {"phase": "metabed", "card": card, "model": "metabed x4 8x64 res_scale 0.1 bf16",
           "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "metadata_values": META_LEN,
           "meta_types": by_type, "autoencoder_phases": ae, "metabedesrgan": esrgan,
           "contrastiveblindmetabed_step": bobw}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


# ---------------------------------------------------------------------------
# The face group (slice 15): CelebA-format sets written here as .npy images
# (the card machine has no PIL) beside a list_attr_celeba.txt table.
# ---------------------------------------------------------------------------

CELEBA_ATTRIBUTES = (
    "5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs Big_Lips Big_Nose "
    "Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows Chubby Double_Chin Eyeglasses "
    "Goatee Gray_Hair Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open Mustache "
    "Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose Receding_Hairline Rosy_Cheeks "
    "Sideburns Smiling Straight_Hair Wavy_Hair Wearing_Earrings Wearing_Hat Wearing_Lipstick "
    "Wearing_Necklace Wearing_Necktie Young").split()
FACE_HR = (216, 176)  # CelebA's aligned 218 x 178 faces, cut to a multiple of 4
FACE_IMAGES, FACE_POSITIVES = 32, 20  # Male: 20 positives, 12 negatives
FACE_CROP = 32  # LR crop of the x4 models: HR 128
FACE_EVAL_IMAGES = 4
SPLIT_FULL = dict(scale=4, n_feats=64, n_resgroups=10, n_resblocks=20)  # two RCANs
SPLIT_EXP = "rcansplitceleb_x4"
SPLIT_EPOCHS = 2
SPARNET_SIDE = 128  # SPARNet's in_size and out_size (its defaults)
FACEGAN_FULL = dict(latent_dim=100, nf=128)  # its defaults
FACEGAN_SIDE = 80


def write_celeba_set(root, rng, images, positives, hr_shape=FACE_HR, scale=TRAIN_SCALE):
    """A CelebA-format set: ``images`` textured HR faces ``000001.npy`` ...
    (uint8 HWC), their decimations by ``scale`` (x4 by default), and
    list_attr_celeba.txt (a count line, the 40 names, a row of -1/1 an image
    named NNNNNN.jpg) with ``positives`` images Male. Returns (lr_dir,
    hr_dir, attributes file, {name: Male 0/1})."""
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    yy, xx = np.mgrid[:hr_shape[0], :hr_shape[1]].astype(np.float32)
    male = np.zeros(images, np.int64)
    male[rng.permutation(images)[:positives]] = 1
    rows, gender = [], {}
    for k in range(images):
        stem = f"{k + 1:06d}"
        amp = 70.0 * (0.5 + 0.5 * np.sin(xx / (20.0 + k) + k)) * (0.5 + 0.5 * np.cos(yy / 17.0))
        hr = np.clip(128.0 + amp[..., None] * rng.standard_normal((*hr_shape, 3),
                                                                  dtype=np.float32), 0, 255)
        hr = hr.astype(np.uint8)
        np.save(os.path.join(hr_dir, f"{stem}.npy"), hr)
        np.save(os.path.join(lr_dir, f"{stem}.npy"), np.ascontiguousarray(hr[::scale, ::scale]))
        values = rng.choice([-1, 1], len(CELEBA_ATTRIBUTES))
        values[CELEBA_ATTRIBUTES.index("Male")] = 1 if male[k] else -1
        rows.append(f"{stem}.jpg " + " ".join(f"{v:2d}" for v in values))
        gender[f"{stem}.npy"] = int(male[k])
    attrs = os.path.join(root, "list_attr_celeba.txt")
    with open(attrs, "w") as f:
        f.write(f"{images}\n" + " ".join(CELEBA_ATTRIBUTES) + "\n" + "\n".join(rows) + "\n")
    return lr_dir, hr_dir, attrs, gender


@contextlib.contextmanager
def imports_blocked(*names):
    """While the block runs, importing any of ``names`` raises ImportError."""
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(dict.fromkeys(names))
    try:
        yield
    finally:
        for n, module in saved.items():
            if module is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = module


def face_data_phase(card):
    """The face slice's data layer on the card machine, from files written
    here: a CelebA-format set read through SuperResImages with all 40
    attributes, a blacklist CSV, a patch-location CSV (a tuple index and a
    plain name) and loss masks (one smaller than its target, centred in a
    zero field); the selected and amplified attributes; CelebaSplitSampler's
    order; VideoSequenceImages over 5 frames with a uvtex mask, its bundles
    coherent under four threads. It reads with pandas and PIL made
    unimportable."""
    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_face_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(150)
    images = 12
    lr_dir, hr_dir, attrs, gender = write_celeba_set(root, rng, images, 7, hr_shape=(64, 56))
    names = sorted(gender)
    blacklist = os.path.join(root, "blacklist.csv")
    with open(blacklist, "w") as f:
        f.write(f"Images,reason\n{names[2]},blurred\n")
    patches = os.path.join(root, "patches.csv")
    with open(patches, "w") as f:
        f.write(",high_entropy_patches_left_corner\n"
                f"\"('{names[1]}', 0)\",\"[(2, 3), (5, 1)]\"\n{names[3]},\"[(0, 6)]\"\n")
    masks = os.path.join(root, "masks")
    os.makedirs(masks)
    for k, n in enumerate(names):
        shape = (40, 30) if k == 4 else (64, 56)
        np.save(os.path.join(masks, n), (rng.random((*shape, 3)) > 0.3).astype(np.uint8) * 255)
    with imports_blocked("pandas", "PIL"):
        row = read_face_files(card, root, lr_dir, hr_dir, attrs, gender, blacklist, patches,
                              masks, images)
    print(json.dumps(row), flush=True)
    if not (all(v for k, v in row.items() if k.endswith("_ok") or k == "blacklisted_dropped")
            and row["listed_after_blacklist"] == images - 1):
        raise AssertionError(f"face data layer: {row}")
    shutil.rmtree(root)
    return row


def read_face_files(card, root, lr_dir, hr_dir, attrs, gender, blacklist, patches, masks,
                    images):
    """face_data's reads and checks: its row."""
    from concurrent.futures import ThreadPoolExecutor

    from rumpy_tpu_torch.data.datasets import SuperResImages, VideoSequenceImages
    from rumpy_tpu_torch.data.loader import CelebaSplitSampler

    names = sorted(gender)
    t0 = time.perf_counter()
    kw = dict(lr_dir=lr_dir, hr_dir=hr_dir, scale=TRAIN_SCALE, attributes_loc=attrs,
              blacklist=blacklist, predefined_patch_location=patches, mask_data=masks,
              crop=8, device="cuda")
    ds = SuperResImages(**kw)
    keys_ok = ds.metadata_keys == [f"celeba-{a.lower()}" for a in CELEBA_ATTRIBUTES]
    listed = [os.path.basename(f) for f in ds.lr_files]
    items = {os.path.basename(f): ds[i] for i, f in enumerate(ds.lr_files)}
    lr1 = np.load(os.path.join(lr_dir, names[1])).astype(np.float32) / 255.0
    lr3 = np.load(os.path.join(lr_dir, names[3])).astype(np.float32) / 255.0
    patch_ok = bool(np.array_equal(items[names[1]]["lr"], lr1[2:10, 3:11])
                    and np.array_equal(items[names[3]]["lr"], lr3[0:8, 6:14]))
    whole = SuperResImages(**dict(kw, crop=None))[listed.index(names[4])]["mask"]
    mask_ok = bool(all(it["mask"].shape == (32, 32, 3) for it in items.values())
                   and whole.shape == (64, 56, 3) and not whole[:12].any()
                   and not whole[:, :13].any() and whole[12:52, 13:43].any())
    gender_col = ds.metadata_keys.index("celeba-male")
    attr_ok = bool(all(items[n]["metadata"][gender_col] == gender[n] for n in items))
    picked = SuperResImages(**dict(kw, data_attributes=["gender", "age"],
                                   attribute_amplification=True))
    amplified = np.stack([picked[i]["metadata"] for i in range(len(picked))])
    amp_ok = bool(picked.metadata_keys == ["celeba-gender", "celeba-age"]
              and set(np.unique(amplified)) <= {-2.0, 2.0}
              and np.array_equal(amplified[:, 0] > 0, [gender[n] == 1 for n in listed]))
    split = SuperResImages(**dict(kw, data_attributes=["gender"]))
    sampler = CelebaSplitSampler(split, selected_attribute="gender", seed=1)
    orders = [list(iter(sampler)) for _ in range(2)]
    npos = sum(gender[n] for n in listed)
    sampler_ok = bool(all(all(gender[listed[i]] == 1 for i in o[:npos])
                     and all(gender[listed[i]] == 0 for i in o[npos:])
                          and sorted(o) == list(range(len(listed))) for o in orders))

    frames = os.path.join(root, "frames")
    yy, xx = np.mgrid[0:40, 0:40]
    pos = ((yy * 40 + xx) % 251).astype(np.uint8)
    for d in ("lr", "hr"):
        os.makedirs(os.path.join(frames, d))
    for i in range(7):
        frame = np.stack([pos, np.full_like(pos, i * 30), pos], -1)
        np.save(os.path.join(frames, "lr", f"f{i:03d}.npy"), frame[::TRAIN_SCALE, ::TRAIN_SCALE])
        np.save(os.path.join(frames, "hr", f"f{i:03d}.npy"), frame)
    np.save(os.path.join(frames, "hr", "uvtex_mask.npy"), np.full((40, 40, 3), 255, np.uint8))
    vsr = VideoSequenceImages(lr_dir=os.path.join(frames, "lr"),
                              hr_dir=os.path.join(frames, "hr"), scale=TRAIN_SCALE,
                              num_frames=5, use_masks=True, custom_mask_name="uvtex_mask.npy",
                              crop=4, augmentations=True, seed=0, device="cuda")
    first = vsr[0]

    def coherent(idx):
        bundle = vsr[idx]["lr"]
        return all(np.array_equal(bundle[..., 0], bundle[..., 3 * f]) for f in range(1, 5))

    with ThreadPoolExecutor(max_workers=4) as pool:
        vsr_ok = all(pool.map(coherent, list(range(len(vsr))) * 8))
    vsr_ok = vsr_ok and (len(vsr) == 3 and first["lr"].shape == (4, 4, 15)
                         and first["tag"] == "f002.npy" and first["mask"].shape == (16, 16, 3))
    return {"phase": "face_data", "card": card, "seconds": time.perf_counter() - t0,
            "read_with_pandas_and_PIL_unimportable": True,
            "images": images, "listed_after_blacklist": len(listed),
            "blacklisted_dropped": names[2] not in listed, "attribute_keys_ok": keys_ok,
            "attributes_ok": attr_ok, "patch_csv_corners_ok": patch_ok, "masks_ok": mask_ok,
            "selected_amplified_ok": amp_ok, "sampler_positives": npos,
            "sampler_order_ok": sampler_ok, "sampler_epochs_differ": orders[0] != orders[1],
            "vsr_windows": len(vsr), "vsr_bundle_coherent_under_threads_ok": vsr_ok}


def fixed_face_batch(lr_dir, hr_dir, batch, gate):
    """Centre crops of FACE_CROP LR pixels and their HR pixels of the face
    set's first ``batch`` images, on the card, with ``gate`` as each image's
    one metadata value."""
    pairs = fixed_pair_batch(lr_dir, hr_dir, batch, crop=FACE_CROP)
    pairs["metadata"] = torch.tensor(gate, dtype=torch.float32)[:, None].to(pairs["lr"].device)
    return pairs


def update_hook_ms(handler, state, batch, steps=3):
    """A step's ms with the handler's update hook (its parameter copy
    before the optimizer, the masked update after it) against the same
    step with the base handler's identity hook, which makes no copy."""
    from rumpy_tpu_torch.models.base import BaseHandler
    cls = type(handler)
    with_hook = cuda_ms(lambda: handler.train_batch(state, batch), steps, warmup=1, backlog_s=0)
    hook = cls.transform_updates
    cls.transform_updates = BaseHandler.transform_updates
    try:
        without = cuda_ms(lambda: handler.train_batch(state, batch), steps, warmup=1,
                          backlog_s=0)
    finally:
        cls.transform_updates = hook
    return with_hook, without


def rcansplit_train_phase(rcab, card):
    """The slice's main path: rcansplitceleb x4 (two RCANs 10 x 20 x 64,
    bf16: each expert's 200 RCABs on the kernels, 400 forward launches a
    forward and 400 backward a step) through cli.train_sisr on a
    CelebA-format set (32 faces of 216 x 176, 20 Male) with the set's
    attributes (data_attributes ["gender"], metadata ["gender"]) and
    CelebaSplitSampler on gender (batch 16, LR crop 32, 2 epochs of 2 steps,
    validating on 4 faces), cli.eval_sisr on the run with the attributes
    given by the eval config, then steady steps on a mixed batch, the update
    hook's cost, and a single-allocation step under sync debug "error":
    expert b bit for bit, negative-loss NaN. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_rcansplit")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(151)
    lr_dir, hr_dir, attrs, gender = write_celeba_set(os.path.join(root, "data"), rng,
                                                     FACE_IMAGES, FACE_POSITIVES)
    e_lr, e_hr, e_attrs, _ = write_celeba_set(os.path.join(root, "eval_data"), rng,
                                              FACE_EVAL_IMAGES, 2)
    internal = dict(SPLIT_FULL, dtype="bf16", lr=1e-4, optimizer_type="adam")
    seed, exp_root = 5, os.path.join(root, "experiments")
    split = {"attributes_loc": attrs, "data_attributes": ["gender"]}
    cfg = {"experiment": SPLIT_EXP, "experiment_save_loc": exp_root,
           "data": {"scale": TRAIN_SCALE, "crop": FACE_CROP, "augmentations": True,
                    "dataloader_threads": 4, "metadata": ["gender"],
                    "sampler_attributes": {"name": "celebasplitsampler",
                                           "selected_attribute": "gender"},
                    "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir, **split}},
                    "eval_sets": {"data_1": {"lr_dir": e_lr, "hr_dir": e_hr,
                                             "attributes_loc": e_attrs,
                                             "data_attributes": ["gender"]}}},
           "model": {"name": "rcansplitceleb", "internal_params": internal},
           "training": {"num_epochs": SPLIT_EPOCHS, "batch_size": TRAIN_BATCH, "seed": seed}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    steps = SPLIT_EPOCHS * (FACE_IMAGES // TRAIN_BATCH)
    blocks = 2 * SPLIT_FULL["n_resgroups"] * SPLIT_FULL["n_resblocks"]  # both experts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    FORM_LAUNCHES.clear()
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    want = {"rcab_fused": blocks * (steps + len(forwards)),
            "rcab_fused_backward": blocks * steps}
    forms = dict(FORM_LAUNCHES)
    if (launches != want or len(forwards) != SPLIT_EPOCHS
            or set(forms) != {"forward/shared", "backward/shared"}):
        raise AssertionError(f"kernel launches in the rcansplitceleb run {launches} by form "
                             f"{forms}, expected {want} ({len(forwards)} validation forwards)")
    launches["rcab_fused_validation"] = blocks * len(forwards)
    epochs = [stats[e] for e in sorted(stats)]
    losses = {k: [e.get(k) for e in epochs] for k in ("train-loss", "positive-loss",
                                                      "negative-loss", "val-PSNR", "val-SSIM")}
    if len(epochs) != SPLIT_EPOCHS or not np.isfinite(
            losses["train-loss"] + losses["val-PSNR"] + losses["val-SSIM"]).all():
        raise AssertionError(f"rcansplitceleb run: {losses}")

    eval_cfg = os.path.join(root, "eval.toml")
    dump_toml({"data": {"lr_dir": e_lr, "hr_dir": e_hr, "attributes_loc": e_attrs,
                        "data_attributes": ["gender"]}}, eval_cfg)
    out = os.path.join(root, "eval")
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["-c", eval_cfg, "--model_loc", exp_root, "--scale", str(TRAIN_SCALE),
                        "-m", "PSNR", "-m", "SSIM", "-me", SPLIT_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    if (len(values) != FACE_EVAL_IMAGES or (SPLIT_EXP, "PSNR") not in columns
            or not np.isfinite(list(values.values())).all()
            or len(eval_forwards) != FACE_EVAL_IMAGES
            or eval_launches != blocks * FACE_EVAL_IMAGES):
        raise AssertionError(f"eval_sisr of the rcansplitceleb run: columns {columns}, "
                             f"{len(values)} rows, {len(eval_forwards)} forwards, "
                             f"{eval_launches} launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    handler = get_model("rcansplitceleb")(device="cuda", seed=seed, **internal)
    state = handler.init_state()
    gate = [1.0] * 10 + [0.0] * (TRAIN_BATCH - 10)
    mixed = fixed_face_batch(lr_dir, hr_dir, TRAIN_BATCH, gate)
    steps_row = phase_step_row(rcab, handler, state, mixed, "rcansplitceleb x4 2x10x20x64 bf16",
                               pair_loss(handler, mixed))
    if steps_row["launches_a_step"] != {"rcab_fused": blocks, "rcab_fused_backward": blocks} \
            or set(steps_row["launches_a_step_by_form"]) != {"forward/shared",
                                                             "backward/shared"}:
        raise AssertionError(f"an rcansplitceleb step launched {steps_row['launches_a_step']}")
    with_hook, without_hook = update_hook_ms(handler, state, mixed)
    single = dict(mixed, metadata=torch.ones_like(mixed["metadata"]))
    expert_b = [p.detach().clone() for p in handler.module.expert_b.parameters()]
    expert_a = [p.detach().clone() for p in handler.module.expert_a.parameters()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, single_losses = handler.train_batch(state, single)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b_kept = all(torch.equal(a, b) for a, b in zip(handler.module.expert_b.parameters(), expert_b))
    a_moved = sum(not torch.equal(a, b) for a, b in zip(handler.module.expert_a.parameters(),
                                                        expert_a))
    single_losses = {k: float(v) for k, v in single_losses.items()}
    n_params = sum(p.numel() for p in handler.module.parameters())
    row = {"phase": "rcansplit_train", "model": "rcansplitceleb x4 2 x 10x20x64 bf16",
           "card": card, "steps": steps, "batch": TRAIN_BATCH, "crop": FACE_CROP,
           "launches": launches, "launches_by_form": forms, "epochs": losses,
           "run_experiment_s": seconds, "peak_memory_bytes_run": peak_run,
           "eval_sisr_s": cli_seconds, "eval_images_per_s": FACE_EVAL_IMAGES / cli_seconds,
           "eval_mean": mean, "eval_rcab_launches": eval_launches,
           "fixed_batch": steps_row, "peak_gb_a_step": steps_row["peak_memory_bytes"] / 1e9,
           "parameters": n_params, "step_ms_with_update_hook": with_hook,
           "step_ms_identity_hook": without_hook,
           "update_hook_copy_ms": with_hook - without_hook,
           "single_allocation_step": {"losses": single_losses,
                                      "expert_b_bit_for_bit": b_kept,
                                      "expert_a_parameters_moved": a_moved,
                                      "sync_debug_error": True}}
    print(json.dumps(row), flush=True)
    if not (b_kept and a_moved and np.isnan(single_losses["negative-loss"])
            and single_losses["train-loss"] == single_losses["positive-loss"]):
        raise AssertionError(f"rcansplitceleb single-allocation step: {row['single_allocation_step']}")
    if not steps_row["loss_lower_after_steps"]:
        raise AssertionError(f"rcansplitceleb fixed-batch loss {steps_row['fixed_batch_loss']}")
    del handler, state
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return row


def interp_face_batch(hr_dir, batch, metadata=None):
    """SPARNet's input: centre crops of SPARNET_SIDE HR pixels, their x4
    decimation upsampled back by bicubic, on the card."""
    import torch.nn.functional as F
    names = sorted(os.listdir(hr_dir))
    crops = []
    for name in (names * batch)[:batch]:
        hr = np.load(os.path.join(hr_dir, name))
        top, left = (hr.shape[0] - SPARNET_SIDE) // 2, (hr.shape[1] - SPARNET_SIDE) // 2
        crops.append(hr[top:top + SPARNET_SIDE, left:left + SPARNET_SIDE])
    hr = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    lr = F.interpolate(hr[:, ::TRAIN_SCALE, ::TRAIN_SCALE].permute(0, 3, 1, 2),
                       scale_factor=TRAIN_SCALE, mode="bicubic", align_corners=False)
    out = {"lr": lr.clamp(0, 1).permute(0, 2, 3, 1).contiguous(), "hr": hr}
    if metadata is not None:
        out["metadata"] = metadata
    return out


def sparnet_train_phase(rcab, card):
    """SPARNet at its defaults (in and out 128, min_ch 32, max_ch 128,
    res_depth 10, BatchNorm, leaky relu; bf16) and QSPARNet on the 40 CelebA
    attributes (metadata ["all"]): steady steps at batch 16 on bicubic
    inputs of face crops (step ms, busy ms, idle share, kernels, peak
    memory; every BatchNorm running statistic moved), eval images/s at
    batch 1; then QSPARNet through cli.train_sisr on a CelebA-format set
    with all its attributes (one epoch of 2 steps, the LR upsampled by the
    data layer). No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_sparnet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(152)
    lr_dir, hr_dir, attrs, _ = write_celeba_set(os.path.join(root, "data"), rng,
                                                FACE_IMAGES, FACE_POSITIVES)
    table = np.loadtxt(attrs, skiprows=2, usecols=range(1, 41))
    meta = torch.from_numpy((table[:TRAIN_BATCH] > 0).astype(np.float32)).cuda()
    rows = {}
    for name, kw in (("sparnet", {}), ("qsparnet", {"metadata": ["all"]})):
        handler = get_model(name)(device="cuda", dtype="bf16", lr=1e-4, seed=6, **kw)
        state = handler.init_state()
        batch = interp_face_batch(hr_dir, TRAIN_BATCH, meta if name == "qsparnet" else None)
        stats0 = running_stats(handler.module)
        step = phase_step_row(rcab, handler, state, batch, f"{name} 128 bf16",
                              pair_loss(handler, batch))
        stats1 = running_stats(handler.module)
        moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
        x = batch["lr"][:1]
        m = None if name == "sparnet" else batch["metadata"][:1]
        handler.run_model(state, x, m)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [handler.run_model(state, batch["lr"][i:i + 1],
                                  None if m is None else batch["metadata"][i:i + 1])
                for i in range(8)]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        row = dict(step, running_stats=len(stats0), running_stats_moved=moved,
                   eval_images_per_s=8 / eval_s,
                   num_metadata=getattr(handler, "num_metadata", 0),
                   parameters=sum(p.numel() for p in handler.module.parameters()))
        rows[name] = row
        if (moved != len(stats0) or not stats0 or any(step["launches_a_step"].values())
                or not all(bool(torch.isfinite(o).all()) and o.shape == (1, 128, 128, 3)
                           for o in outs)
                or row["num_metadata"] != (40 if name == "qsparnet" else 0)):
            raise AssertionError(f"{name} steps: {row}")
        del handler, state
        torch.cuda.empty_cache()

    cfg = {"experiment": "qsparnet_celeba", "experiment_save_loc": os.path.join(root, "exp"),
           "data": {"scale": TRAIN_SCALE, "crop": SPARNET_SIDE, "augmentations": True,
                    "dataloader_threads": 4, "metadata": ["all"],
                    "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir,
                                                 "attributes_loc": attrs}}},
           "model": {"name": "qsparnet", "internal_params": {
               "metadata": ["all"], "dtype": "bf16", "lr": 1e-4}},
           "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 6}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    cli_row = {"run_experiment_s": time.perf_counter() - t0,
               "train_loss": stats[0]["train-loss"],
               "compute_efficiency": stats[0]["compute_efficiency"],
               "launches": {"rcab_fused": rcab.launches,
                            "rcab_fused_backward": rcab.backward_launches}}
    row = {"phase": "sparnet_train", "card": card, "batch": TRAIN_BATCH, **rows,
           "qsparnet_cli": cli_row}
    print(json.dumps(row), flush=True)
    if not np.isfinite(cli_row["train_loss"]) or any(cli_row["launches"].values()):
        raise AssertionError(f"qsparnet through cli.train_sisr: {cli_row}")
    shutil.rmtree(root)
    return row


def facegan_train_phase(rcab, card):
    """FaceGAN at its defaults (latent 100, nf 128; bf16) through
    cli.train_sisr on 32 faces of 80 x 80 (scale 1, batch 16, one epoch of
    2 steps), then steady steps at batch 16 (step ms, busy ms, idle share,
    kernels, peak memory; the discriminator's two train-mode calls a step),
    and 16 generated images in [0, 1]. No RCAB kernel runs. Returns the
    row."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_facegan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(153)
    _, faces, _, _ = write_celeba_set(os.path.join(root, "data"), rng, FACE_IMAGES,
                                      FACE_POSITIVES, hr_shape=(FACEGAN_SIDE, FACEGAN_SIDE))
    internal = dict(FACEGAN_FULL, dtype="bf16", lr=2e-4)
    cfg = {"experiment": "facegan_celeba", "experiment_save_loc": os.path.join(root, "exp"),
           "data": {"scale": 1, "dataloader_threads": 4,
                    "training_sets": {"data_1": {"lr_dir": faces, "hr_dir": faces}}},
           "model": {"name": "facegan", "internal_params": internal},
           "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 7}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    cli_row = {"run_experiment_s": time.perf_counter() - t0,
               **{k: stats[0][k] for k in ("train-loss", "d-loss-real", "d-loss-fake",
                                           "d-acc-real", "d-acc-fake")}}

    handler = get_model("facegan")(device="cuda", seed=7, **internal)
    state = handler.init_state()
    names = sorted(os.listdir(faces))[:TRAIN_BATCH]
    hr = torch.from_numpy(np.stack([np.load(os.path.join(faces, n)) for n in names])
                          .astype(np.float32) / 255.0).cuda()
    batch = {"hr": hr}
    step = step_row(rcab, handler, state, batch, "facegan bf16")
    calls = []
    hook = handler.discriminator.register_forward_pre_hook(
        lambda m, a, kw: calls.append(bool(kw.get("train"))), with_kwargs=True)
    try:
        trace = traced(lambda: handler.train_batch(state, batch), "facegan_step_trace", 1)
    finally:
        hook.remove()
    _, losses = handler.train_batch(state, batch)
    losses = {k: float(v) for k, v in losses.items()}
    z = torch.rand((TRAIN_BATCH, FACEGAN_FULL["latent_dim"]), device=handler.device,
                   generator=handler.rng)
    images = handler.run_eval(state, {"latent": z})
    row = {"phase": "facegan_train", "card": card, "cli": cli_row, **step,
           "model": "facegan latent 100 nf 128 bf16", "step_busy_ms": trace["busy_us"] / 1e3,
           "step_idle_share": trace["idle_share"], "kernels_a_step": trace["kernels_per_call"],
           "d_train_calls_a_step": sum(calls), "d_calls_a_step": len(calls),
           "peak_gb_a_step": step["peak_memory_bytes"] / 1e9, "last_step": losses,
           "generated": list(images.shape), "generated_min": float(images.min()),
           "generated_max": float(images.max()),
           "parameters": sum(p.numel() for p in handler.module.parameters())}
    print(json.dumps(row), flush=True)
    if (not np.isfinite(list(cli_row.values()) + list(losses.values())).all()
            or not all(0 <= losses[k] <= 1 for k in ("d-acc-real", "d-acc-fake"))
            or tuple(images.shape) != (TRAIN_BATCH, FACEGAN_SIDE, FACEGAN_SIDE, 3)
            or not 0 <= row["generated_min"] <= row["generated_max"] <= 1
            or row["d_train_calls_a_step"] != 2 or row["d_calls_a_step"] != 3
            or any(step["launches_a_step"].values())):
        raise AssertionError(f"facegan: {row}")
    del handler, state
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return row

# SwinIR-M, the classical x4 setting of Liang et al. 2021 (KAIR
# options/swinir/train_swinir_sr_classical.json): embed 180, 6 RSTB x 6
# blocks, 6 heads, window 8, mlp 2, pixelshuffle with 64 features
SWINIR_FULL = dict(scale=4, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
                   mlp_ratio=2.0, upsampler="pixelshuffle", num_feat=64)
SWINIR_EXP = "swinir_x4_classical"
# LPIPS on the card against the CPU, relative to the distance: two float32
# AlexNet passes (TF32 off) whose sums run in different orders
LPIPS_REL = 1e-4
# Regressor predictions on the card against the CPU for one batch, relative
# to the largest prediction: float32 convs (TF32 off) summed in other orders
# through up to 169 layers
REGRESSOR_REL = 1e-3
REGRESSORS = {  # label: (handler, options); the defaults, MANet at kernel 21, x4, invariant
    "basicnn": ("basicnn", {}), "resnet18": ("resnet", dict(model_type="resnet18")),
    "resnet50": ("resnet", dict(model_type="resnet50")), "densenet": ("densenet", {}),
    "efficientnet": ("efficientnet", {}),
    "manet": ("manet", dict(kernel_size=21, sr_scale=TRAIN_SCALE, invariant_kernel=True))}
REGRESSION_VIEWS = 8  # LR patches cut from each training HR image


def seeded_lpips_npz(path, seed):
    """LPIPS weights in the npz layout the port reads (AlexNet's
    ``Conv_<i>/kernel`` HWIO and ``Conv_<i>/bias``, positive ``lin<i>``
    heads), He-scaled normal draws from a seed: pretrained weights stay
    gated."""
    from rumpy_tpu_torch.utils.lpips import ALEX_CFG
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, (f, k, _, _) in enumerate(ALEX_CFG):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, cin, f), dtype=np.float32)
                                   * np.float32(np.sqrt(2.0 / (k * k * cin))))
        out[f"Conv_{i}/bias"] = np.zeros(f, np.float32)
        cin = f
    for i, (f, _, _, _) in enumerate(ALEX_CFG):
        out[f"lin{i}"] = (0.1 * rng.random((f, 1))).astype(np.float32)
    np.savez(path, **out)
    return path


def step_without_sync(handler, state, batch):
    """One train step under sync debug mode "error": it raises if the step
    waits for the card. Returns its losses as floats."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, losses = handler.train_batch(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {k: float(v) for k, v in losses.items()}


def no_rcab(name, *launch_dicts):
    """Fails if any of the phase's counts shows an RCAB launch."""
    for d in launch_dicts:
        if any(d.values()):
            raise AssertionError(f"{name} launched RCAB kernels: {d}")


def swinir_train_phase(rcab, card):
    """The slice's main path: SwinIR-M x4 (embed 180, 6 RSTB x 6 blocks, 6
    heads, window 8, pixelshuffle; bf16) through cli.train_sisr on LR/HR
    pairs (batch 16, crop 48, 2 epochs of 2 steps, validating each epoch on
    the 9 eval pairs), cli.eval_sisr on the run with -m PSNR SSIM LPIPS and
    a seeded LPIPS npz; steady steps on a fixed batch and one under sync
    debug "error"; a DIV2K-sized forward's device ms, peak memory and top
    kernels; LPIPS's device ms on a DIV2K-sized pair and its values on the
    card against the CPU; one step at the handler's defaults (embed 60,
    4 x 6, float32). No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.utils.lpips import LPIPS

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_swinir")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(160))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(161))
    weights = seeded_lpips_npz(os.path.join(root, "lpips.npz"), 162)
    internal = dict(SWINIR_FULL, dtype="bf16", lr=2e-4)
    seed, exp_root = 8, os.path.join(root, "experiments")
    cfg = {"experiment": SWINIR_EXP, "experiment_save_loc": exp_root,
           "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "augmentations": True,
                    "dataloader_threads": 4,
                    "training_sets": {f"data_{i}": {"lr_dir": lr_dir, "hr_dir": hr_dir}
                                      for i in range(TRAIN_SETS)},
                    "eval_sets": {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}},
           "model": {"name": "swinir", "internal_params": internal},
           "training": {"num_epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH, "seed": seed}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES * TRAIN_SETS // TRAIN_BATCH)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    no_rcab("the SwinIR run", launches)
    if (len(losses) != TRAIN_EPOCHS or len(forwards) != 2 * VALIDATION_FORWARDS
            or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]).all()):
        raise AssertionError(f"SwinIR run: losses {losses}, validation {val}, "
                             f"{len(forwards)} validation forwards")

    out = os.path.join(root, "eval")
    images = len(EVAL_LR_SHAPES)
    rcab.launches = 0
    with watched(SISRInterface, "net_run") as eval_forwards:
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM", "-m", "LPIPS",
                        "--lpips_weights", weights, "-me", SWINIR_EXP, "best", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
    eval_launches = rcab.launches
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    want_cols = {(m, k) for m in ("bicubic", SWINIR_EXP) for k in ("PSNR", "SSIM", "LPIPS")}
    if (len(values) != images or not want_cols <= set(columns) or eval_launches
            or not np.isfinite(list(values.values())).all() or len(eval_forwards) != images):
        raise AssertionError(f"eval_sisr of the SwinIR run: columns {columns}, {len(values)} "
                             f"rows, {len(eval_forwards)} forwards, {eval_launches} launches")
    mean = dict(zip([f"{m}>{k}" for m, k in columns],
                    np.mean(list(values.values()), axis=0).tolist()))

    handler = get_model("swinir")(device="cuda", seed=seed, **internal)
    state = handler.init_state()
    fixed = fixed_pair_batch(lr_dir, hr_dir, TRAIN_BATCH)
    steps_row = phase_step_row(rcab, handler, state, fixed, "swinir x4 180 6x6 bf16",
                               pair_loss(handler, fixed))
    unsynced = step_without_sync(handler, state, fixed)
    no_rcab("a SwinIR step", steps_row["launches_a_step"])
    x = torch.from_numpy(np.load(os.path.join(eval_lr, sorted(os.listdir(eval_lr))[0]))
                         .astype(np.float32) / 255.0)[None].cuda()
    if tuple(x.shape[1:3]) != DIV2K_LR:
        raise AssertionError(f"the first eval image is {tuple(x.shape)}")
    forward = lambda: handler.run_eval(state, {"lr": x})
    forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forward_ms = cuda_ms(forward, 2, warmup=1, backlog_s=0)
    peak_forward = torch.cuda.max_memory_allocated()
    trace = traced(forward, "swinir_div2k_forward_trace", 1, by_kernel=True)
    top = sorted(trace["per_call_device_us_by_kernel"].items(), key=lambda kv: -kv[1])[:10]
    n_params = sum(p.numel() for p in handler.module.parameters())
    del handler, state
    torch.cuda.empty_cache()

    # LPIPS: one DIV2K-sized pair's device ms, and the Set5-sized HR images
    # against their nearest x4 spread of the LR, card against CPU
    names = sorted(os.listdir(eval_hr))
    hr_imgs = [np.load(os.path.join(eval_hr, n)).astype(np.float32) / 255.0 for n in names]
    lr_imgs = [np.load(os.path.join(eval_lr, n)).astype(np.float32) / 255.0 for n in names]
    lp_card, lp_cpu = LPIPS(weights), LPIPS(weights, device="cpu")
    a = torch.from_numpy(hr_imgs[0])[None].cuda()
    b = torch.from_numpy(lr_imgs[0].repeat(TRAIN_SCALE, 0).repeat(TRAIN_SCALE, 1))[None].cuda()
    lpips_ms = cuda_ms(lambda: lp_card(a, b), 3, warmup=1)
    card_vals, cpu_vals = [], []
    for hr_img, lr_img in list(zip(hr_imgs, lr_imgs))[EVAL_DIV2K:]:
        near = lr_img.repeat(TRAIN_SCALE, 0).repeat(TRAIN_SCALE, 1)
        pair = (torch.from_numpy(hr_img)[None], torch.from_numpy(near)[None])
        card_vals.append(float(lp_card(*(t.cuda() for t in pair))[0]))
        cpu_vals.append(float(lp_cpu(*pair)[0]))
    lpips_rel = max(abs(c - p) / abs(p) for c, p in zip(card_vals, cpu_vals))

    defaults = get_model("swinir")(device="cuda", seed=seed)
    d_state = defaults.init_state()
    default_row = step_row(rcab, defaults, d_state, fixed, "swinir x4 defaults 60 4x6 f32",
                           steps=1)
    no_rcab("a SwinIR step at the defaults", default_row["launches_a_step"])
    del defaults, d_state
    torch.cuda.empty_cache()

    row = {"phase": "swinir_train", "model": "swinir x4 embed 180, 6 RSTB x 6, heads 6, "
           "window 8, pixelshuffle 64, bf16", "card": card, "parameters": n_params,
           "steps": steps, "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "launches": launches,
           "epoch_train_loss": losses, **val, "run_experiment_s": seconds,
           "peak_memory_bytes_run": peak_run, "eval_sisr_s": cli_seconds,
           "eval_images_per_s": images / cli_seconds, "eval_mean": mean,
           "eval_rcab_launches": eval_launches, "fixed_batch": steps_row,
           "step_under_sync_debug_error": unsynced,
           "div2k_lr": DIV2K_LR, "div2k_padded_to": (344, 512),
           "forward_div2k_ms": forward_ms, "forward_div2k_busy_ms": trace["busy_us"] / 1e3,
           "forward_div2k_kernels": trace["kernels_per_call"],
           "forward_div2k_peak_memory_bytes": peak_forward,
           "forward_div2k_top_kernels_us": dict(top),
           "lpips_div2k_pair_ms": lpips_ms, "lpips_card": card_vals, "lpips_cpu": cpu_vals,
           "lpips_card_vs_cpu_rel": lpips_rel, "defaults_step": default_row}
    print(json.dumps(row), flush=True)
    if (lpips_rel > LPIPS_REL or not steps_row["loss_lower_after_steps"]
            or not np.isfinite(list(unsynced.values())).all()):
        raise AssertionError(f"SwinIR: LPIPS card against CPU {lpips_rel}, fixed-batch loss "
                             f"{steps_row['fixed_batch_loss']}, unsynced step {unsynced}")
    shutil.rmtree(root)
    return row


def interp_y_batch(lr_dir, hr_dir, batch):
    """SRCNN's and VDSR's input: centre crops of TRAIN_CROP LR pixels
    upsampled x4 by bicubic and the matching HR crops, both as the Y channel
    (jpg-mode BT.601), on the card."""
    import torch.nn.functional as F
    from rumpy_tpu_torch.utils.color import rgb_to_ycbcr
    pair = fixed_pair_batch(lr_dir, hr_dir, batch)
    up = F.interpolate(pair["lr"].permute(0, 3, 1, 2), scale_factor=TRAIN_SCALE,
                       mode="bicubic", align_corners=False).clamp(0, 1).permute(0, 2, 3, 1)
    return {"lr": rgb_to_ycbcr(up.contiguous(), y_only=True, im_type="jpg"),
            "hr": rgb_to_ycbcr(pair["hr"], y_only=True, im_type="jpg")}


def basic_train_phase(rcab, card):
    """SRCNN (9-5-5, 64 and 32 features) and VDSR (20 3 x 3 convs of 64, the
    global residual, the gradient clip at 0.1) at their defaults, float32,
    through cli.train_sisr on LR/HR pairs (the data layer upsamples each LR
    crop x4 by bicubic and takes the Y channel; batch 16, LR crop 48, one
    epoch of 2 steps, validating on the 9 eval pairs) and cli.eval_sisr;
    steady steps on a fixed Y batch, one under sync debug "error", and in
    each of VDSR's steps the global gradient norm before and after its clip
    (the clip runs in every VDSR step and none of SRCNN's). No RCAB kernel
    runs.
    Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.models import base
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_basic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lr_dir, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(170))
    eval_lr, eval_hr = write_eval_pairs(os.path.join(root, "eval_data"),
                                        np.random.default_rng(171))
    fixed = interp_y_batch(lr_dir, hr_dir, TRAIN_BATCH)
    images = len(EVAL_LR_SHAPES)
    rows = {}
    for name in ("srcnn", "vdsr"):
        exp_root = os.path.join(root, f"{name}_experiments")
        cfg = {"experiment": f"{name}_x4", "experiment_save_loc": exp_root,
               "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "augmentations": True,
                        "dataloader_threads": 4,
                        "training_sets": {f"data_{i}": {"lr_dir": lr_dir, "hr_dir": hr_dir}
                                          for i in range(4)},
                        "eval_sets": {"data_1": {"lr_dir": eval_lr, "hr_dir": eval_hr}}},
               "model": {"name": name, "internal_params": {"lr": 1e-4}},
               "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 9}}
        cfg_path = os.path.join(root, f"{name}.toml")
        dump_toml(cfg, cfg_path)
        rcab.launches = rcab.backward_launches = 0
        t0 = time.perf_counter()
        with watched(SISRInterface, "net_run") as forwards:
            stats = train_sisr.main(["-p", cfg_path])
        seconds = time.perf_counter() - t0
        launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
        out = os.path.join(root, f"{name}_eval")
        t0 = time.perf_counter()
        eval_sisr.main(["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "--lr_dir",
                        eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM",
                        "-me", f"{name}_x4", "last", "--out_loc", out])
        cli_seconds = time.perf_counter() - t0
        columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
        no_rcab(f"the {name} runs", launches, {"eval": rcab.launches})
        if (len(values) != images or (f"{name}_x4", "PSNR") not in columns
                or len(forwards) != VALIDATION_FORWARDS
                or not np.isfinite(sum(values.values(), [stats[0]["train-loss"],
                                                         stats[0]["val-PSNR"]])).all()):
            raise AssertionError(f"{name} through the CLIs: stats {stats}, columns {columns}, "
                                 f"{len(values)} rows, {len(forwards)} validation forwards")

        handler = get_model(name)(device="cuda", seed=9, lr=1e-4, scale=TRAIN_SCALE)
        state = handler.init_state()
        # each step's global gradient norm before and after the clip
        # (VDSR's 0.1; SRCNN has none)
        norms, clip = [], base.clip_by_global_norm

        def clip_recorded(grads, max_norm):
            grads = list(grads)
            before = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clip(grads, max_norm)
            norms.append((before, torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))))

        base.clip_by_global_norm = clip_recorded
        try:
            steps_row = phase_step_row(rcab, handler, state, fixed, f"{name} x4 defaults f32",
                                       pair_loss(handler, fixed))
            unsynced = step_without_sync(handler, state, fixed)
        finally:
            base.clip_by_global_norm = clip
        no_rcab(f"a {name} step", steps_row["launches_a_step"])
        norms = [(float(b), float(a)) for b, a in norms]
        rows[name] = {"run_experiment_s": seconds, "epoch_train_loss": stats[0]["train-loss"],
                      "val_psnr": stats[0]["val-PSNR"], "eval_sisr_s": cli_seconds,
                      "eval_images_per_s": images / cli_seconds,
                      "eval_mean": dict(zip([f"{m}>{k}" for m, k in columns],
                                            np.mean(list(values.values()), axis=0).tolist())),
                      "fixed_batch": steps_row, "step_under_sync_debug_error": unsynced,
                      "clip_steps": len(norms), "grad_norm_before_after_clip": norms[:3],
                      "parameters": sum(p.numel() for p in handler.module.parameters())}
        if (name == "vdsr") != bool(norms) or any(
                abs(a - min(b, 0.1)) > 1e-6 * max(b, 1e-3) for b, a in norms):
            raise AssertionError(f"{name}: gradient norms before and after the clip {norms}")
        del handler, state
        torch.cuda.empty_cache()
    row = {"phase": "basic_train", "card": card, "batch": TRAIN_BATCH,
           "input": f"bicubic x4 of LR {TRAIN_CROP}, Y channel", **rows}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def write_regression_set(root, hr_dir, card_seed):
    """LR patches for the regressors: REGRESSION_VIEWS crops of
    TRAIN_CROP * 4 HR pixels an image, degraded in one pass on the card by
    bench.py's chain (its blur also giving the full 21 x 21 kernels) and
    saved as uint8 .npy files, with degradation_metadata.csv (image, then
    the chain's scalar keys, sorted). Returns (lr_dir, the patches, the
    metadata matrix and the kernels, on the card)."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    table = json.loads(json.dumps(BENCH_CHAIN))
    table["deg_configs"]["b"]["request_full_kernels"] = True
    pipe = ImagePipeline(table["pipeline"], deg_configs=table["deg_configs"], scale=TRAIN_SCALE)
    side = TRAIN_CROP * TRAIN_SCALE
    rng = np.random.default_rng(card_seed)
    crops, names = [], []
    for name in sorted(os.listdir(hr_dir)):
        hr = np.load(os.path.join(hr_dir, name))
        for v in range(REGRESSION_VIEWS):
            top = int(rng.integers(0, hr.shape[0] - side))
            left = int(rng.integers(0, hr.shape[1] - side))
            crops.append(hr[top:top + side, left:left + side])
            names.append(f"{os.path.splitext(name)[0]}_{v}.npy")
    hr_t = torch.from_numpy(np.stack(crops).astype(np.float32) / 255.0).cuda()
    with torch.no_grad():
        lr, meta = pipe.degrade_batch(card_generator(card_seed), hr_t)
    lr_u8 = (lr.clamp(0, 1) * 255.0).round().to(torch.uint8)
    kernel_key = next(k for k in meta if k.endswith("unmodified_blur_kernel"))
    keys = sorted(k for k in meta if k != kernel_key)
    lr_dir = os.path.join(root, "lr")
    os.makedirs(lr_dir)
    for name, img in zip(names, lr_u8.cpu().numpy()):
        np.save(os.path.join(lr_dir, name), img)
    cols = [meta[k].float().cpu().numpy() for k in keys]
    with open(os.path.join(lr_dir, "degradation_metadata.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["image"] + keys)
        for i, name in enumerate(names):
            w.writerow([name] + [repr(float(c[i])) for c in cols])
    matrix = torch.stack([meta[k].float() for k in keys], dim=1)
    return lr_dir, lr_u8.float() / 255.0, matrix, meta[kernel_key].float()


def regressor_loss(handler, batch):
    """The handler's loss on ``batch`` in train mode (the batch's BatchNorm
    statistics, as the step's loss; the running ones put back)."""
    def loss(state):
        with buffers_kept(handler.module):
            pred = without_grad(lambda: handler.apply(state.params, batch, train=True)[0])
        return float(handler.compute_losses(pred, batch, {})["train-loss"])
    return loss


def regressor_train_phase(rcab, card):
    """The direct degradation regressors at their defaults, float32: basicnn,
    resnet (resnet18 and resnet50), densenet (169), efficientnet (b3) and
    manet (kernel 21, x4, invariant kernel), each with steady steps on a
    fixed batch of LR patches (batch 16, 48 x 48) degraded on the card by
    bench.py's chain, their targets the chain's 13 metadata values (MANet's
    its 21 x 21 blur kernel), one step under sync debug "error", and its
    predictions for 4 patches on the card against the CPU; then resnet18
    through cli.train_sisr with data.task_type = "regression" on those
    patches and their metadata CSV (one epoch of 4 steps and one
    contrastive evaluation of its predictions). No RCAB kernel runs.
    Returns the row."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_regressors")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, hr_dir = write_pairs(os.path.join(root, "data"), np.random.default_rng(180))
    lr_dir, patches, matrix, kernels = write_regression_set(root, hr_dir, 181)
    outputs = matrix.shape[1]
    rows = {}
    for label, (name, kw) in REGRESSORS.items():
        kw = dict(kw, output_size=outputs) if name != "manet" else kw
        handler = get_model(name)(device="cuda", seed=10, lr=1e-4, **kw)
        state = handler.init_state()
        batch = {"lr": patches[:TRAIN_BATCH].contiguous(),
                 "metadata": (kernels if name == "manet" else matrix)[:TRAIN_BATCH].contiguous()}
        stats0 = running_stats(handler.module)
        step = phase_step_row(rcab, handler, state, dict(batch, hr=batch["lr"]),
                              f"{label} defaults f32", regressor_loss(handler, batch))
        unsynced = step_without_sync(handler, state, batch)
        stats1 = running_stats(handler.module)
        moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
        no_rcab(f"a {label} step", step["launches_a_step"])
        cpu = get_model(name)(device="cpu", **kw)
        cpu.module.load_state_dict({k: v.cpu() for k, v in handler.module.state_dict().items()})
        x = batch["lr"][:4]
        on_card = handler.run_eval(state, {"lr": x}).float().cpu()
        on_cpu = cpu.run_eval(cpu._own_state(), {"lr": x.cpu()}).float()
        rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
        del step["hr_megapixels_per_s"]  # the step reads LR patches, no HR image
        step["patches_per_s"] = TRAIN_BATCH / (step["step_ms"] / 1e3)
        rows[label] = dict(step, step_under_sync_debug_error=unsynced,
                           running_stats=len(stats0), running_stats_moved=moved,
                           predictions_shape=list(on_card.shape),
                           card_vs_cpu_rel=rel, predictions_card=on_card[0, :4].flatten()
                           .tolist() if name != "manet" else None,
                           parameters=sum(p.numel() for p in handler.module.parameters()))
        if (rel > REGRESSOR_REL or moved != len(stats0)
                or not np.isfinite(list(unsynced.values())).all()):
            raise AssertionError(f"{label}: {rows[label]}")
        del handler, state, cpu
        torch.cuda.empty_cache()

    csv_path = os.path.join(lr_dir, "degradation_metadata.csv")
    exp_root = os.path.join(root, "experiments")
    cfg = {"experiment": "resnet18_regression", "experiment_save_loc": exp_root,
           "data": {"task_type": "regression", "scale": TRAIN_SCALE, "crop": TRAIN_CROP,
                    "dataloader_threads": 4,
                    "training_sets": {"data_1": {"lr_dir": lr_dir, "metadata_file": csv_path}},
                    "eval_sets": {"data_1": {"lr_dir": lr_dir, "crop": TRAIN_CROP,
                                             "metadata_file": csv_path}}},
           "model": {"name": "resnet", "internal_params": {
               "model_type": "resnet18", "output_size": outputs, "lr": 1e-4}},
           "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 10}}
    cfg_path = os.path.join(root, "regression.toml")
    dump_toml(cfg, cfg_path)
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    seconds = time.perf_counter() - t0
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    dump = np.load(os.path.join(exp_root, "resnet18_regression", "result_outputs",
                                "encodings_epoch_0.npz"))
    cli = {"run_experiment_s": seconds, **{k: v for k, v in stats[0].items() if k != "epoch"},
           "embeddings": list(dump["embeddings"].shape), "launches": launches}
    no_rcab("the regression route", launches)
    if (dump["embeddings"].shape != (patches.shape[0], outputs)
            or not np.isfinite(dump["embeddings"]).all()
            or not np.isfinite(stats[0]["train-loss"])):
        raise AssertionError(f"resnet18 through the regression route: {cli}")
    row = {"phase": "regressor_train", "card": card, "batch": TRAIN_BATCH, "patch": TRAIN_CROP,
           "targets": outputs, "chain": "bench.py:133-143", **rows, "resnet18_cli": cli}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


# -- slice 17: DIC, the wavelet family and the FSSR family -----------------------------

DIC_CONFIG = os.path.join("examples", "train_dic_face_x4.toml")
WAVELET_CONFIG = os.path.join("examples", "train_waveletsrnet_x4.toml")
# the DIC example's widths (examples/train_dic_face_x4.toml)
DIC_FULL = dict(scale=4, num_steps=4, num_features=48, num_groups=6, hg_num_feature=256,
                hg_num_keypoints=68, num_fusion_block=7)
# parameters of the full-width networks, counted in the JAX package from
# jax.eval_shape of each flax init (the port's counts must equal them)
DIC_PARAMETERS = {4: 17269577, 8: 21803849}
WAVELET_PARAMETERS = 51353968
# CelebA-format faces: HR 128 x 128, LR 32 x 32 at x4 (the examples' LR crop
# is the whole image, so the landmarks line up), 16 an epoch, 4 to evaluate
FACE_SIDE, SLICE17_IMAGES, SLICE17_EVAL_IMAGES = 128, 16, 4


def write_landmarks(path, names, rng):
    """A landmarks pickle {image name: (68, 2) HR-pixel (x, y)}, the points
    drawn from a seed inside the face's middle 70 %."""
    marks = {n: (FACE_SIDE * (0.15 + 0.7 * rng.random((68, 2)))).astype(np.float32)
             for n in names}
    with open(path, "wb") as f:
        pickle.dump(marks, f)
    return marks


def face_set(root, rng, images):
    """A CelebA-format set of ``images`` 128 x 128 faces and their x4
    decimations: (lr_dir, hr_dir, names)."""
    lr_dir, hr_dir, _, _ = write_celeba_set(root, rng, images, images // 2,
                                            hr_shape=(FACE_SIDE, FACE_SIDE))
    return lr_dir, hr_dir, sorted(os.listdir(hr_dir))


def whole_faces(lr_dir, hr_dir, names, scale=TRAIN_SCALE, tags=False):
    """The faces ``names`` whole on the card, LR and HR (at x8 the LR is
    every 8th HR pixel), with their tags where asked."""
    hr = np.stack([np.load(os.path.join(hr_dir, n)) for n in names])
    lr = (np.stack([np.load(os.path.join(lr_dir, n)) for n in names]) if scale == TRAIN_SCALE
          else np.ascontiguousarray(hr[:, ::scale, ::scale]))
    out = {"lr": torch.from_numpy(lr.astype(np.float32) / 255.0).cuda(),
           "hr": torch.from_numpy(hr.astype(np.float32) / 255.0).cuda()}
    if tags:
        out["tags"] = list(names)
    return out


def dic_loss(handler, batch):
    """DIC's loss on a fixed batch (every step's L1 and the heatmaps' MSE
    against the landmarks its tags look up), without an update."""
    coords = torch.from_numpy(np.stack([handler._lookup_landmarks(t)
                                        for t in batch["tags"]])).cuda()

    def loss(state):
        with torch.no_grad():
            sr, aux, _ = handler.apply(state.params, batch, train=True)
            return float(handler.compute_losses(sr, dict(batch, landmarks=coords), aux)
                         ["train-loss"])
    return loss


def train_and_score(rcab, cfg, root, eval_lr, eval_hr, name):
    """``cfg`` through cli.train_sisr (validating each epoch on the eval
    faces), then cli.eval_sisr on its best epoch with PSNR and SSIM: host
    seconds, epoch losses, validation, the CSV's mean row, images/s and
    the RCAB launches of each (the phase fails on any)."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.interface import SISRInterface
    cfg_path = os.path.join(root, f"{name}.toml")
    dump_toml(cfg, cfg_path)
    exp, exp_root = cfg["experiment"], cfg["experiment_save_loc"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    with watched(SISRInterface, "net_run") as forwards:
        stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    losses = [stats[e]["train-loss"] for e in sorted(stats)]
    val = {k: [stats[e].get(k) for e in sorted(stats)] for k in ("val-PSNR", "val-SSIM")}
    epochs = cfg["training"]["num_epochs"]
    no_rcab(f"the {name} run", launches)
    if (len(losses) != epochs or len(forwards) != epochs * -(-SLICE17_EVAL_IMAGES // VAL_CHUNK)
            or not np.isfinite(losses + val["val-PSNR"] + val["val-SSIM"]).all()):
        raise AssertionError(f"{name} run: losses {losses}, validation {val}, "
                             f"{len(forwards)} validation forwards")
    out = os.path.join(root, f"{name}_eval")
    rcab.launches = 0
    t0 = time.perf_counter()
    eval_sisr.main(["--model_loc", exp_root, "--scale", str(cfg["data"]["scale"]), "--lr_dir",
                    eval_lr, "--hr_dir", eval_hr, "-m", "PSNR", "-m", "SSIM", "-me", exp, "best",
                    "--out_loc", out])
    cli_seconds = time.perf_counter() - t0
    columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
    no_rcab(f"eval_sisr of the {name} run", {"rcab_fused": rcab.launches})
    if (len(values) != SLICE17_EVAL_IMAGES or not {(exp, "PSNR"), (exp, "SSIM")} <= set(columns)
            or not np.isfinite(list(values.values())).all()):
        raise AssertionError(f"eval_sisr of the {name} run: columns {columns}, {len(values)} rows")
    return {"run_experiment_s": seconds, "peak_memory_bytes_run": peak, "launches": launches,
            "epoch_train_loss": losses, **val, "eval_sisr_s": cli_seconds,
            "eval_images_per_s": len(values) / cli_seconds,
            "eval_mean": dict(zip([f"{m}>{k}" for m, k in columns],
                                  np.mean(list(values.values()), axis=0).tolist()))}


def dic_train_phase(rcab, card):
    """The slice's main path: DIC x4 at examples/train_dic_face_x4.toml's
    widths (4 steps, 48 features, 6 groups, a 256-feature hourglass, 68
    landmarks, 7 fusion blocks; float32, batch 8, the LR crop 32 the whole
    face) through cli.train_sisr on 16 seeded CelebA-format faces with a
    seeded landmarks pickle (2 epochs of 2 steps, validating each epoch),
    cli.eval_sisr with PSNR and SSIM; steady steps on a fixed batch (its
    loss before and after, the hourglass held by its gradient gate), one
    step under sync debug "error", eval images/s; one step at x8 (LR 16,
    HR 128: the stride-2 hourglass and the 12/8/2 projections). No RCAB
    kernel runs. Returns the row."""
    from rumpy_tpu_torch.config.loader import load_config
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_dic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(170)
    lr_dir, hr_dir, names = face_set(os.path.join(root, "data"), rng, SLICE17_IMAGES)
    eval_lr, eval_hr, _ = face_set(os.path.join(root, "eval_data"), rng, SLICE17_EVAL_IMAGES)
    landmarks = os.path.join(root, "landmarks.pkl")
    write_landmarks(landmarks, names, rng)
    cfg = load_config(os.path.join(ROOT, DIC_CONFIG)).as_plain()
    internal = cfg["model"]["internal_params"]
    batch = cfg["training"]["batch_size"]
    if ({k: internal[k] for k in DIC_FULL} != DIC_FULL or batch != 8
            or cfg["data"]["crop"] * TRAIN_SCALE != FACE_SIDE):
        raise AssertionError(f"{DIC_CONFIG} is not DIC x4 at batch 8, crop 32: {internal}")
    cfg["experiment_save_loc"] = os.path.join(root, "experiments")
    cfg["data"]["training_sets"]["data_1"].update(lr_dir=lr_dir, hr_dir=hr_dir)
    cfg["data"]["eval_sets"]["data_1"].update(lr_dir=eval_lr, hr_dir=eval_hr)
    internal["landmarks_file"] = landmarks
    cfg["training"].update(num_epochs=2)
    cli = train_and_score(rcab, cfg, root, eval_lr, eval_hr, "dic")

    seed = cfg["training"].get("seed", 0)
    handler = get_model("dic")(device="cuda", seed=seed, **internal)
    state = handler.init_state()
    n_params = sum(p.numel() for p in handler.module.parameters())
    fixed = whole_faces(lr_dir, hr_dir, names[:batch], tags=True)
    hg0 = {k: v.clone() for k, v in state.params.items() if k.startswith("hg.")}
    rest0 = {k: v.clone() for k, v in state.params.items() if not k.startswith("hg.")}
    steps_row = phase_step_row(rcab, handler, state, fixed, "dic x4 48x6 hg256 f32",
                               dic_loss(handler, fixed))
    unsynced = step_without_sync(handler, state, fixed)
    no_rcab("a DIC step", steps_row["launches_a_step"])
    hg_moved = sum(not torch.equal(v, state.params[k]) for k, v in hg0.items())
    rest_moved = sum(not torch.equal(v, state.params[k]) for k, v in rest0.items())
    evals = eval_images(handler, state, eval_lr, SLICE17_EVAL_IMAGES)
    del handler, state
    torch.cuda.empty_cache()

    h8 = get_model("dic")(device="cuda", seed=seed, **dict(internal, scale=8))
    state8 = h8.init_state()
    n_params8 = sum(p.numel() for p in h8.module.parameters())
    fixed8 = whole_faces(lr_dir, hr_dir, names[:batch], scale=8, tags=True)
    x8_row = step_row(rcab, h8, state8, fixed8, "dic x8 48x6 hg256 f32", steps=1)
    no_rcab("a DIC x8 step", x8_row["launches_a_step"])
    del h8, state8
    torch.cuda.empty_cache()

    row = {"phase": "dic_train", "model": "dic x4 4 steps, 48 features, 6 groups, hourglass "
           "256, 68 landmarks, 7 fusion blocks, f32", "card": card, "parameters": n_params,
           "parameters_x8": n_params8, "batch": batch, "crop": cfg["data"]["crop"],
           "steps": 2 * SLICE17_IMAGES // batch, "cli": cli, "fixed_batch": steps_row,
           "hourglass_leaves_moved": hg_moved, "other_leaves_moved": rest_moved,
           "other_leaves": len(rest0), "step_under_sync_debug_error": unsynced, **evals,
           "x8_step": x8_row}
    print(json.dumps(row), flush=True)
    if (n_params != DIC_PARAMETERS[4] or n_params8 != DIC_PARAMETERS[8]
            or not steps_row["loss_lower_after_steps"] or hg_moved or rest_moved != len(rest0)
            or not np.isfinite(list(unsynced.values())).all()):
        raise AssertionError(f"DIC: {row}")
    shutil.rmtree(root)
    return row


def seeded_lightcnn_npz(path, seed, cin=1):
    """LightCNN weights for a grey (or ``cin``-channel) input in the npz
    layout the port reads (``Conv_<i>/kernel`` HWIO, ``Conv_<i>/bias``),
    He-scaled normal draws from a seed: pretrained weights stay gated."""
    from rumpy_tpu_torch.models.feature_extractors import LightCNNFeatures
    rng = np.random.default_rng(seed)
    out = {}
    for i, (f, k, _) in enumerate(LightCNNFeatures.SPEC):
        out[f"Conv_{i}/kernel"] = (rng.standard_normal((k, k, cin, 2 * f), dtype=np.float32)
                                   * np.float32(np.sqrt(2.0 / (k * k * cin))))
        out[f"Conv_{i}/bias"] = np.zeros(2 * f, np.float32)
        cin = f
    np.savez(path, **out)
    return path


def params_moved(module, before):
    return sum(not torch.equal(v, p) for v, p in zip(before, module.parameters()))


def wavelet_train_phase(rcab, card):
    """WaveletSRNet x4 at examples/train_waveletsrnet_x4.toml (the fixed
    64-1024 trunk, 2 residual blocks a width, wavelet_c 32; float32, batch
    16, LR crop 32) through cli.train_sisr on the seeded faces (2 epochs of
    one step, validating each) and cli.eval_sisr; steady steps on a fixed
    batch (its loss before and after; every BatchNorm statistic moved), one
    step under sync debug "error", eval images/s; then WaveletSRGAN with
    training_switch 1 and a seeded LightCNN npz: steps of epoch 0 (the
    bands' MSE, the discriminator still) and epoch 1 (adversarial, with the
    identity term), one of them under sync debug "error". No RCAB kernel
    runs. Returns the row."""
    from rumpy_tpu_torch.config.loader import load_config
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_wavelet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(171)
    lr_dir, hr_dir, names = face_set(os.path.join(root, "data"), rng, SLICE17_IMAGES)
    eval_lr, eval_hr, _ = face_set(os.path.join(root, "eval_data"), rng, SLICE17_EVAL_IMAGES)
    cfg = load_config(os.path.join(ROOT, WAVELET_CONFIG)).as_plain()
    internal = cfg["model"]["internal_params"]
    batch = cfg["training"]["batch_size"]
    if internal != {"scale": 4, "num_layers_res": 2} or batch != TRAIN_BATCH \
            or cfg["data"]["crop"] * TRAIN_SCALE != FACE_SIDE:
        raise AssertionError(f"{WAVELET_CONFIG} is not WaveletSRNet x4 at batch 16: {internal}")
    cfg["experiment_save_loc"] = os.path.join(root, "experiments")
    cfg["data"]["training_sets"]["data_1"].update(lr_dir=lr_dir, hr_dir=hr_dir)
    cfg["data"]["eval_sets"]["data_1"].update(lr_dir=eval_lr, hr_dir=eval_hr)
    cfg["training"].update(num_epochs=2)
    cli = train_and_score(rcab, cfg, root, eval_lr, eval_hr, "waveletsrnet")

    seed = cfg["training"].get("seed", 0)
    handler = get_model("waveletsrnet")(device="cuda", seed=seed, **internal)
    state = handler.init_state()
    n_params = sum(p.numel() for p in handler.module.parameters())
    fixed = whole_faces(lr_dir, hr_dir, names[:batch])
    stats0 = running_stats(handler.module)
    steps_row = phase_step_row(rcab, handler, state, fixed, "waveletsrnet x4 f32",
                               pair_loss(handler, fixed))
    unsynced = step_without_sync(handler, state, fixed)
    stats1 = running_stats(handler.module)
    moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
    no_rcab("a WaveletSRNet step", steps_row["launches_a_step"])
    evals = eval_images(handler, state, eval_lr, SLICE17_EVAL_IMAGES)
    del handler, state
    torch.cuda.empty_cache()

    npz = seeded_lightcnn_npz(os.path.join(root, "lightcnn.npz"), 173)
    gan = get_model("waveletsrgan")(device="cuda", seed=seed, training_switch=1,
                                    identity_weights=npz, **internal)
    gstate = gan.init_state()
    gan_rows = {}
    for epoch, phase in enumerate(("bands", "adversarial")):
        gan.set_epoch(epoch)
        d0 = [p.clone() for p in gan.discriminator.parameters()]
        r = phase_step_row(rcab, gan, gstate, fixed, f"waveletsrgan x4 {phase}",
                           pair_loss(gan, fixed))
        r["discriminator_leaves_moved"] = params_moved(gan.discriminator, d0)
        r["step_under_sync_debug_error"] = step_without_sync(gan, gstate, fixed)
        no_rcab(f"a WaveletSRGAN {phase} step", r["launches_a_step"])
        gan_rows[phase] = r
    del gan, gstate
    torch.cuda.empty_cache()

    row = {"phase": "wavelet_train", "model": "waveletsrnet x4 num_layers_res 2, wavelet_c 32, "
           "f32", "card": card, "parameters": n_params, "batch": batch,
           "crop": cfg["data"]["crop"], "cli": cli, "fixed_batch": steps_row,
           "running_stats": len(stats0), "running_stats_moved": moved,
           "step_under_sync_debug_error": unsynced, **evals, "waveletsrgan": gan_rows}
    print(json.dumps(row), flush=True)
    d_leaves = len(list(get_model("waveletsrgan")(device="cpu", include_id_loss=False,
                                                  **internal).discriminator.parameters()))
    if (n_params != WAVELET_PARAMETERS or not steps_row["loss_lower_after_steps"]
            or moved != len(stats0) or not stats0
            or gan_rows["bands"]["discriminator_leaves_moved"]
            or gan_rows["adversarial"]["discriminator_leaves_moved"] != d_leaves
            or not np.isfinite([v for r in [unsynced] + [g["step_under_sync_debug_error"]
                                                         for g in gan_rows.values()]
                                for v in r.values()]).all()
            or not gan_rows["adversarial"]["step_under_sync_debug_error"]["id_loss"] > 0):
        raise AssertionError(f"wavelet: {row}")
    shutil.rmtree(root)
    return row


def dsgan_losses(handler, batch):
    """FSSR-DSGAN's generator terms on a fixed batch (the colour L1 against
    the input's low band, the discriminator's texture term in eval mode)
    and the discriminator's loss, in train mode with its statistics put
    back, as floats."""
    from rumpy_tpu_torch.models.fssr import low_pass

    def losses(state):
        g, d, eps = handler.module.generator, handler.discriminator, handler.eps
        x = batch["lr"].permute(0, 3, 1, 2)
        y = batch["hr"].permute(0, 3, 1, 2)
        with torch.no_grad():
            out = g(x)
            col = (low_pass(out, padding=False) - low_pass(x, padding=False)).abs().mean()
            tex = -torch.log(d(out) + eps).mean()
            with buffers_kept(d):
                d_loss = (-torch.log(d(y, train=True) + eps).mean()
                          - torch.log(1 - d(out, train=True) + eps).mean())
        return float(col), float(tex), float(d_loss)
    return losses


def fssr_train_phase(rcab, card):
    """ESRGAN-FS at the ESRGAN defaults (RRDBNet 23 x 64, gc 32; VGG-128
    discriminator, 64 features; float32) with pretrain_epochs 1 on the
    seeded faces (batch 16, LR 32, HR 128): the L1 pre-train steps (the
    fixed batch's L1 lower after them) and the adversarial steps (the
    low-pass pixel term, the high band to the discriminator), one under
    sync debug "error"; then FSSR-DSGAN at its defaults (8 residual
    blocks, scale 1) on 128-pixel faces against another set's, a seeded
    LPIPS npz: steps (both networks moving), the fixed batch's colour,
    texture and discriminator losses before and after, one step under sync
    debug "error", eval images/s. No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_fssr")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(172)
    lr_dir, hr_dir, names = face_set(os.path.join(root, "data"), rng, SLICE17_IMAGES)
    fixed = whole_faces(lr_dir, hr_dir, names[:TRAIN_BATCH])
    seed = 17
    esr = get_model("esrganfs")(device="cuda", seed=seed, pretrain_epochs=1)
    estate = esr.init_state()
    n_params = sum(p.numel() for p in esr.module.generator.parameters())
    esr_rows = gan_phase_rows(rcab, esr, estate, fixed, "esrganfs x4 23x64 f32", fixed,
                              epochs=(0, 1))
    esr_unsynced = step_without_sync(esr, estate, fixed)
    del esr, estate
    torch.cuda.empty_cache()

    lpips = seeded_lpips_npz(os.path.join(root, "lpips.npz"), 174)
    dsgan = get_model("fssrdsgan")(device="cuda", seed=seed, lpips_weights=lpips)
    dstate = dsgan.init_state()
    target = fixed["hr"][torch.arange(TRAIN_BATCH - 1, -1, -1, device="cuda")]
    dbatch = {"lr": fixed["hr"], "hr": target}  # the clean faces to another set's domain
    losses_of = dsgan_losses(dsgan, dbatch)
    before = losses_of(dstate)
    g0 = [p.clone() for p in dsgan.module.generator.parameters()]
    d0 = [p.clone() for p in dsgan.discriminator.parameters()]
    ds_row = phase_step_row(rcab, dsgan, dstate, dbatch, "fssrdsgan 8 blocks 128 px f32",
                            lambda st: losses_of(st)[0])  # the colour L1
    ds_row.update(fixed_batch_color_texture_d_loss=[before, losses_of(dstate)],
                  generator_leaves_moved=params_moved(dsgan.module.generator, g0),
                  discriminator_leaves_moved=params_moved(dsgan.discriminator, d0),
                  lr_factor=dsgan._lr_factor())
    ds_unsynced = step_without_sync(dsgan, dstate, dbatch)
    no_rcab("an FSSR-DSGAN step", ds_row["launches_a_step"])
    n_eval = min(8, fixed["hr"].shape[0])
    dsgan.run_eval(dstate, {"lr": fixed["hr"][:1]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [dsgan.run_eval(dstate, {"lr": fixed["hr"][i:i + 1]}) for i in range(n_eval)]
    torch.cuda.synchronize()
    ds_row["eval_images_per_s"] = n_eval / (time.perf_counter() - t0)
    finite = all(bool(torch.isfinite(o).all()) and o.shape == (1, FACE_SIDE, FACE_SIDE, 3)
                 for o in outs)
    row = {"phase": "fssr_train", "card": card, "batch": TRAIN_BATCH,
           "esrganfs": {"model": "esrganfs x4 RRDBNet 23x64 gc 32, VGG-128 64, f32",
                        "generator_parameters": n_params, **esr_rows,
                        "step_under_sync_debug_error": esr_unsynced},
           "fssrdsgan": dict(ds_row, step_under_sync_debug_error=ds_unsynced)}
    print(json.dumps(row), flush=True)
    n_g, n_d = len(g0), len(d0)
    if (not finite or ds_row["generator_leaves_moved"] != n_g
            or ds_row["discriminator_leaves_moved"] != n_d
            or not np.isfinite([v for r in (esr_unsynced, ds_unsynced) for v in r.values()]
                               + list(before) + list(losses_of(dstate))).all()
            or not ds_unsynced["perceptual-loss"] > 0):
        raise AssertionError(f"fssr: {row}")
    shutil.rmtree(root)
    return row


# ---------------------------------------------------------------------------
# Slice 19: the tools (offline degradation, BiSeNet parsing, FR evaluation)
# ---------------------------------------------------------------------------

DIV2K_HR = (1356, 2040)  # a DIV2K HR image: 2040 wide; x4 gives 339 x 510
OFFLINE_IMAGES, OFFLINE_MULTIPLES = 8, 2
OFFLINE_CHAIN = {
    "pipeline": [["realesrganblur", "b"], ["downsample", "d"], ["realesrgannoise", "n"],
                 ["jmcompress", "j"]],
    "deg_configs": {"b": {"kernel_range": ["iso", "aniso"], "request_kernel_metadata": True},
                    "d": {"scale": TRAIN_SCALE},
                    "n": {"gaussian_noise_sigma_range": [1, 30]},
                    "j": {"random_compression": True}},
    "output_extension": ".npy"}
CELEBA_FACE = (218, 178)  # CelebA's aligned faces
# a few hundred faces a tool run, so that the per-image work, not the
# loads, sets images/s; the FR gallery holds CelebA's 10,177 identities
SEGMENT_FACES, FR_EVAL_FACES, FR_CPU_FACES, CELEBA_IDENTITIES = 256, 200, 16, 10177


def textured_image(shape, rng):
    """A photo-like uint8 (H, W, 3) image: smooth bands under noise."""
    h, w = shape
    yy, xx = np.ogrid[:h, :w]
    base = 128.0 + 70.0 * np.sin(xx / 37.0 + rng.random() * 6) * np.cos(yy / 29.0)
    noise = 14.0 * rng.standard_normal((h, w, 3), dtype=np.float32)
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)


def host_draw_checks(op_card, op_cpu, img, kind):
    """An op's host call on the card and on the CPU with the same draws,
    made by a CPU generator: uint8 images within 1 level on <= 0.5 % of
    pixels, metadata within 1e-5. Returns the worst figures."""
    from rumpy_tpu_torch.degradations.noise import NoiseDraws
    from rumpy_tpu_torch.ops import blur_kernels as bk
    from rumpy_tpu_torch.ops import noise as noise_ops
    gen = torch.Generator().manual_seed(191)
    cases = []
    if kind == "blur":
        for _ in range(2):
            d = bk.draw_kernel_params(gen, 1, op_cpu.cfg)
            cases.append((d, dataclasses.replace(
                d, **{f.name: getattr(d, f.name).cuda() for f in dataclasses.fields(d)
                      if getattr(d, f.name) is not None})))
    else:
        x = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
        rounded, gray_img, vals_c, vals_g = noise_ops.poisson_rates(x)
        lo, hi = op_cpu.gaussian_noise_sigma_range
        for use_gauss in (True, False):
            d = NoiseDraws(
                use_gauss=torch.tensor([use_gauss]),
                sigma=lo + (hi - lo) * torch.rand(1, generator=gen),
                gaussian_gray=(torch.rand(1, generator=gen) < 0.4).float(),
                field=torch.randn(x.shape, generator=gen),
                scale=torch.rand(1, generator=gen),
                poisson_gray=(torch.rand(1, generator=gen) < 0.4).float(),
                sample_c=torch.poisson(rounded * vals_c, generator=gen),
                sample_g=torch.poisson(gray_img * vals_g, generator=gen))
            cases.append((d, dataclasses.replace(
                d, **{f.name: getattr(d, f.name).cuda() for f in dataclasses.fields(d)})))
    worst = {"max_level_diff": 0, "share_off": 0.0, "metadata_max_abs_err": 0.0}
    for d_cpu, d_card in cases:
        (got, got_m), (want, want_m) = op_card(img, draws=d_card), op_cpu(img, draws=d_cpu)
        diff = np.abs(got.astype(np.int64) - want)
        worst["max_level_diff"] = max(worst["max_level_diff"], int(diff.max()))
        worst["share_off"] = max(worst["share_off"], float((diff > 0).mean()))
        worst["metadata_max_abs_err"] = max(
            worst["metadata_max_abs_err"],
            max(float(np.abs(np.subtract(got_m[k], want_m[k])).max()) for k in want_m))
        if sorted(got_m) != sorted(want_m):
            raise AssertionError(f"{kind} host call metadata keys {sorted(got_m)}")
    if (worst["max_level_diff"] > 1 or worst["share_off"] > 5e-3
            or worst["metadata_max_abs_err"] > 1e-5):
        raise AssertionError(f"{kind} host call, card against the CPU: {worst}")
    return worst


def offline_degrade_phase(rcab, card):
    """Offline degradation through cli.image_manipulate on the card: 8
    seeded DIV2K-sized HR images (.npy, 1356 x 2040), 2 degraded copies
    each, through realesrganblur (iso/aniso), downsample x4 (jm: an even LR
    size), realesrgannoise (sigma 1-30) and jmcompress at a random qpi on the
    native H.264 codec (built from native/rumpy_native.cpp with g++):
    images/s, each op's ms on one image, the outputs and CSV rows checked;
    the blur's and the noise's host calls on the card held against the same
    calls on the CPU with the same draws. No RCAB kernel runs. Returns the
    row."""
    from rumpy_tpu_torch import native
    from rumpy_tpu_torch.cli import image_manipulate
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_offline")
    shutil.rmtree(root, ignore_errors=True)
    src, out = os.path.join(root, "hr"), os.path.join(root, "lr")
    os.makedirs(src)
    rng = np.random.default_rng(190)
    images = [textured_image(DIV2K_HR, rng) for _ in range(OFFLINE_IMAGES)]
    for k, img in enumerate(images):
        np.save(os.path.join(src, f"{k + 1:04d}.npy"), img)
    cfg_path = os.path.join(root, "chain.toml")
    dump_toml(OFFLINE_CHAIN, cfg_path)
    t0 = time.perf_counter()
    native._load()
    build_s = time.perf_counter() - t0

    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    image_manipulate.main(["-p", cfg_path, "-s", src, "-o", out, "--seed", "19",
                           "--multiples", str(OFFLINE_MULTIPLES)])
    seconds = time.perf_counter() - t0
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    no_rcab("offline_degrade", launches)
    names = sorted(n for n in os.listdir(out) if n.endswith(".npy"))
    lr_shape = ((DIV2K_HR[0] // TRAIN_SCALE // 2) * 2, (DIV2K_HR[1] // TRAIN_SCALE // 2) * 2, 3)
    outs = [np.load(os.path.join(out, n)) for n in names]
    with open(os.path.join(out, "degradation_metadata.csv"), newline="") as f:
        rows = list(csv.reader(f))
    n_out = OFFLINE_IMAGES * OFFLINE_MULTIPLES
    if (len(names) != n_out or any(o.shape != lr_shape or o.dtype != np.uint8 for o in outs)
            or len(rows) != n_out + 1 or rows[0][0] != "image"
            or not {"3-jmcompress-qpi", "0-realesrganblur-sigma_x"} <= set(rows[0])
            or np.array_equal(outs[0], outs[1])):
        raise AssertionError(f"image_manipulate wrote {len(names)} images "
                             f"{set(o.shape for o in outs)}, {len(rows)} CSV rows {rows[0]}")

    # each op's host call on one image, the chain's own ops on the card
    pipe = ImagePipeline(OFFLINE_CHAIN["pipeline"], deg_configs=OFFLINE_CHAIN["deg_configs"],
                         seed=19, device="cuda")
    for op in pipe.pipeline.values():
        op.bind_host("cuda", pipe.rng)
    op_ms, flux = {}, images[0]
    for (step, name), op in pipe.pipeline.items():
        op(flux)  # warm: kernels, matrices and generators
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            nxt, _ = op(flux)
            times.append((time.perf_counter() - t1) * 1e3)
        op_ms[f"{step}-{name}"] = {"ms": float(np.median(times)), "input": list(flux.shape)}
        flux = nxt

    # the card against the CPU with the same draws
    cpu_pipe = ImagePipeline(OFFLINE_CHAIN["pipeline"], deg_configs=OFFLINE_CHAIN["deg_configs"])
    for op in cpu_pipe.pipeline.values():
        op.bind_host("cpu")
    card_ops, cpu_ops = list(pipe.pipeline.values()), list(cpu_pipe.pipeline.values())
    checks = {"blur_hr": host_draw_checks(card_ops[0], cpu_ops[0], images[1], "blur"),
              "noise_lr": host_draw_checks(card_ops[2], cpu_ops[2], outs[0], "noise")}
    row = {"phase": "offline_degrade", "card": card, "images": OFFLINE_IMAGES,
           "multiples": OFFLINE_MULTIPLES, "hr_shape": list(DIV2K_HR), "lr_shape": list(lr_shape),
           "chain": [p[0] for p in OFFLINE_CHAIN["pipeline"]], "native_build_s": build_s,
           "image_manipulate_s": seconds, "degraded_images_per_s": n_out / seconds,
           "op_ms": op_ms, "card_against_cpu": checks, "launches": launches}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row


def seeded_bisenet_npz(path, seed):
    """BiSeNet weights in the flax-layout npz the port reads, from a seed:
    He-scaled kernels, BatchNorm scales and variances in [0.5, 1.5], small
    biases and means (pretrained weights stay gated)."""
    from rumpy_tpu_torch.utils.face_segmentation import BiSeNet
    rng = np.random.default_rng(seed)
    flat = {}
    for name, t in BiSeNet().state_dict().items():
        *path_, last = name.split(".")
        base = "/".join(path_)
        if last == "num_batches_tracked":
            continue
        if last == "weight" and t.dim() == 4:
            o, i, kh, kw = t.shape
            flat[f"params/{base}/kernel"] = (rng.standard_normal((kh, kw, i, o), dtype=np.float32)
                                             * np.float32(np.sqrt(2.0 / (kh * kw * i))))
        elif last == "weight":
            flat[f"params/{base}/scale"] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        elif last == "bias":
            flat[f"params/{base}/bias"] = (0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        elif last == "running_mean":
            flat[f"batch_stats/{base}/mean"] = (0.1 * rng.standard_normal(t.shape)).astype(
                np.float32)
        else:
            flat[f"batch_stats/{base}/var"] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
    np.savez(path, **flat)
    return path


def face_segment_phase(rcab, card):
    """BiSeNet face parsing through cli.face_cli face_segment on the card at
    seeded npz weights: SEGMENT_FACES CelebA-sized faces (.npy, 218 x 178),
    parsed at 512 x 512 and written back at their size with the superimposed
    blends; the CLI's set-up (the segmenter's construction: npz load, upload)
    apart from its images/s over the loop, the parse's ms an image
    (Pillow-exact bilinear to 512, normalisation, ResNet-18 BiSeNet, argmax),
    and the class maps held against a CPU run (>= 99.9 % of pixels agree).
    No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.cli import face_cli
    from rumpy_tpu_torch.utils import face_segmentation
    from rumpy_tpu_torch.utils.face_segmentation import BiSeNetSegmenter

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_face_segment")
    shutil.rmtree(root, ignore_errors=True)
    src, out = os.path.join(root, "faces"), os.path.join(root, "parsed")
    os.makedirs(src)
    rng = np.random.default_rng(192)
    faces = [textured_image(CELEBA_FACE, rng) for _ in range(SEGMENT_FACES)]
    for k, face in enumerate(faces):
        np.save(os.path.join(src, f"{k + 1:06d}.npy"), face)
    weights = seeded_bisenet_npz(os.path.join(root, "bisenet.npz"), 193)

    rcab.launches = rcab.backward_launches = 0
    with watched(face_segmentation, "BiSeNetSegmenter") as setup_s:
        t0 = time.perf_counter()
        count = face_cli.face_segment(["-i", src, "-o", out, "--weights", weights,
                                       "--save_superimposed_images"])
        seconds = time.perf_counter() - t0
    loop_s = seconds - sum(setup_s)
    launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    no_rcab("face_segment", launches)
    written = sorted(os.listdir(out))
    if count != SEGMENT_FACES or len(written) != 2 * SEGMENT_FACES or any(
            np.load(os.path.join(out, n)).shape != (*CELEBA_FACE, 3) for n in written):
        raise AssertionError(f"face_segment wrote {written}")

    seg = BiSeNetSegmenter(weights)
    x = torch.from_numpy(faces[0]).cuda()
    parse_ms = cuda_ms(lambda: seg.parse_tensor(x), iters=10)
    cpu = BiSeNetSegmenter(weights, device="cpu")
    agree, classes = [], []
    for face in faces[:2]:
        got, want = seg.parse(face), cpu.parse(face)
        agree.append(float((got == want).mean()))
        classes.append(int(np.unique(want).size))
    row = {"phase": "face_segment", "card": card, "faces": SEGMENT_FACES,
           "face_shape": list(CELEBA_FACE), "parse_side": 512, "cli_s": seconds,
           "cli_setup_s": sum(setup_s), "cli_loop_s": loop_s,
           "cli_images_per_s": SEGMENT_FACES / loop_s, "parse_ms_an_image": parse_ms,
           "class_map_agreement_with_cpu": agree, "classes_in_map": classes,
           "launches": launches}
    print(json.dumps(row), flush=True)
    if min(agree) < 0.999:
        raise AssertionError(f"face_segment class maps against the CPU: {row}")
    shutil.rmtree(root)
    return row


def fr_eval_phase(rcab, card):
    """Face recognition in evaluation at the scale users run it: SPARNet (the
    face group's model without RCAB; its defaults, float32) trained through
    cli.train_sisr for one epoch on seeded 128 x 128 faces, then
    cli.eval_sisr with -m FR_rank over FR_EVAL_FACES probe faces against a
    features gallery of CelebA's 10,177 identities (LightCNN at seeded
    weights over the probes' HR, and random card images for the rest) on
    the card. The run's set-up (model, extractor and gallery loads), its
    per-image loop (forwards, metrics, extraction and each output's rank)
    and the CMC/ROC report are timed apart, the loop by part (the model's
    forward, each extraction with its read-back, each rank); the FR_rank
    column of the first FR_CPU_FACES probes is held equal to a CPU run of
    the same command over them (a probe's rank depends on it and the
    gallery alone). No RCAB kernel runs. Returns the row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.evaluation.eval_hub import EvalHub
    from rumpy_tpu_torch.models.feature_extractors import perceptual_loss_mechanism
    from rumpy_tpu_torch.utils.face_recognition import FaceRecognizer

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_fr")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(194)
    lr_dir, hr_dir, _ = face_set(os.path.join(root, "data"), rng, SLICE17_IMAGES)
    eval_lr, eval_hr, names = face_set(os.path.join(root, "eval_data"), rng, FR_EVAL_FACES)
    cpu_lr, cpu_hr = os.path.join(root, "cpu_data", "lr"), os.path.join(root, "cpu_data", "hr")
    for src, dst in ((eval_lr, cpu_lr), (eval_hr, cpu_hr)):
        os.makedirs(dst)
        for n in names[:FR_CPU_FACES]:
            shutil.copy(os.path.join(src, n), dst)
    exp_root = os.path.join(root, "experiments")
    cfg = {"experiment": "sparnet_faces", "experiment_save_loc": exp_root,
           "data": {"scale": TRAIN_SCALE, "crop": SPARNET_SIDE, "dataloader_threads": 4,
                    "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir}}},
           "model": {"name": "sparnet", "internal_params": {"lr": 1e-4}},
           "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 6}}
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    rcab.launches = rcab.backward_launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    train_s = time.perf_counter() - t0
    train_launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    no_rcab("fr_eval's SPARNet run", train_launches)

    weights = seeded_lightcnn_npz(os.path.join(root, "lightcnn.npz"), 195, cin=3)
    extractor = perceptual_loss_mechanism("lightcnn", weights=weights)
    hr = np.stack([np.load(os.path.join(eval_hr, n)) for n in names])
    others = CELEBA_IDENTITIES - FR_EVAL_FACES
    gen = card_generator(196)
    t0 = time.perf_counter()
    with torch.no_grad():
        feats = [extractor(torch.from_numpy(hr.astype(np.float32) / 255.0).cuda())]
        for k in range(0, others, 512):
            faces = torch.rand((min(512, others - k), FACE_SIDE, FACE_SIDE, 3),
                               generator=gen, device="cuda")
            feats.append(extractor(faces))
        feats = torch.cat(feats).cpu().numpy()
    gallery_s = time.perf_counter() - t0
    gallery = os.path.join(root, "gallery.npz")
    np.savez(gallery, out_stack=feats,
             id_stack=np.array([os.path.splitext(n)[0] for n in names]
                               + [f"other{k}" for k in range(others)]))

    flags = ["--model_loc", exp_root, "--scale", str(TRAIN_SCALE), "-me", "sparnet_faces",
             "last", "-m", "PSNR", "-m", "FR_rank", "--fr_gallery", gallery,
             "--fr_extractor", "lightcnn", "--fr_extractor_weights", weights]
    rcab.launches = 0
    with watched(EvalHub, "full_image_protocol") as protocol_s, \
            watched(EvalHub, "face_recognition_calculations") as report_s, \
            watched(FaceRecognizer, "fr_rank") as rank_s, \
            watched(FaceRecognizer, "_extract") as extract_s, \
            watched(EvalHub, "_model_output") as model_s:
        t0 = time.perf_counter()
        eval_sisr.main(flags + ["--lr_dir", eval_lr, "--hr_dir", eval_hr,
                                "--out_loc", os.path.join(root, "card")])
        eval_s = time.perf_counter() - t0
    eval_launches = {"rcab_fused": rcab.launches}
    no_rcab("fr_eval's eval_sisr", eval_launches)
    loop_s = sum(protocol_s) - sum(report_s)
    eval_sisr.main(flags + ["--lr_dir", cpu_lr, "--hr_dir", cpu_hr,
                            "--out_loc", os.path.join(root, "cpu"), "--device", "cpu"])
    columns, card_vals = read_metrics_csv(os.path.join(root, "card", "individual_metrics.csv"))
    _, cpu_vals = read_metrics_csv(os.path.join(root, "cpu", "individual_metrics.csv"))
    fr_cols = [i for i, (_, m) in enumerate(columns) if m == "FR_rank"]
    card_ranks = {img: [v[i] for i in fr_cols] for img, v in card_vals.items()}
    cpu_ranks = {img: [v[i] for i in fr_cols] for img, v in cpu_vals.items()}
    with open(os.path.join(root, "card", "fr_metrics", "extra_fr_metrics.csv"), newline="") as f:
        extra = list(csv.reader(f))
    with open(os.path.join(root, "card", "fr_metrics", "cmc_fr_metrics.csv"), newline="") as f:
        cmc_rows = sum(1 for _ in f) - 1
    rank_values = [r for v in card_ranks.values() for r in v]
    row = {"phase": "fr_eval", "card": card, "model": "sparnet 128 f32, 1 epoch",
           "train_loss": stats[0]["train-loss"], "train_s": train_s,
           "eval_faces": FR_EVAL_FACES, "gallery_identities": len(feats),
           "gallery_features_s": gallery_s, "eval_sisr_s": eval_s,
           "eval_setup_s": eval_s - sum(protocol_s), "eval_loop_s": loop_s,
           "eval_images_per_s": FR_EVAL_FACES / loop_s,
           "fr_rank_calls": len(rank_s), "fr_rank_s": sum(rank_s),
           "extract_s": sum(extract_s), "model_output_s": sum(model_s),
           "fr_report_s": sum(report_s), "cmc_rows": cmc_rows,
           "fr_columns": [columns[i] for i in fr_cols],
           "ranks_first": {img: card_ranks[img] for img in sorted(card_ranks)[:FR_CPU_FACES]},
           "mean_rank": [float(np.mean([v[j] for v in card_ranks.values()]))
                         for j in range(len(fr_cols))],
           "cpu_faces": len(cpu_ranks),
           "ranks_equal_cpu": all(card_ranks.get(img) == r for img, r in cpu_ranks.items()),
           "extra_fr_metrics": extra,
           "launches": {"training": train_launches, "eval": eval_launches}}
    print(json.dumps(row), flush=True)
    if (len(card_vals) != FR_EVAL_FACES or len(fr_cols) != 2 or len(cpu_ranks) != FR_CPU_FACES
            or not row["ranks_equal_cpu"] or not np.isfinite(stats[0]["train-loss"])
            or cmc_rows != CELEBA_IDENTITIES or len(rank_s) != 2 * FR_EVAL_FACES
            or not all(1 <= r <= len(feats) for r in rank_values)):
        raise AssertionError(f"fr_eval: {row}")
    shutil.rmtree(root)
    return row


# ---------------------------------------------------------------------------
# Slice 20: the attribute-conditioned face GANs
# ---------------------------------------------------------------------------

# n_feats at the JAX handlers' defaults (FaceSR-Attributes-GAN and AGA-GAN
# 32, FMFNet 64), float32 (their default dtype), the 40 CelebA attributes
ATTRIBUTE_GANS = {"facesrattributesgan": 32, "agagan": 32, "fmfnet": 64}
ATTRIBUTE_SCALE = 8  # 16 x 16 faces to 128 x 128: the networks fix the LR side
ATTRIBUTE_IMAGES, ATTRIBUTE_EVAL_IMAGES, ATTRIBUTE_CPU_IMAGES = 32, 4, 2
# the card's eval output against the CPU's, same weights and batch, relative
# to the largest output: float32 convs (TF32 off) summed in other orders
# through up to 150 layers
ATTRIBUTE_EVAL_REL = 1e-3


def gan_phase_ms(handler, state, batch, steps=2):
    """Device ms of an adversarial step's generator phase (to the end of its
    update) and discriminator phase (from there to the end of its update),
    by CUDA events recorded around ``handler._update``; the mean of
    ``steps`` steps after one warm-up."""
    marks = []
    real = handler._update

    def update(name, loss):
        real(name, loss)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    handler.train_batch(state, batch)
    handler._update = update
    try:
        starts = []
        for _ in range(steps):
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
            handler.train_batch(state, batch)
    finally:
        del handler._update
    torch.cuda.synchronize()
    return {"generator_ms": float(np.mean([s.elapsed_time(marks[2 * i])
                                           for i, s in enumerate(starts)])),
            "discriminator_ms": float(np.mean([marks[2 * i].elapsed_time(marks[2 * i + 1])
                                               for i in range(steps)]))}


def attribute_gan_train_phase(rcab, card):
    """The slice's main path: FaceSR-Attributes-GAN (nf 32), AGA-GAN (nf 32)
    and FMFNet (nf 64) at x8, float32, on the 40 CelebA attributes
    (metadata ["all"]), each through cli.train_sisr on a seeded CelebA-format
    set of 32 faces (HR 128, LR 16; one epoch of two adversarial steps at
    batch 16, pretrain_epochs 0) and cli.eval_sisr on 4 other faces with the
    attributes given by the eval config; then steady steps at batch 16 (step
    ms, the generator's and the discriminator's phase ms, busy ms, idle
    share, kernels, peak memory), the discriminator's train-mode and
    eval-mode calls a step (2 and 2), FaceSR's generator statistics moved,
    a step under sync debug "error", and the card's eval output against a
    CPU run of the same weights on 2 faces. No RCAB kernel runs. Returns the
    row."""
    from rumpy_tpu_torch.cli import eval_sisr, train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.registry import get_model

    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_attribute_gans")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(200)
    side = (FACE_SIDE, FACE_SIDE)
    lr_dir, hr_dir, attrs, _ = write_celeba_set(os.path.join(root, "data"), rng,
                                                ATTRIBUTE_IMAGES, ATTRIBUTE_IMAGES // 2,
                                                hr_shape=side, scale=ATTRIBUTE_SCALE)
    e_lr, e_hr, e_attrs, _ = write_celeba_set(os.path.join(root, "eval_data"), rng,
                                              ATTRIBUTE_EVAL_IMAGES, 2, hr_shape=side,
                                              scale=ATTRIBUTE_SCALE)
    eval_cfg = os.path.join(root, "eval.toml")
    dump_toml({"data": {"lr_dir": e_lr, "hr_dir": e_hr, "attributes_loc": e_attrs,
                        "data_attributes": "all"}}, eval_cfg)
    names = sorted(os.listdir(hr_dir))[:TRAIN_BATCH]
    fixed = whole_faces(lr_dir, hr_dir, names, scale=ATTRIBUTE_SCALE)
    table = np.loadtxt(attrs, skiprows=2, usecols=range(1, 41))
    fixed["metadata"] = torch.from_numpy((table[:TRAIN_BATCH] > 0).astype(np.float32)).cuda()
    exp_root = os.path.join(root, "experiments")
    rows = {}
    for name, nf in ATTRIBUTE_GANS.items():
        internal = {"metadata": ["all"], "n_feats": nf, "pretrain_epochs": 0}
        exp = f"{name}_celeba_x8"
        cfg = {"experiment": exp, "experiment_save_loc": exp_root,
               "data": {"scale": ATTRIBUTE_SCALE, "dataloader_threads": 4, "metadata": ["all"],
                        "training_sets": {"data_1": {"lr_dir": lr_dir, "hr_dir": hr_dir,
                                                     "attributes_loc": attrs}}},
               "model": {"name": name, "internal_params": internal},
               "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": 20}}
        cfg_path = os.path.join(root, f"{name}.toml")
        dump_toml(cfg, cfg_path)
        rcab.launches = rcab.backward_launches = 0
        t0 = time.perf_counter()
        stats = train_sisr.main(["-p", cfg_path])
        run_s = time.perf_counter() - t0
        launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
        out = os.path.join(root, f"{name}_eval")
        rcab.launches = 0
        t0 = time.perf_counter()
        eval_sisr.main(["-c", eval_cfg, "--model_loc", exp_root, "--scale",
                        str(ATTRIBUTE_SCALE), "-m", "PSNR", "-m", "SSIM", "-me", exp, "last",
                        "--out_loc", out])
        eval_s = time.perf_counter() - t0
        eval_launches = {"rcab_fused": rcab.launches}
        no_rcab(f"the {name} run", launches, eval_launches)
        columns, values = read_metrics_csv(os.path.join(out, "individual_metrics.csv"))
        cli = {"run_experiment_s": run_s,
               **{k: stats[0][k] for k in ("train-loss", "l1-loss", "gan-loss", "d-loss-real",
                                           "d-loss-fake")},
               "eval_sisr_s": eval_s, "eval_images_per_s": len(values) / eval_s,
               "eval_mean": dict(zip([f"{m}>{k}" for m, k in columns],
                                     np.mean(list(values.values()), axis=0).tolist())),
               "launches": launches, "eval_launches": eval_launches}
        if (len(stats) != 1 or not np.isfinite([cli[k] for k in ("train-loss", "d-loss-real",
                                                                  "d-loss-fake")]).all()
                or not cli["gan-loss"] > 0 or len(values) != ATTRIBUTE_EVAL_IMAGES
                or (exp, "PSNR") not in columns or not np.isfinite(list(values.values())).all()):
            raise AssertionError(f"{name} through the CLIs: {cli}, columns {columns}")

        handler = get_model(name)(device="cuda", seed=20, **internal)
        state = handler.init_state()
        n_params = sum(p.numel() for p in handler.module.parameters())
        stats0 = running_stats(handler.module.generator)
        step = step_row(rcab, handler, state, fixed, f"{name} nf {nf} f32")
        no_rcab(f"a {name} step", step["launches_a_step"])
        by_phase = gan_phase_ms(handler, state, fixed)
        calls = []
        hook = handler.discriminator.register_forward_pre_hook(
            lambda m, a, kw: calls.append(bool(kw.get("train"))), with_kwargs=True)
        try:
            trace = traced(lambda: handler.train_batch(state, fixed), f"{name}_step_trace", 1)
        finally:
            hook.remove()
        unsynced = step_without_sync(handler, state, fixed)
        stats1 = running_stats(handler.module.generator)
        moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
        probe = {"lr": fixed["lr"][:ATTRIBUTE_CPU_IMAGES],
                 "metadata": fixed["metadata"][:ATTRIBUTE_CPU_IMAGES]}
        card_out = handler.run_eval(state, probe).cpu()
        cpu = get_model(name)(device="cpu", seed=20, **internal)
        cpu.module.load_state_dict({k: v.cpu() for k, v in state.params.items()})
        cpu_out = cpu.run_eval(cpu._own_state(), {k: v.cpu() for k, v in probe.items()})
        eval_err = float((card_out - cpu_out).abs().max() / cpu_out.abs().max())
        rows[name] = {
            "model": f"{name} nf {nf} x8 f32, 40 attributes", "parameters": n_params,
            "cli": cli, "fixed_batch": step, **by_phase, "step_busy_ms": trace["busy_us"] / 1e3,
            "step_idle_share": trace["idle_share"], "kernels_a_step": trace["kernels_per_call"],
            "peak_gb_a_step": step["peak_memory_bytes"] / 1e9,
            "d_train_calls_a_step": sum(calls), "d_eval_calls_a_step": len(calls) - sum(calls),
            "generator_stats": len(stats0), "generator_stats_moved": moved,
            "step_under_sync_debug_error": unsynced,
            "eval_card_vs_cpu_rel_err": eval_err, "eval_card_vs_cpu_images": len(cpu_out)}
        if (rows[name]["d_train_calls_a_step"] != 2 or rows[name]["d_eval_calls_a_step"] != 2
                or moved != len(stats0) or (name == "facesrattributesgan") != bool(stats0)
                or not np.isfinite(list(unsynced.values())).all()
                or not eval_err <= ATTRIBUTE_EVAL_REL
                or tuple(card_out.shape) != (ATTRIBUTE_CPU_IMAGES, FACE_SIDE, FACE_SIDE, 3)):
            raise AssertionError(f"{name}: {rows[name]}")
        del handler, state, cpu
        torch.cuda.empty_cache()
    row = {"phase": "attribute_gan_train", "card": card, "batch": TRAIN_BATCH,
           "lr_side": FACE_SIDE // ATTRIBUTE_SCALE, "hr_side": FACE_SIDE, "num_metadata": 40,
           "eval_rel_tolerance": ATTRIBUTE_EVAL_REL, **rows}
    print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    return row

# trainer_resume: run A takes RESUME_STEPS steps (three times, for the
# run-to-run floor), run B one step fewer, then B's state goes out as the
# JAX package's trees and back into a fresh handler for the last step;
# the trainer then runs TRAINER_STEPS steps with the first PROFILED_STEPS
# traced.
RESUME_STEPS, RESUME_REPEATS, RESUME_SEED = 3, 3, 21
TRAINER_STEPS, PROFILED_STEPS, TRAINER_HR = 6, 2, 256
AIM_MESSAGE = "aim not installed; experiment tracking disabled"


def exported_run(handler, state):
    """``handler``'s weights and optimizer state as the dict that the port's
    flax-msgpack reader returns for a checkpoint the JAX package wrote."""
    from rumpy_tpu_torch.models.base import optax_state_tree
    from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
    return {"network": jax_tree_from_state_dict(handler.module.state_dict(), handler.module),
            "optimizer": optax_state_tree(handler.optimizer(), handler.module,
                                          handler.grad_clip is not None,
                                          handler.scheduler is not None, state.step),
            "extra": {}, "step": np.asarray(state.step, np.int32),
            "rng": np.zeros(2, np.uint32), "model_name": "rcan", "model_epoch": 0,
            "handler_metadata": {}}


def moment_places(handler):
    """Where the torch moments of the handler's parameters live: rows of
    (moment, device, dtype, memory format, strides equal to the
    parameter's, step's device, step's dtype, count)."""
    opt = handler.optimizer()
    rows = collections.Counter()
    for p in handler.module.parameters():
        st = opt.state[p]
        for name in ("exp_avg", "exp_avg_sq"):
            m = st[name]
            layout = ("channels_last" if p.dim() == 4
                      and m.is_contiguous(memory_format=torch.channels_last) else "contiguous")
            rows[(name, str(m.device), str(m.dtype), layout, m.stride() == p.stride(),
                  str(st["step"].device), str(st["step"].dtype))] += 1
    return [list(k) + [n] for k, n in sorted(rows.items())]


def trace_step_kernels(path):
    """The step spans, RCAB launches (one rcab_apply_kernel a forward, one
    rcab_bwd_finish_kernel a backward) and the top five kernels by summed
    device time of a trace the trainer wrote."""
    from rumpy_tpu_torch.training.trainer import STEP_SPAN
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == STEP_SPAN and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    for e in kernels:
        by_name[kernel_name(e["name"])] += e["dur"]
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), e["ts"] + e["dur"]
        busy += max(stop - start, 0.0)
        end = max(end, stop)
    return {"step_spans": len(spans),
            "span_ms": [e["dur"] / 1e3 for e in spans],
            "rcab_forward_launches": sum("rcab_apply_kernel" in e["name"] for e in kernels),
            "rcab_backward_launches": sum("rcab_bwd_finish_kernel" in e["name"]
                                          for e in kernels),
            "kernels": len(kernels), "busy_ms": busy / 1e3,
            "top5_kernels_us": [[n, t] for n, t in by_name.most_common(5)],
            "device_us_by_kernel": dict(by_name)}


def trainer_resume_phase(rcab, card):
    """The slice's main path, item 8b: full-width blind RCAN x4 bf16 with the
    example's Adam and multi_step_lr (its milestone moved to step 2, so that
    the resumed step runs at the halved lr) continues a run that the JAX
    package could have written. Run A takes 3 steps on a fixed batch of 16
    LR/HR pairs (48 x 48 LR), three times with the same seed (the
    run-to-run floor, cuDNN deterministic); run B takes 2, exports its
    weights and Adam state as the JAX package's trees, and a fresh handler
    loads them through ``_load_jax_checkpoint`` in train mode and takes
    step 3 under sync debug "error". Step 3 must land no farther from A
    than A's repeats from each other; every moment must sit on the card in
    its parameter's memory format, every ``step`` on the CPU.
    Then TrainingHandler runs the example's chain at full width for one
    epoch of 6 steps with profile_steps = 2 and logging = "aim" (aim is
    not installed): every step after the first under sync debug "error"
    (the profiler stops between steps 2 and 3), the trace's 2 step spans
    with 200 RCAB forward and 200 backward launches each, its top kernels,
    and host ms a step with and without the profiler."""
    import io

    from rumpy_tpu_torch.config.loader import dump_toml, load_config
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    from rumpy_tpu_torch.training.trainer import TrainingHandler

    t_phase = time.perf_counter()
    example = load_config(os.path.join(ROOT, EXAMPLE_CONFIG)).as_plain()
    internal = dict(example["model"]["internal_params"])
    internal["scheduler_params"] = dict(internal["scheduler_params"], milestones=[2])
    g = card_generator(RESUME_SEED)
    batch = {"lr": torch.rand(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3, device="cuda", generator=g),
             "hr": torch.rand(TRAIN_BATCH, HR_SIDE, HR_SIDE, 3, device="cuda", generator=g)}

    def run(steps):
        h = get_model("rcan")(device="cuda", seed=RESUME_SEED, **internal)
        state = h.init_state()
        losses = None
        for _ in range(steps):
            state, losses = h.train_batch(state, batch)
        return h, state, losses

    def params_of(h):
        return {k: p.detach().clone() for k, p in h.module.named_parameters()}

    def largest(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(RESUME_REPEATS):
            h, _, losses_a = run(RESUME_STEPS)
            runs.append(params_of(h))
            del h
        floor = max(largest(runs[i], runs[j]) for i in range(len(runs))
                    for j in range(i + 1, len(runs)))
        hb, state_b, _ = run(RESUME_STEPS - 1)
        t0 = time.perf_counter()
        loaded = exported_run(hb, state_b)
        export_s = time.perf_counter() - t0
        del hb, state_b
        fresh = get_model("rcan")(device="cuda", seed=RESUME_SEED + 1, **internal)
        t0 = time.perf_counter()
        state = fresh._load_jax_checkpoint(loaded, "run B as the JAX package's trees", False)
        load_s = time.perf_counter() - t0
        places = moment_places(fresh)
        n_params = len(list(fresh.module.parameters()))
        rcab.launches = rcab.backward_launches = 0
        losses_b = step_without_sync(fresh, state, batch)
        resume_launches = {"rcab_fused": rcab.launches,
                           "rcab_fused_backward": rcab.backward_launches}
        resumed = largest(params_of(fresh), runs[0])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del fresh, state, loaded, runs
    if any(r[1:3] != ["cuda:0", "torch.float32"] or not r[4] or r[5:7] != [
            "cpu", "torch.float32"] for r in places) \
            or sum(r[-1] for r in places) != 2 * n_params \
            or not any(r[3] == "channels_last" for r in places):
        raise AssertionError(f"trainer_resume: moments not where torch keeps them: {places}")
    if resumed > floor:
        raise AssertionError(f"trainer_resume: the resumed step 3 is {resumed} from run A, "
                             f"whose repeats differ by {floor}")
    if resume_launches != {"rcab_fused": 200, "rcab_fused_backward": 200}:
        raise AssertionError(f"trainer_resume: the resumed step launched {resume_launches}")
    # step 3's loss is taken before its update, from the weights after step 2
    if floor == 0 and losses_b["train-loss"] != float(losses_a["train-loss"]):
        raise AssertionError(f"trainer_resume: step-3 loss {losses_b} against A's {losses_a}")

    # (b) the trainer: profile_steps and the Aim gate at full width
    root = os.path.join(ROOT, "rumpy_tpu_torch", "build", "smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    hr_dir = os.path.join(root, "hr")
    os.makedirs(hr_dir)
    rng = np.random.default_rng(RESUME_SEED)
    for k in range(TRAIN_BATCH):
        np.save(os.path.join(hr_dir, f"im{k}.npy"),
                rng.integers(0, 256, (TRAINER_HR, TRAINER_HR, 3), dtype=np.uint8))
    cfg = {
        "experiment": "rcan_x4_blind_profiled", "experiment_save_loc": os.path.join(root, "exp"),
        "data": {"scale": TRAIN_SCALE, "crop": TRAIN_CROP, "dataloader_threads": 4,
                 "online_degradations": example["data"]["online_degradations"],
                 "training_sets": {f"data_{i}": {"hr_dir": hr_dir}
                                   for i in range(TRAINER_STEPS)}},
        "model": {"name": "rcan", "internal_params": internal},
        "training": {"num_epochs": 1, "batch_size": TRAIN_BATCH, "seed": RESUME_SEED,
                     "profile_steps": PROFILED_STEPS, "logging": "aim"},
    }
    cfg_path = os.path.join(root, "train.toml")
    dump_toml(cfg, cfg_path)
    real_step, step_s = SISRInterface.train_batch, []

    def strict_step(self, *args, **kwargs):
        # the first step uploads the chain's tables, once a process (the
        # blur families' cumulative probabilities, ...): the rest wait for
        # nothing
        if step_s:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return real_step(self, *args, **kwargs)
        finally:
            step_s.append(time.perf_counter() - t0)
            torch.cuda.set_sync_debug_mode(0)

    printed = io.StringIO()
    torch.cuda.synchronize()
    rcab.launches = rcab.backward_launches = 0
    SISRInterface.train_batch = strict_step
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            h = TrainingHandler(load_config(cfg_path), verbose=True)
            stats = h.run_experiment()
    finally:
        SISRInterface.train_batch = real_step
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trainer_launches = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches}
    print(printed.getvalue(), file=sys.stderr, flush=True)
    trace = trace_step_kernels(os.path.join(h.model.logs_dir, "profile", "train_steps.json"))
    if AIM_MESSAGE not in printed.getvalue() or h.tracker is not None:
        raise AssertionError(f"trainer_resume: no Aim message in {printed.getvalue()!r}")
    if list(stats) != [0] or not np.isfinite(stats[0]["train-loss"]) \
            or len(step_s) != TRAINER_STEPS:
        raise AssertionError(f"trainer_resume: the epoch {stats} took {len(step_s)} steps")
    if trainer_launches != {k: 200 * TRAINER_STEPS for k in trainer_launches}:
        raise AssertionError(f"trainer_resume: the epoch launched {trainer_launches}")
    if (trace["step_spans"], trace["rcab_forward_launches"], trace["rcab_backward_launches"]) \
            != (PROFILED_STEPS, 200 * PROFILED_STEPS, 200 * PROFILED_STEPS):
        raise AssertionError(f"trainer_resume: the trace holds {trace['step_spans']} step spans, "
                             f"{trace['rcab_forward_launches']} forward and "
                             f"{trace['rcab_backward_launches']} backward RCAB launches")
    row = {"phase": "trainer_resume", "model": "rcan x4 10x20x64 bf16", "card": card,
           "config": EXAMPLE_CONFIG, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "resume": {"steps": RESUME_STEPS, "a_step3_loss": float(losses_a["train-loss"]),
                      "b_step3_loss": losses_b["train-loss"],
                      "b_against_a_max_abs": resumed, "a_repeats_max_abs": floor,
                      "export_s": export_s, "load_s": load_s, "moment_places": places,
                      "launches": resume_launches},
           "trainer": {"steps": len(step_s), "profiled_steps": PROFILED_STEPS,
                       "host_ms_a_step": [1e3 * t for t in step_s],
                       "profiled_host_ms": float(np.median(step_s[:PROFILED_STEPS]) * 1e3),
                       "unprofiled_host_ms": float(np.median(step_s[PROFILED_STEPS:]) * 1e3),
                       "run_experiment_s": run_s, "train_loss": stats[0]["train-loss"],
                       "launches": trainer_launches, "aim_message": True,
                       **{k: v for k, v in trace.items() if k != "device_us_by_kernel"},
                       "device_ms_a_step_by_kernel": {
                           k: v / 1e3 / PROFILED_STEPS
                           for k, v in sorted(trace["device_us_by_kernel"].items(),
                                              key=lambda kv: -kv[1])[:12]}},
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    del h
    shutil.rmtree(root)
    return row


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
    dan = dan_train_phase(rcab, card)
    ikc_train_phase(rcab, card)
    dasr_train_phase(rcab, card)
    han = han_train_phase(rcab, card)
    qhan = bobw_qhan_phase(rcab, card)
    elan = elan_train_phase(rcab, card)
    san = san_train_phase(rcab, card)
    realesrgan = realesrgan_train_phase(rcab, card)
    qrealesrgan = bobw_qrealesrgan_phase(rcab, card)
    gan_family = gan_family_phase(rcab, card)
    metabed = metabed_phase(rcab, card)
    # the face group: the slice's main path, rcansplitceleb, on the RCAB kernels
    face_data_phase(card)
    split = rcansplit_train_phase(rcab, card)
    sparnet_train_phase(rcab, card)
    facegan_train_phase(rcab, card)
    # slice 16: SwinIR (the main path), SRCNN/VDSR and the regressors launch
    # no RCAB kernel: each phase fails on any
    swinir = swinir_train_phase(rcab, card)
    basic = basic_train_phase(rcab, card)
    regressors = regressor_train_phase(rcab, card)
    # slice 17: DIC (the main path), the wavelet family and the FSSR family
    # launch no RCAB kernel: each phase fails on any
    dic = dic_train_phase(rcab, card)
    wavelet = wavelet_train_phase(rcab, card)
    fssr = fssr_train_phase(rcab, card)
    # slice 19: the tools launch no RCAB kernel either: each phase fails on one
    offline = offline_degrade_phase(rcab, card)
    segment = face_segment_phase(rcab, card)
    fr = fr_eval_phase(rcab, card)
    print(json.dumps({"phase": "slice19_launches", "offline_degrade": offline["launches"],
                      "face_segment": segment["launches"], "fr_eval": fr["launches"]}),
          flush=True)
    # slice 20: the attribute-conditioned GANs launch no RCAB kernel: the phase
    # fails on one
    attribute = attribute_gan_train_phase(rcab, card)
    print(json.dumps({"phase": "slice20_launches", **{
        name: {"training_path": r["cli"]["launches"], "eval_path": r["cli"]["eval_launches"],
               "a_step": r["fixed_batch"]["launches_a_step"]}
        for name, r in attribute.items() if name in ATTRIBUTE_GANS}}), flush=True)
    # slice 21, the trainer's leftovers: a JAX-written run resumed with its
    # optax state, and the trainer profiled, on the RCAB kernels
    resume = trainer_resume_phase(rcab, card)
    resume_launches = resume["resume"]["launches"]
    profiled_launches = resume["trainer"]["launches"]
    # the GAN group launches no RCAB kernel: each phase failed on any
    gan_group_launches = {
        "realesrgan_training_path": realesrgan["launches"],
        "realesrgan_a_step": {p: r["launches_a_step"]
                              for p, r in realesrgan["fixed_batch"].items()},
        "bobw_qrealesrgan_path": qrealesrgan["launches"],
        "gan_family_a_step": {n: {p: r["launches_a_step"] for p, r in rows.items()}
                              for n, rows in gan_family["steps"].items()},
        "metabed_a_step": {n: {"rcab_fused": 0, "rcab_fused_backward": 0}
                           for n in metabed["meta_types"]}}
    slice16_launches = {
        "swinir_training_path": swinir["launches"],
        "swinir_eval_path": swinir["eval_rcab_launches"],
        "swinir_a_step": swinir["fixed_batch"]["launches_a_step"],
        "basic_a_step": {n: basic[n]["fixed_batch"]["launches_a_step"] for n in ("srcnn", "vdsr")},
        "regressors_a_step": {n: regressors[n]["launches_a_step"] for n in REGRESSORS},
        "regression_route": regressors["resnet18_cli"]["launches"]}
    print(json.dumps({
        "phase": "slice17_launches", "dic_training_path": dic["cli"]["launches"],
        "dic_a_step": dic["fixed_batch"]["launches_a_step"],
        "dic_x8_step": dic["x8_step"]["launches_a_step"],
        "waveletsrnet_training_path": wavelet["cli"]["launches"],
        "waveletsrnet_a_step": wavelet["fixed_batch"]["launches_a_step"],
        "waveletsrgan_a_step": {p: r["launches_a_step"]
                                for p, r in wavelet["waveletsrgan"].items()},
        "esrganfs_a_step": {p: fssr["esrganfs"][p]["launches_a_step"]
                            for p in ("pretrain", "adversarial")},
        "fssrdsgan_a_step": fssr["fssrdsgan"]["launches_a_step"]}), flush=True)
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
                     + meta_row["eval_rcab_launches"] + family["launches"]
                     + dan["launches"]["rcab_fused"] + dan["eval_rcab_launches"]
                     + han["launches"]["rcab_fused"] + han["eval_rcab_launches"]
                     + qhan["launches"]["rcab_fused"] + qhan["eval_rcab_launches"]
                     + split["launches"]["rcab_fused"] + split["eval_rcab_launches"]
                     + resume_launches["rcab_fused"] + profiled_launches["rcab_fused"]),
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
        "launches_dan_training_path": dan["launches"]["rcab_fused"],
        "launches_dan_validation": dan["launches"]["rcab_fused_validation"],
        "launches_dan_eval_path": dan["eval_rcab_launches"],
        "launches_dan_a_step": dan["fixed_batch"]["launches_a_step"]["rcab_fused"],
        "launches_han_training_path": han["launches"]["rcab_fused"],
        "launches_han_validation": han["launches"]["rcab_fused_validation"],
        "launches_han_eval_path": han["eval_rcab_launches"],
        "launches_han_a_step_by_form": han["fixed_batch"]["launches_a_step_by_form"],
        # the slice's main path: contrastiveblindqhan, a per-image scale
        "launches_bobw_qhan_path": qhan["launches"]["rcab_fused"],
        "launches_bobw_qhan_validation": qhan["launches"]["rcab_fused_validation"],
        "launches_bobw_qhan_eval_path": qhan["eval_rcab_launches"],
        "launches_bobw_qhan_a_step_by_form": qhan["fixed_batch"]["launches_a_step_by_form"],
        "launches_elan_a_step": elan["fixed_batch"]["launches_a_step"]["rcab_fused"],
        "launches_san_a_step": san["fixed_batch"]["launches_a_step"]["rcab_fused"],
        "launches_gan_group": gan_group_launches,
        # the face group's main path: rcansplitceleb, two RCANs
        "launches_rcansplit_training_path": split["launches"]["rcab_fused"],
        "launches_rcansplit_validation": split["launches"]["rcab_fused_validation"],
        "launches_rcansplit_eval_path": split["eval_rcab_launches"],
        "launches_rcansplit_a_step": split["fixed_batch"]["launches_a_step"]["rcab_fused"],
        "launches_slice16": slice16_launches,
        "launches_trainer_resume_path": resume_launches["rcab_fused"],
        "launches_trainer_profiled_path": profiled_launches["rcab_fused"],
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
                     + meta_launches["rcab_fused_backward"] + family["backward_launches"]
                     + dan["launches"]["rcab_fused_backward"]
                     + han["launches"]["rcab_fused_backward"]
                     + qhan["launches"]["rcab_fused_backward"]
                     + split["launches"]["rcab_fused_backward"]
                     + resume_launches["rcab_fused_backward"]
                     + profiled_launches["rcab_fused_backward"]),
        "launches_training_path": train_launches["rcab_fused_backward"],
        "launches_blind_training_path": blind_launches["rcab_fused_backward"],
        "launches_bobw_training_path": bobw_launches["rcab_fused_backward"],
        "launches_bobw_joint_path": joint_launches["rcab_fused_backward"],
        "launches_meta_attention_training_path": meta_launches["rcab_fused_backward"],
        "launches_bobw_family_path": family["backward_launches"],
        "launches_dan_training_path": dan["launches"]["rcab_fused_backward"],
        "launches_dan_a_step": dan["fixed_batch"]["launches_a_step"]["rcab_fused_backward"],
        "launches_han_training_path": han["launches"]["rcab_fused_backward"],
        "launches_bobw_qhan_path": qhan["launches"]["rcab_fused_backward"],
        "launches_elan_a_step": elan["fixed_batch"]["launches_a_step"]["rcab_fused_backward"],
        "launches_san_a_step": san["fixed_batch"]["launches_a_step"]["rcab_fused_backward"],
        "launches_gan_group": gan_group_launches,
        "launches_rcansplit_training_path": split["launches"]["rcab_fused_backward"],
        "launches_rcansplit_a_step":
            split["fixed_batch"]["launches_a_step"]["rcab_fused_backward"],
        "launches_slice16": slice16_launches,
        "launches_trainer_resume_path": resume_launches["rcab_fused_backward"],
        "launches_trainer_profiled_path": profiled_launches["rcab_fused_backward"],
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
