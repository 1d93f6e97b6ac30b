"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rumpy_tpu_torch/csrc`` into
``rumpy_tpu_torch/build/`` (one nvcc process a source, side by side), holds
each against its plain PyTorch version at the shapes the main paths give it
and at a few others, then drives the two paths the port has, each through
the entry points a user would call, at full width (RCAN x4, 10 groups x 20
RCAB, 64 features, bf16, seeded random weights):

* serving: registry -> handler -> checkpoint -> SISRInterface(eval,
  load_epoch="last") -> BatchedPredictor.predict over the Set5 shapes;
* training: ``cli.train_sisr`` -> TrainingHandler.run_experiment() on
  LR/HR ``.npy`` pairs written from a seed, patches chosen by local
  entropy, two epochs, then a serve from the checkpoint it wrote.

It checks that every RCAB forward and backward and every patch selection
went through the kernels (launch counts set to 0 before a path and read
after it), that a bf16 train step runs no backward pass on the CUDA cores,
that outputs and losses are finite, that a fixed batch's loss went down,
and that the kernel path agrees with the plain path and with the CPU.

Prints the card, then one JSON line per phase, then a ``{"kernels": ...}``
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
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
# Kernel shapes beside the serving path's: the train step's, a ragged image
# (SISRInterface pads only to size_multiple 1) and other channel counts,
# one of them (C=24) on the CUDA-core pass in bf16.
EXTRA_SHAPES = [TRAIN_SHAPE, (1, 86, 57, 64), (1, 64, 64, 32), (1, 40, 33, 128),
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

# Entropy kernel against its plain version: float32 sums of at most 64
# terms p * log2(p) in the same order, log2 from two libraries.
ENTROPY_ATOL = 1e-5
ENTROPY_SHAPES = [(339, 510), (512, 512), (37, 53)]
TRAIN_LR_SHAPE, TRAIN_SCALE = ENTROPY_SHAPES[0], 4
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


def kernel_phase(rcab):
    """Every main-path shape and the extras, f32 and bf16, res_scale 1 and
    0.5. Returns the bf16 row of the largest request's bucket (the kernels
    line's numbers) and the largest bf16 error at any shape."""
    main_shapes = main_path_shapes()
    main_shape = max(main_shapes, key=lambda s: s[1] * s[2])
    rows, main = [], None
    for i, shape in enumerate(main_shapes + EXTRA_SHAPES):
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
                    row["ms"] = cuda_ms(lambda: rcab.rcab_fused(*args), 20)
                    row["host_bound_ms"] = cuda_ms(lambda: rcab.rcab_fused(*args), 20,
                                                   backlog_s=0)
                    row["plain_ms"] = cuda_ms(lambda: rcab.rcab_reference(*args), 20)
                    row["bound_ms"], row["bound_by"] = rcab_bound_ms(shape, dtype)
                print(json.dumps({"phase": "kernel", **row}), flush=True)
                if not err <= tol:
                    raise AssertionError(f"rcab_fused disagrees with rcab_reference: {row}")
                rows.append(row)
                if shape == main_shape and dtype == torch.bfloat16 and res_scale == 1.0:
                    main = row
    return main, max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")


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


FAMILIES = ("rcab_conv_mma", "rcab_conv_kernel", "rcab_gate", "rcab_apply",
            "rcab_bwd_wgrad_mma", "rcab_bwd_dh1_mma", "rcab_bwd_dx_mma",
            "rcab_bwd_wgrad", "rcab_bwd_dh1", "rcab_bwd_dx", "rcab_bwd",
            "local_entropy")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not events:
        raise AssertionError("the profiler traced no kernel on the card")
    by_family, by_name = {}, {}
    for e in events:
        fam = next((k for k in FAMILIES if k in e["name"]), "other")
        by_family[fam] = by_family.get(fam, 0.0) + e["dur"] / repeats
        name = kernel_name(e["name"])
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / repeats
    busy = sum(e["dur"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return {"per_call_device_us": by_family,
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


def entropy_bound_ms(ent, img, region, levels):
    """Bytes over the memory rate: the image read once, the float32 map
    written once. The operations the function needs (a sliding column
    histogram: about 2 * region updates a pixel) stay far under that time.
    Beside it, what this kernel does on this image: one histogram update
    per window sample and a divide, a log2 and a multiply-add per non-empty
    bin, and its time at the f32 rate. Returns (bound ms, bound by,
    kernel's operations, their ms, bytes)."""
    hist = ent.window_histogram(img, region, levels)
    ops = float(hist.sum().item()) + 4.0 * float((hist > 0).sum().item())
    nbytes = img.numel() * (1 + 4)
    return (nbytes / PEAK_BYTES * 1e3, "bytes", ops,
            ops / PEAK_OPS[torch.float32] * 1e3, nbytes)


def entropy_phase(ent):
    """Kernel against plain version, borders included, at the train path's
    LR size, 512x512 and a ragged small image. Returns the row at the main
    path's shape and defaults (region 10, levels 64)."""
    main = None
    for i, shape in enumerate(ENTROPY_SHAPES):
        img = entropy_image(shape, seed=i)
        for region in (9, 10):
            for levels in (64, 256):
                got = ent.local_entropy(img, region, levels)
                torch.cuda.synchronize()
                ref = ent.local_entropy_reference(img, region, levels)
                err = (got - ref).abs().max().item()
                border = max((got[:region] - ref[:region]).abs().max().item(),
                             (got[:, :region] - ref[:, :region]).abs().max().item(),
                             (got[-region:] - ref[-region:]).abs().max().item(),
                             (got[:, -region:] - ref[:, -region:]).abs().max().item())
                row = {"shape": shape, "region": region, "levels": levels,
                       "max_abs_err": err, "border_max_abs_err": border,
                       "tol": ENTROPY_ATOL, "entropy_max": ref.max().item()}
                is_main = shape == TRAIN_LR_SHAPE and region == 10 and levels == 64
                if is_main or (region == 10 and levels == 64):
                    row["ms"] = cuda_ms(lambda: ent.local_entropy(img, region, levels), 50)
                    row["plain_ms"] = cuda_ms(
                        lambda: ent.local_entropy_reference(img, region, levels), 5)
                    (row["bound_ms"], row["bound_by"], row["operations"],
                     row["operations_ms"], row["bytes"]) = entropy_bound_ms(
                         ent, img, region, levels)
                print(json.dumps({"phase": "entropy_kernel", **row}), flush=True)
                if not (err <= ENTROPY_ATOL and got.shape == ref.shape):
                    raise AssertionError(f"local_entropy disagrees with its plain version: {row}")
                if is_main:
                    main = row
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
    return main


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


def l1_on(model, state, batch):
    sr = model.run_eval(state, {"lr": batch["lr"]}).float()
    return (sr - batch["hr"]).abs().mean().item()


def train_phase(rcab, ent, card):
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
    rcab.launches = rcab.backward_launches = ent.launches = 0
    t0 = time.perf_counter()
    stats = train_sisr.main(["-p", cfg_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"rcab_fused": rcab.launches, "rcab_fused_backward": rcab.backward_launches,
              "local_entropy": ent.launches}
    peak_train = torch.cuda.max_memory_allocated()
    want = {"rcab_fused": 200 * steps, "rcab_fused_backward": 200 * steps,
            "local_entropy": TRAIN_BATCH * steps}
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
    row = {"phase": "train", "model": "rcan x4 10x20x64 bf16", "card": card,
           "steps": steps, "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "launches": counts,
           "epoch_train_loss": losses,
           "compute_efficiency": [stats[e]["compute_efficiency"] for e in sorted(stats)],
           "run_experiment_s": seconds, "fixed_batch_loss_before": loss_before,
           "fixed_batch_loss_after": loss_after, "step_ms": step_ms,
           "hr_megapixels_per_s": hr_mp / (step_ms / 1e3),
           "dataset_item_ms": item_ms,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rumpy_tpu_torch.ops.cuda import build
    from rumpy_tpu_torch.ops.cuda import local_entropy as ent
    from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)

    t0 = time.perf_counter()
    build.build_all(["rcab_fused", "rcab_fused_bwd", "local_entropy"])
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "nvcc_seconds": build.build_seconds}), flush=True)

    main_row, bf16_err = kernel_phase(rcab)
    ent_row = entropy_phase(ent)
    bwd_row = rcab_bwd_phase(rcab)
    serve_launches = slice_phase(rcab, card)
    train_launches = train_phase(rcab, ent, card)

    kernels = [{
        "name": "rcab_fused", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/rcab_fused.cu",
        "replaces": "rumpy_tpu/ops/pallas/rcab_fused.py:73",
        "launches": serve_launches + train_launches["rcab_fused"],
        "launches_serving_path": serve_launches,
        "launches_training_path": train_launches["rcab_fused"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "at": [main_row["shape"], main_row["dtype"]],
    }, {
        "name": "rcab_fused_backward", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/rcab_fused_bwd.cu",
        "replaces": "rumpy_tpu/ops/pallas/rcab_fused.py:73",
        "launches": train_launches["rcab_fused_backward"],
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
        "library_ms": None, "at": [ent_row["shape"], "uint8"],
        "operations": ent_row["operations"], "operations_ms": ent_row["operations_ms"],
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
