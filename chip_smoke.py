"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``rumpy_tpu_torch/csrc`` into
``rumpy_tpu_torch/build/``, holds it against its plain PyTorch version at
every shape the main path gives it (one per forward that the predictor
plans for the requests) and at a few others, then serves full-width RCAN x4 (10 groups x 20 RCAB, 64
features, bf16, seeded random weights) through the normal entry points:
registry -> handler -> checkpoint -> SISRInterface(eval, load_epoch="last")
-> BatchedPredictor.predict. It checks that every RCAB went through the
kernel, that the outputs are finite and of the right shape, and that the
kernel path agrees with the plain path and with the CPU.

Prints the card, then one JSON line per phase, then a ``{"kernels": ...}``
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# Kernel shapes beside the main path's: a ragged image (SISRInterface pads
# only to size_multiple 1) and other channel counts, one of them (C=24) on
# the CUDA-core pass in bf16.
EXTRA_SHAPES = [(1, 86, 57, 64), (1, 64, 64, 32), (1, 40, 33, 128),
                (1, 33, 45, 24)]


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


def trace_phase(model, state, x):
    """torch.profiler over two forwards: device time by kernel family per
    forward, and the share of the traced span the card sat idle."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            model.run_eval(state, {"lr": x})
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "rcan_forward_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not events:
        raise AssertionError("the profiler traced no kernel on the card")
    by_family = {}
    for e in events:
        fam = next((k for k in ("rcab_conv_mma", "rcab_conv_kernel", "rcab_gate",
                                "rcab_apply") if k in e["name"]), "other")
        by_family[fam] = by_family.get(fam, 0.0) + e["dur"] / 2
    busy = sum(e["dur"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return {"phase": "trace", "per_forward_device_us": by_family,
            "kernels_per_forward": len(events) / 2, "busy_us": busy,
            "span_us": span, "idle_share": 1 - busy / span}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rumpy_tpu_torch.ops.cuda import build
    from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    build.load("rcab_fused")
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "nvcc_seconds": build.build_seconds}), flush=True)

    main_row, bf16_err = kernel_phase(rcab)
    launches = slice_phase(rcab, card)

    kernels = [{
        "name": "rcab_fused", "route": "cuda",
        "source": "rumpy_tpu_torch/csrc/rcab_fused.cu",
        "replaces": "rumpy_tpu/ops/pallas/rcab_fused.py:73",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
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
