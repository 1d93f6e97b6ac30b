"""Traffic of ``kind: "train"``: ``batch`` HR crops of ``hr_side`` a step,
fresh from the seed, through ``train_batch`` with ``chain`` (bench.py's
layout) as the input pipeline, on the cell's first card.

Set-up builds the handler, drives it through ``check_steps`` steps (the
reference follows them; the first builds the kernels), and hands the same
object to the window, which runs steps until ``seconds`` have passed and
waits for the card. Rate: every HR pixel of every step over the window's
seconds. With ``traced`` the window is followed by two profiled ones of
``traced_units`` steps: the CUDA activity alone, then the host's ops too
with the benchmark's ranges.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, roofline, seeded, trace
from benchmark.system import Program, Ranges
from benchmark.window import free, peak_bytes, reset_peak, sync


def run(cell, seed, seconds, traced, devices, t_start) -> dict:
    device = devices[0]
    cfg, tr = cell["config"], cell["traffic"]
    batch, side, steps = tr["batch"], tr["hr_side"], tr["check_steps"]
    ranges = Ranges()
    parts = {"before_build": time.perf_counter() - t_start}
    prog = Program(cfg, device, seed, ranges)
    kept = []
    prog.set_chain(tr["chain"], kept)
    g_crops = seeded.generator(device, seed, seeded.CROPS)
    start = prog.state_copy()
    sync(device)
    parts["built"] = time.perf_counter() - t_start
    losses = []
    for step in range(steps):
        losses.append(prog.train_step(seeded.hr_crops(g_crops, batch, side)))
        if step == 0:
            grad_norms = prog.first_gradient_norms()
            parts["first_step"] = time.perf_counter() - t_start
    now = prog.state_copy()
    got = {"lr": kept[:], "loss": [float(v) for v in losses], "grad_norms": grad_norms,
           "change_norms": {k: float(torch.linalg.vector_norm(now[k] - start[k])) for k in now}}
    prog.keep = None
    del start, now, kept
    sync(device)
    setup_s = time.perf_counter() - t_start

    peak_setup = peak_bytes(device)
    reset_peak(device)
    window_losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        window_losses.append(prog.train_step(seeded.hr_crops(g_crops, batch, side)))
    sync(device)
    window_s = time.perf_counter() - t0
    n = len(window_losses)
    peak_window = peak_bytes(device)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) if n else 0
    lr_h = side // cfg["scale"]
    block = (batch, lr_h, lr_h, cfg["n_feats"])
    out = {"attempted": n, "failed": failed, "setup_s": setup_s,
           "memory_peak_bytes": max(peak_setup, peak_window),
           "end_to_end": {"train_hr_mp_per_s": n * batch * side * side / 1e6 / window_s},
           "losses": [float(v) for v in window_losses],
           "run": {"kind": "train", "cell": cell, "dtype": cfg["dtype"],
                   "window_s": window_s, "window_units": n,
                   "window_flops": n * roofline.model_flops(cfg, batch, lr_h, lr_h, True),
                   "peak_window_bytes": peak_window}}
    if traced:
        units = tr["traced_units"]

        def steps_traced():
            for _ in range(units):
                prog.train_step(seeded.hr_crops(g_crops, batch, side))
            sync(device)

        out["run"]["unit_shapes"] = [block] * units
        out["run"]["lean"] = trace.profiled(steps_traced, units, host_ops=False)
        ranges.enabled = True
        out["run"]["trace"] = trace.profiled(steps_traced, units, host_ops=True)
        ranges.enabled = False
    prog.close()
    del prog, window_losses
    free(device)
    t_ref = time.perf_counter()
    ref = check.reference_train(cell, seed, device, steps)
    out["detail"] = {"setup_parts_s": parts, "reference_s": time.perf_counter() - t_ref}
    out["numbers"] = check.train_numbers(got, ref, cfg["leaf_families"], out["detail"])
    out["reference"] = ref
    return out
