"""Traffic of ``kind: "eval"``: one client, closed loop, on the cell's first
card, over a pool of ``pool`` image pairs made from the seed (HR sizes
``hr_sizes`` in turn, LR each one's 1/scale): each image's SR through
``run_eval``, its Y-channel PSNR and SSIM, one fetch. Each image's latency
runs from when it was due (the previous one's fetch) to its fetch.

Set-up warms up with ``warmup`` images of each size. The window takes the
pool's images in seeded rounds until ``seconds`` have passed or
``max_images`` are done; ``sample`` of the first ``sample_from``, drawn
from the seed, and the last are checked. With ``traced`` the window is
followed by two profiled ones of ``traced_units`` images: the CUDA
activity alone, then the host's ops too with the benchmark's ranges.
"""

from __future__ import annotations

import time

from benchmark import check, roofline, seeded, trace
from benchmark.system import Program, Ranges
from benchmark.window import finite, free, peak_bytes, percentile, reset_peak, sync


def run(cell, seed, seconds, traced, devices, t_start) -> dict:
    device = devices[0]
    cfg, tr = cell["config"], cell["traffic"]
    ranges = Ranges()
    parts = {"before_build": time.perf_counter() - t_start}
    prog = Program(cfg, device, seed, ranges)
    pool = seeded.eval_pool(device, seed, tr["pool"], tr["hr_sizes"], cfg["scale"])
    sync(device)
    parts["built"] = time.perf_counter() - t_start
    firsts = {}
    for i, (lr, _) in enumerate(pool):
        firsts.setdefault(tuple(lr.shape[:2]), i)
    for size, i in firsts.items():
        for j in range(tr["warmup"]):
            prog.evaluate(*pool[i])
            parts[f"warmup_{size[0]}x{size[1]}_{j}"] = time.perf_counter() - t_start
    sync(device)
    setup_s = time.perf_counter() - t_start

    order = seeded.pool_order(seed, tr["max_images"], len(pool))
    checked = set(seeded.sample_positions(seed, tr["sample_from"], tr["sample"]))
    kept, latencies, scores = [], [], []
    peak_setup = peak_bytes(device)
    reset_peak(device)
    t0 = due = time.perf_counter()
    while due - t0 < seconds and len(latencies) < len(order):
        i = order[len(latencies)]
        sr, s = prog.evaluate(*pool[i])
        done = time.perf_counter()
        if len(latencies) in checked:
            kept.append((i, sr, s))
        latencies.append(done - due)
        scores.append(s)
        due = done
    window_s = due - t0
    n = len(latencies)
    # the last image is checked too
    if n - 1 not in checked:
        kept.append((order[n - 1], sr, s))
    peak_window = peak_bytes(device)

    def block(i):
        h, w = pool[i][0].shape[:2]
        return (1, h, w, cfg["n_feats"])

    def flops(i):
        return roofline.model_flops(cfg, 1, *pool[i][0].shape[:2], False)

    out = {"attempted": n,
           "failed": sum(1 for s in scores if not all(map(finite, s.values()))),
           "setup_s": setup_s, "memory_peak_bytes": max(peak_setup, peak_window),
           "end_to_end": {"images_per_s": n / window_s,
                          "image_latency_p95_ms": percentile(latencies, 95) * 1e3},
           "latencies_ms": [v * 1e3 for v in latencies],
           "run": {"kind": "eval", "cell": cell, "dtype": cfg["dtype"], "window_s": window_s,
                   "window_units": n, "window_flops": sum(flops(i) for i in order[:n]),
                   "peak_window_bytes": peak_window}}
    if traced:
        units = tr["traced_units"]
        traced_images = [order[j % len(order)] for j in range(units)]

        def images_traced():
            for i in traced_images:
                prog.evaluate(*pool[i])
            sync(device)

        out["run"]["unit_shapes"] = [block(i) for i in traced_images]
        out["run"]["lean"] = trace.profiled(images_traced, units, host_ops=False)
        ranges.enabled = True
        out["run"]["trace"] = trace.profiled(images_traced, units, host_ops=True)
        ranges.enabled = False
    prog.close()
    del prog, sr
    free(device)
    t_ref = time.perf_counter()
    ref = check.reference_eval(cell, seed, device, pool, [i for i, _, _ in kept])
    out["detail"] = {"setup_parts_s": parts, "checked": [i for i, _, _ in kept],
                     "reference_s": time.perf_counter() - t_ref}
    out["numbers"] = check.eval_numbers(kept, ref, pool)
    out["reference"] = ref
    return out
