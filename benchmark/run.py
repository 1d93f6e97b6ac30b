"""Run one cell of the port's benchmark once, on the cards the cell asks for.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and the files it names
(see ``benchmark/core.py``), builds ``rumpy_tpu_torch``'s handler for the
cell's configuration on the cell's cards (its CUDA kernels are built into
``rumpy_tpu_torch/build/`` inside the checkout at their first use, so only
a checkout's first run compiles), warms up, measures for ``--seconds``,
checks the outputs against the plain reference and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each compared number with its limit, also printed as the last
lines of standard error. Exits 2 without a result where the cell's cards
are missing, and 3 where JAX, flax or the JAX package was loaded by the
time the result would be printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# libraries that would load JAX by themselves stay off it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# kernel caches at fixed paths inside the checkout (the port builds its own
# CUDA libraries into rumpy_tpu_torch/build/ there already)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import core
    cell = core.cell(core.load_benchmark(ROOT), args.workload)
    core.require_cards(cell["chips"])

    import torch

    from benchmark import check, window
    t_torch = time.perf_counter() - T_START
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    for device in devices:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device).sum().item()
    torch.cuda.set_device(devices[0])
    t_context = time.perf_counter() - T_START
    out = window.run(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    out["detail"]["setup_parts_s"].update(import_torch=t_torch, cuda_context=t_context)
    del out["reference"]

    run = out["run"]
    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = core.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    correct, rows = check.judge(out["numbers"], cell["limits"])
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
                  "count": len(devices), "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct and out["failed"] == 0, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device_rec}
    if args.trace:
        lean, host = run["lean"], run["trace"]
        device_rec.update(busy_s=lean.busy_s, window_s=lean.window_s)
        line["breakdown"] = {"device_ops": lean.device_ops(), "idle_gaps": host.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}", file=sys.stderr)
        return 3
    print("detail " + json.dumps(out["detail"]), file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
