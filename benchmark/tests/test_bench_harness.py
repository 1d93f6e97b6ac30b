"""The harness's arithmetic, its data files, and what a run loads."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import core, layers, roofline, seeded, trace, window
from benchmark.tests.tiny import TINY_SEED, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.load_benchmark()


@pytest.mark.parametrize("values", [[3.0], [5.0, 1.0], list(np.random.RandomState(0).rand(401))])
def test_percentile_is_numpys(values):
    for q in (50, 95):
        assert window.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_union_and_idle_share():
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": d, "tid": 1,
               "args": {"correlation": i}} for i, (ts, d) in enumerate([(0, 10), (5, 10), (20, 10)])]
    t = trace.Trace(events, window_s=40e-6, units=1)
    assert t.busy_s == pytest.approx(25e-6)
    assert layers.idle_share({"kind": "train", "lean": t}, "train") == pytest.approx(37.5)
    assert layers.idle_share({"kind": "eval", "lean": t}, "train") is None


def test_ranges_attribute_launches():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.block", "ts": 0, "dur": 10, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.block", "ts": 20, "dur": 10, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
           "tid": 1, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15, "dur": 1,
           "tid": 1, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "void a<int>(x)", "ts": 4, "dur": 6, "tid": 9,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 16, "dur": 2, "tid": 9,
           "args": {"correlation": 8}}]
    t = trace.Trace(ev, window_s=40e-6, units=1)
    inside = t.launched_in(lambda n: n == "bench.block")
    assert [e["name"] for e in inside] == ["void a<int>(x)"]
    assert sum(len(v) for v in t.ranges(lambda n: n == "bench.block").values()) == 2
    assert t.device_ops()[0] == ["a", 6e-6]


def test_train_window_arithmetic():
    cell = tiny_cell("rcan_x4_blind_train_b120")
    out = window.run(cell, TINY_SEED, 0.5, False, ["cpu"], 0.0)
    t = cell["traffic"]
    run = out["run"]
    assert out["end_to_end"]["train_hr_mp_per_s"] == pytest.approx(
        out["attempted"] * t["batch"] * t["hr_side"] ** 2 / 1e6 / run["window_s"])
    assert out["attempted"] == len(out["losses"]) >= 1
    assert layers.mfu(run, "train") == pytest.approx(
        run["window_flops"] / run["window_s"] / 989e12 * 100)


@pytest.mark.parametrize("sizes", [[[64, 96]], [[64, 96], [48, 64]]])
def test_eval_window_arithmetic(sizes):
    cell = tiny_cell("rcan_x4_eval_div2k")
    cell["traffic"].update(hr_sizes=sizes, pool=2 * len(sizes))
    out = window.run(cell, TINY_SEED, 0.5, False, ["cpu"], 0.0)
    lat = out["latencies_ms"]
    assert len(lat) == out["attempted"]
    assert out["end_to_end"]["images_per_s"] == pytest.approx(
        out["attempted"] / out["run"]["window_s"])
    assert out["end_to_end"]["image_latency_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert sum(lat) / 1e3 == pytest.approx(out["run"]["window_s"])
    order = seeded.pool_order(TINY_SEED, out["attempted"], 2 * len(sizes))
    per_size = {tuple(s): roofline.model_flops(cell["config"], 1, s[0] // 4, s[1] // 4, False)
                for s in sizes}
    assert out["run"]["window_flops"] == pytest.approx(
        sum(per_size[tuple(sizes[i % len(sizes)])] for i in order))


def test_roofline_counts_each_traced_unit_at_its_shape():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.block", "ts": t, "dur": 10,
           "tid": 1} for t in (0, 100)]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 1, "dur": 1,
            "tid": 1, "args": {"correlation": i}} for i, t in enumerate((0, 100))]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": t + 2, "dur": 50, "tid": 9,
            "args": {"correlation": i}} for i, t in enumerate((0, 100))]
    shapes = [(1, 30, 40, 64), (1, 60, 80, 64)]
    run = {"kind": "eval", "dtype": "bf16", "unit_shapes": shapes,
           "trace": trace.Trace(ev, window_s=200e-6, units=2)}
    least = sum(roofline.least_seconds(*roofline.rcab_forward_work(*s, "bf16"), "bf16")
                for s in shapes)
    assert layers.block_roofline(run, "eval", lambda n: n == "bench.block",
                                 roofline.rcab_forward_work) == pytest.approx(
        least / 100e-6 * 100)


def test_names_and_units():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_file_is_found_and_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = core.cell(BENCH, w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert callable(core.metric_reader(m["name"]))
        if cell["traffic"]["kind"] == "train":
            fams = "|".join(f for f, _ in cell["config"]["leaf_families"])
            number = re.compile(rf"^(lr_gap|loss_gap|frozen_change|"
                                rf"(grad_gap|change_gap)\.({fams}))$")
            assert {"lr_gap", "loss_gap"} <= set(cell["limits"])
            assert all(number.match(k) for k in cell["limits"]), cell["limits"]
        else:
            assert set(cell["limits"]) == {"sr_gap", "sr_max_gap", "psnr_gap", "ssim_gap"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["unit"] != "%" or "roofline" in m["name"] or "mfu" in m["name"] \
            or "share" in m["name"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rumpy_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", sys)
    assert not {"rumpy_tpu", "jax"} & set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    monkeypatch.setitem(sys.modules, "rumpy_tpu.ops", sys)
    assert {"flax", "rumpy_tpu"} <= set(core.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); from benchmark import window, core; "
            "from benchmark.tests.tiny import tiny_cell, TINY_SEED; "
            "out = window.run(tiny_cell('bobw_qrcan_x4_blind_train_b192'), TINY_SEED, 0.2, False, "
            "['cpu'], 0.0); import json; print(json.dumps(core.forbidden_modules()))"
            % core.ROOT)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=core.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_the_benchmark_reads_nothing_of_the_jax_package():
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|rumpy_tpu|chip_smoke)\b(?!_)",
                         re.MULTILINE)
    paths = re.compile(r"[\"'/]rumpy_tpu/")
    for dirpath, _, files in os.walk(core.HERE):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not imports.search(text) and not paths.search(text), f


def test_no_card_no_result():
    """Without a CUDA card a run exits 2 and prints no result line."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
                          "rcan_x4_eval_div2k", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         cwd=core.ROOT, timeout=300)
    assert res.returncode == 2 and res.stdout.strip() == "", (res.returncode, res.stdout)


def test_idle_gaps_name_each_gap_by_the_ops_that_cover_it():
    """The nested index finds, for every gap, the host ops a scan of all of
    them finds, on a random tree of nested calls."""
    rng = np.random.RandomState(3)
    host = []

    def calls(start, stop, depth):
        t = start
        while depth < 4 and t < stop - 4:
            a = t + rng.randint(0, 3)
            b = min(stop, a + rng.randint(1, 40))
            host.append({"ph": "X", "cat": "user_annotation" if depth == 0 else "cpu_op",
                         "name": f"op{depth}.{rng.randint(3)}", "ts": a, "dur": b - a, "tid": 1})
            calls(a, b, depth + 1)
            t = b + rng.randint(0, 3)

    calls(0, 2000, 0)
    ev = list(host)
    for i, t in enumerate(sorted(rng.choice(2000, 150, replace=False))):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": int(t),
                   "dur": 1, "tid": 1, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i % 4}", "ts": int(t) + 2,
                   "dur": int(rng.randint(1, 6)), "tid": 9, "args": {"correlation": i}})
    t = trace.Trace(ev, window_s=2e-3, units=1)
    for at in range(0, 2000, 7):
        scan = [h for h in host if h["ts"] <= at <= h["ts"] + h["dur"]]
        assert sorted(map(id, trace._Nesting(host).covering(at))) == sorted(map(id, scan))
    busy = trace.merged(t.device)
    gaps = t.idle_gaps(top=100)
    assert gaps and sum(v for _, v in gaps) == pytest.approx(
        sum(b - a for (_, a), (b, _) in zip(busy, busy[1:])) / 1e6)
