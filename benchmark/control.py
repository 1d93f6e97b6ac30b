"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, the control's and the planted faults', in one process on the
card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
                                 [--sides program control half_batch] [--seconds S]

For each seed, the side ``program`` runs the cell as ``run.py`` does (a
window of ``--seconds``, 0 for none in training) and gives its numbers;
``control`` puts the plain reference computed in the control's lower
precision (``check.CONTROL``: the model's products on fp8 operands, the
chain and the scores in bfloat16) in the program's place, and
``half_batch`` (training) the float32 reference with half the batch left
out of the loss; each is compared with the float32 reference, computed
once a seed, by the same numbers. A limit lies between the program's
largest reading and the smallest of the control's and the faults'. Prints
a JSON line a seed and side.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def eval_indices(cell, seed):
    from benchmark import seeded
    tr = cell["traffic"]
    order = seeded.pool_order(seed, tr["sample_from"], tr["pool"])
    return [order[i] for i in seeded.sample_positions(seed, tr["sample_from"], tr["sample"])]


def exact_reference(cell, seed, device):
    """The float32 reference's outputs that the numbers compare with."""
    from benchmark import check, seeded
    tr = cell["traffic"]
    if tr["kind"] == "train":
        return check.reference_train(cell, seed, device, tr["check_steps"])
    pool = seeded.eval_pool(device, seed, tr["pool"], tr["hr_sizes"], cell["config"]["scale"])
    return check.reference_eval(cell, seed, device, pool, eval_indices(cell, seed))


def control_numbers(cell, seed, device, detail=None, fault=None, exact=None):
    """The control's numbers, or with ``fault="half_batch"`` (training)
    those of the float32 reference with that fault planted, in the
    program's place; ``exact`` is the float32 reference's outputs where
    they were computed already."""
    from benchmark import check, seeded
    tr = cell["traffic"]
    if exact is None:
        exact = exact_reference(cell, seed, device)
    if tr["kind"] == "train":
        steps = tr["check_steps"]
        if fault == "half_batch":
            low = check.reference_train(cell, seed, device, steps, half_batch=True)
        else:
            low = check.reference_train(cell, seed, device, steps, check.CONTROL)
        return check.train_numbers(low, exact, cell["config"]["leaf_families"], detail)
    pool = seeded.eval_pool(device, seed, tr["pool"], tr["hr_sizes"], cell["config"]["scale"])
    indices = sorted(exact)
    low = check.reference_eval(cell, seed, device, pool, indices, check.CONTROL)
    kept = [(i, low[i], check.reference_scores(low[i], pool[i][1], check.CONTROL["scores"]))
            for i in indices]
    return check.eval_numbers(kept, exact, pool)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=["control"],
                   choices=("program", "control", "half_batch"))
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import core, window
    cell = core.cell(core.load_benchmark(ROOT), args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        exact = None
        for side in args.sides:
            t0 = time.perf_counter()
            detail = {}
            if side == "program":
                out = window.run(cell, seed, args.seconds, False, [device], t0)
                numbers, exact = out["numbers"], out["reference"]
                extra = {"setup_s": out["setup_s"], **out["end_to_end"]}
                detail = out["detail"]
            else:
                if exact is None:
                    exact = exact_reference(cell, seed, device)
                numbers = control_numbers(cell, seed, device, detail,
                                          None if side == "control" else side, exact)
                extra = {}
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "numbers": numbers, "seconds": time.perf_counter() - t0,
                              **extra, "detail": detail}), flush=True)
            window.free(device)


if __name__ == "__main__":
    main()
