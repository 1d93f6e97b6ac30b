"""Processes of the port's tests.

Rank processes for the port's data-parallel tests: a gloo group on the
CPU, spawned once a world, runs every case it is handed and writes its
results for the test process to hold against the JAX mesh and against the
port in one process. Imports torch and the port only (the ranks start
from ``spawn``: no JAX in them).

``single_threaded``: the fixture every ``tests/test_torch_*.py`` file
imports. The tests run in several worker processes at once (and two files
start four rank processes beside them); torch's OpenMP pool and numpy's
BLAS, left at their default, each spin as many threads as the machine has
cores in every one of them. A file's tests run both on one thread;
``default_threads`` gives a block torch's default count back.
"""

import contextlib
import os
import sys
import time

import pytest
import torch

from rumpy_tpu_torch.utils.precision import float64, float_as_double


# torch's intra-op thread count when this module is imported: its default
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def single_threaded():
    """torch's intra-op pool and every native thread pool threadpoolctl
    finds (OpenMP, BLAS) on one thread for the importing file's tests;
    torch's count before is restored after them."""
    from threadpoolctl import threadpool_limits
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def default_threads():
    """torch at its default intra-op thread count inside the block: for the
    float32 steps whose tolerance against JAX holds at the summation order
    of torch's threaded reductions (on one thread, a bias gradient summed
    over 32,768 terms in order stands up to twice that tolerance off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(t):
    return t.detach().cpu().numpy().copy() if torch.is_tensor(t) else t


def _handler(spec):
    from rumpy_tpu_torch.registry import get_model
    h = get_model(spec["model"])(device="cpu", **spec["kwargs"])
    if spec.get("epoch") is not None:
        h.set_epoch(spec["epoch"])
    for name, args in spec.get("setup", ()):
        getattr(h, name)(*args)
    state = h.init_state(seed=spec.get("seed", 0))
    if spec.get("state_dict") is not None:
        with torch.no_grad():
            h.module.load_state_dict(spec["state_dict"])
        state = h._own_state()
    return h, state


def handler_steps(spec, mesh):
    """``spec["steps"]`` train steps of a handler from its given weights on
    this rank's rows of the global batch (the whole batch without a mesh),
    in float64 where ``spec["float64"]``. Returns each step's losses and the
    state dict after them."""
    import contextlib

    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    h, state = _handler(spec)
    batch = spec["batch"]
    if mesh is not None:
        batch = mesh_mod.shard_batch(mesh, batch)
    wide = spec.get("float64")
    losses = []
    with (float64(h) if wide else contextlib.nullcontext(state)) as state:
        for _ in range(spec.get("steps", 1)):
            state, lo = h.train_batch(state, {
                k: torch.from_numpy(v).double() if wide and v.dtype.kind == "f"
                else torch.from_numpy(v) for k, v in batch.items()})
            losses.append({k: float(v) for k, v in lo.items()})
    # the momentum encoder follows the query encoder's pre-step weights,
    # the same on every rank: not returned
    return {"losses": losses,
            "state": {k: _np(v) for k, v in h.module.state_dict().items()
                      if not k.startswith("key_encoder.")}}


@case
def steps(spec, mesh):
    return handler_steps(spec, mesh)


@case
def facegan(spec, mesh):
    """FaceGAN on this rank's rows of the global batch: with ``draws`` one
    ``step_from_draws`` of those global draws, else ``train_batch`` from the
    handler's own draws (SGD for both networks, the discriminator at
    ``d_lr``; in float64 where ``spec["float64"]``, its own draws too).
    Returns the losses and the state dict, or the error a step raised."""
    import contextlib

    from rumpy_tpu_torch.models.base import build_optimizer
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    h, state = _handler(spec)
    batch = spec["batch"] if mesh is None else mesh_mod.shard_batch(mesh, spec["batch"])
    with (float64(h) if spec.get("float64") else contextlib.nullcontext(state)) as state:
        h._d_optimizer = build_optimizer(h.discriminator.parameters(), spec["d_lr"], "sgd")
        dtype = torch.get_default_dtype()  # the handler's draws'
        hr = torch.from_numpy(batch["hr"]).to(dtype)
        try:
            if spec.get("draws") is None:
                _, lo = h.train_batch(state, {"hr": hr})
            else:
                lo = h.step_from_draws(state, {"hr": hr}, {
                    k: torch.from_numpy(v).to(dtype) if v.dtype.kind == "f"
                    else torch.from_numpy(v) for k, v in spec["draws"].items()})
        except ValueError as e:
            return {"error": str(e)}
    return {"losses": {k: float(v) for k, v in lo.items()},
            "state": {k: _np(v) for k, v in h.module.state_dict().items()}}


@case
def batchnorm(spec, mesh):
    """A flax-style BatchNorm in train mode in float64 (its float32
    statistics widened) on this rank's rows: output, input gradient of
    ``sum(y * g)``, running statistics."""
    from rumpy_tpu_torch.models.common import BatchNorm
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    batch = {"x": spec["x"], "g": spec["g"]}
    if mesh is not None:
        batch = mesh_mod.shard_batch(mesh, batch)
    with float_as_double():
        bn = BatchNorm(spec["x"].shape[1], dtype=torch.float64).double()
        x = torch.from_numpy(batch["x"]).requires_grad_(True)
        y = bn(x, train=True)
        (y * torch.from_numpy(batch["g"])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


@case
def chain(spec, mesh):
    """The degradation chain on this rank's images of a global HR batch
    (``views`` views an image), from the same seeded generator."""
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    pipe = ImagePipeline(spec["pipeline"], deg_configs=spec["deg_configs"], scale=spec["scale"])
    hr, views = spec["hr"], spec["views"]
    rows = None
    if mesh is not None:
        hr = mesh_mod.shard_batch(mesh, {"hr": hr.reshape((-1, views) + hr.shape[1:])})["hr"]
        hr = hr.reshape((-1,) + hr.shape[2:])
        rows = mesh.rows(hr.shape[0] // views)
    gen = torch.Generator().manual_seed(spec["seed"])
    lr, meta = pipe.degrade_batch(gen, torch.from_numpy(hr), views=views, rows=rows)
    return {"lr": _np(lr), "meta": {k: _np(v) for k, v in meta.items()}}


@case
def checkpoint(spec, mesh):
    """A step, a checkpoint (rank 0 writes), a second step from the live
    state and one from the checkpoint reloaded by every rank."""
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    h, state = _handler(spec)
    batch = {k: torch.from_numpy(v) for k, v in
             (spec["batch"] if mesh is None else mesh_mod.shard_batch(mesh, spec["batch"])).items()}
    state, _ = h.train_batch(state, batch)
    save_dir = os.path.join(spec["dir"], "saved_models")
    h.save_model(state, save_dir, epoch=3)
    mesh_mod.barrier(mesh)
    files = sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else []
    cont, loss_cont = h.train_batch(state, batch)
    cont_sd = {k: _np(v) for k, v in h.module.state_dict().items()}
    h2, _ = _handler(spec)
    restored, epoch = h2.load_model(save_dir, epoch="last")
    mesh_mod.replicate(mesh, restored)
    resumed, loss_res = h2.train_batch(restored, batch)
    return {"files": files, "epoch": epoch, "loss_cont": float(loss_cont["train-loss"]),
            "loss_res": float(loss_res["train-loss"]), "cont": cont_sd,
            "res": {k: _np(v) for k, v in h2.module.state_dict().items()}}


@case
def trainer(spec, mesh):
    """``cli.train_sisr`` on the CPU under the group (or alone): the
    params after its epoch, its losses, and the files it wrote."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    stats = train_sisr.main(["-p", spec["config"], "--device", "cpu"])
    mesh_mod.barrier(mesh)  # rank 0's checkpoint is written
    exp = spec["experiment_dir"]
    from rumpy_tpu_torch.utils.checkpoint import checkpoint_path, load_checkpoint
    saved = load_checkpoint(checkpoint_path(os.path.join(exp, "saved_models"), 0)) \
        if os.path.isfile(checkpoint_path(os.path.join(exp, "saved_models"), 0)) else None
    return {"stats": stats, "network": None if saved is None else
            {k: _np(v) for k, v in saved["network"].items()}}


@case
def mesh_errors(spec, mesh):
    """``get_mesh`` refuses a data axis smaller than the group."""
    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    try:
        mesh_mod.get_mesh(n_data=mesh.size + 1)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


@case
def spatial(spec, mesh):
    """``spatial_sharded_forward`` of a network rebuilt from ``spec``."""
    from rumpy_tpu_torch.parallel.spatial import (_reflect_rows, halo_exchange,
                                                  spatial_sharded_forward)
    forward = build_forward(spec)
    image = torch.from_numpy(spec["image"])
    with torch.no_grad():
        out = spatial_sharded_forward(forward, image, spec["scale"], mesh, halo=spec["halo"])
        # this rank's strip of the image padded to a multiple of the ranks
        image = _reflect_rows(image, 0, (-image.shape[1]) % mesh.size)
        rows = image.shape[1] // mesh.size
        ext = halo_exchange(image[:, mesh.rank * rows:(mesh.rank + 1) * rows], spec["halo"], mesh)
    return {"out": _np(out), "ext": _np(ext)}


@case
def serving(spec, mesh):
    """The Set5-like requests through ``BatchedPredictor(mesh=...)``."""
    from rumpy_tpu_torch.serving import BatchedPredictor
    h, state = _handler(spec)
    pred = BatchedPredictor(h, state, mesh=mesh, pad_multiple=spec["pad_multiple"],
                            max_batch=spec["max_batch"])
    outs = pred.predict(spec["images"], metadata=spec.get("metadata"))
    return {"outs": outs}


def build_forward(spec):
    """A forward from its spec: "convs" (two 3x3 convs with a ReLU and a x2
    pixel shuffle, or one conv, NHWC kernels HWIO) or "rcan" (a port RCAN
    from its state dict)."""
    import torch.nn.functional as F

    from rumpy_tpu_torch.models.common import pixel_shuffle
    if spec["net"] == "convs":
        ks = [torch.from_numpy(k).permute(3, 2, 0, 1) for k in spec["kernels"]]

        def forward(x):
            y = x.permute(0, 3, 1, 2)
            for i, k in enumerate(ks):
                y = F.conv2d(y, k, padding=1)
                if i < len(ks) - 1:
                    y = torch.relu(y)
            if spec["scale"] > 1:
                y = pixel_shuffle(y, spec["scale"])
            return y.permute(0, 2, 3, 1)
        return forward
    h, state = _handler(spec)
    return lambda x: h.run_eval(state, {"lr": x})


def _rank_main(rank, world, init_file, specs_file, out_dir):
    """One rank of a gloo world on the CPU. For each group size of
    ``specs_by_size``, the world is cut into groups of that size (all of it
    for the world's own size), each group runs every case as the active
    mesh of its ranks, and the results of the first group's ranks are
    written; a case with ``first_group`` runs in the first group alone (it
    writes files). Size 1 is the port in one process (no collective)."""
    import torch.distributed as dist

    from rumpy_tpu_torch.parallel import mesh as mesh_mod
    torch.set_num_threads(1)
    world_mesh = mesh_mod.get_mesh(device="cpu", init_method=f"file://{init_file}",
                                   rank=rank, world_size=world)
    specs_by_size = torch.load(specs_file, weights_only=False)
    for size, specs in sorted(specs_by_size.items()):
        index = rank // size
        if size == world:
            mesh = world_mesh
        elif size == 1:  # one process, no collective
            mesh = mesh_mod.Mesh(0, 1, world_mesh.device)
        else:
            groups = [dist.new_group(list(range(i, i + size))) for i in range(0, world, size)]
            mesh = mesh_mod.Mesh(rank % size, size, world_mesh.device, group=groups[index])
        mesh_mod._MESH[0] = mesh
        results = {name: CASES[spec["case"]](spec, mesh) for name, spec in specs.items()
                   if index == 0 or not spec.get("first_group")}
        mesh_mod._MESH[0] = world_mesh
        if index == 0:
            torch.save(results, os.path.join(out_dir, f"size{size}_rank{rank}.pt"))
    mesh_mod.barrier(world_mesh)
    mesh_mod.leave_mesh()
    # the results are on disk: skip the interpreter's slow teardown
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def start_world(world, specs_by_size, out_dir):
    """Spawns ``world`` gloo ranks running every spec at each group size
    (handed over in a file, so that no start waits for a rank's imports);
    returns the context (``join`` it, then :func:`results`)."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "group_store")
    specs_file = os.path.join(out_dir, "specs.pt")
    torch.save(specs_by_size, specs_file)
    return mp.start_processes(_rank_main, args=(world, init_file, specs_file, out_dir),
                              nprocs=world, join=False, start_method="spawn")


def results(ctx, sizes, out_dir, timeout_s=300):
    """{group size: [each rank's results, in rank order]}. Ranks still
    running after ``timeout_s`` are killed and the call raises."""
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"rank processes still running after {timeout_s} s")
    return {size: [torch.load(os.path.join(out_dir, f"size{size}_rank{r}.pt"),
                              weights_only=False) for r in range(size)] for size in sizes}


def run_alone(specs):
    """Every spec in this process, without a group."""
    return {name: CASES[spec["case"]](spec, None) for name, spec in specs.items()}
