"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rumpy_tpu")


def _port_files():
    files = sorted((ROOT / "rumpy_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    from rumpy_tpu_torch.device import resolve_device
    from rumpy_tpu_torch.interface import SISRInterface
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("rcan")(n_feats=8, n_resgroups=1, n_resblocks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SISRInterface(mode="eval", new_params={"name": "edsr"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


WRAPPERS = [("rcab_fused", "rcab_fused", "rcab_reference"),
            ("local_entropy", "local_entropy", "local_entropy_reference")]


@pytest.mark.parametrize("module,wrapper,plain", WRAPPERS)
def test_kernel_wrapper_never_falls_back_on_cuda_tensors(module, wrapper, plain):
    """A CUDA tensor goes to the kernel or raises: the plain version is
    reached only through the CPU device check."""
    path = ROOT / "rumpy_tpu_torch" / "ops" / "cuda" / f"{module}.py"
    src = ast.parse(path.read_text())
    fn = next(n for n in src.body
              if isinstance(n, ast.FunctionDef) and n.name == wrapper)
    tries = [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    assert not tries
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == plain]
    assert len(calls) == 1
    guards = [n for n in ast.walk(fn) if isinstance(n, ast.If)
              and "device.type == 'cpu'" in ast.unparse(n.test)
              and any(c in ast.walk(n) for c in calls)]
    assert len(guards) == 1


def test_autograd_function_uses_plain_versions_on_cpu_only():
    """Both directions of the RCAB Function reach their plain version
    under the CPU device check alone, with no try around a launch."""
    path = ROOT / "rumpy_tpu_torch" / "ops" / "cuda" / "rcab_fused.py"
    cls = next(n for n in ast.parse(path.read_text()).body
               if isinstance(n, ast.ClassDef) and n.name == "_RCABFunction")
    assert not [n for n in ast.walk(cls) if isinstance(n, ast.Try)]
    for method, plain in (("forward", "rcab_reference"),
                          ("backward", "rcab_backward_reference")):
        fn = next(n for n in cls.body if getattr(n, "name", "") == method)
        guarded = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                   and "device.type == 'cpu'" in ast.unparse(n.test)]
        assert len(guarded) == 1
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", "") == plain]
        assert len(calls) == 1
        assert any(calls[0] in ast.walk(stmt) for stmt in guarded[0].body)


def test_port_covers_the_training_modules_and_cli():
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    for want in ("cli/train_sisr.py", "training/trainer.py", "data/datasets.py",
                 "data/loader.py", "ops/entropy.py", "ops/cuda/local_entropy.py",
                 "utils/stats.py"):
        assert want in names


def test_port_imports_at_module_level_only_torch_and_numpy_extras():
    """The port must import where only torch and numpy are installed: no
    PIL, pandas, click, msgpack, matplotlib, triton, scikit-learn or umap
    when a module is imported (PIL is imported inside the function that
    opens an image file)."""
    absent = ("PIL", "pandas", "click", "msgpack", "matplotlib", "triton", "sklearn", "umap")
    bad = []
    for p in _port_files():
        for node in ast.parse(p.read_text()).body:
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [(node.module or "").split(".")[0]]
            bad += [f"{p.relative_to(ROOT)}:{node.lineno} imports {m}"
                    for m in mods if m in absent]
    assert not bad, bad


def test_kernel_sources_call_no_library_kernels():
    sources = sorted((ROOT / "rumpy_tpu_torch" / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"rcab_fused.cu", "rcab_fused_bwd.cu",
                                         "local_entropy.cu", "rcab_common.cuh"}
    for p in sources:
        text = p.read_text().lower()
        for word in ("cudnn", "cublas", "cutlass", "torch/"):
            assert word not in text, f"{p.name} mentions {word}"


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.data.datasets import SuperResImages
    from rumpy_tpu_torch.interface import SISRInterface
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np
    np.save(tmp_path / "a.npy", np.zeros((24, 24, 3), np.uint8))
    cfg = {"experiment": "e", "no_directories": True,
           "data": {"scale": 2, "crop": 8,
                    "training_sets": {"d": {"lr_dir": str(tmp_path)}}},
           "model": {"name": "edsr", "internal_params": {"num_blocks": 1}}}
    dump_toml(cfg, str(tmp_path / "c.toml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sisr.main(["-p", str(tmp_path / "c.toml")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SISRInterface(mode="train", new_params=cfg["model"])
    ds = SuperResImages(lr_dir=str(tmp_path), crop=8, patch_type="entropy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds[0]


DEGRADATION_MODULES = ("ops/special.py", "ops/blur_kernels.py", "ops/blur.py",
                       "ops/resize.py", "ops/noise.py", "ops/jpeg.py", "ops/color_aug.py",
                       "degradations/base.py", "degradations/blur.py",
                       "degradations/resize_ops.py", "degradations/noise.py",
                       "degradations/compression.py", "degradations/pipeline.py")


def test_port_covers_the_degradation_modules():
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in DEGRADATION_MODULES if m not in names]
    assert not missing, missing


# Calls that wait for the card: a value read back to the host, or an output
# whose size depends on the data.
SYNCING_CALLS = ("item", "tolist", "cpu", "numpy", "bincount", "nonzero", "unique",
                 "multinomial", "masked_select", "synchronize")


@pytest.mark.parametrize("module", DEGRADATION_MODULES)
def test_degradation_device_paths_read_nothing_back(module):
    """The chain runs inside every train step: none of its modules calls
    what would stall the card's queue (chip_smoke.py checks one
    degrade_batch under torch.cuda.set_sync_debug_mode("error") as well)."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / module).read_text())
    bad = [f"{module}:{n.lineno} .{n.func.attr}()" for n in ast.walk(tree)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in SYNCING_CALLS]
    assert not bad, bad


EVALUATION_MODULES = ("utils/metrics.py", "utils/flax_msgpack.py", "utils/visualization.py",
                      "evaluation/eval_hub.py", "cli/eval_sisr.py")


def test_port_covers_the_evaluation_modules():
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in EVALUATION_MODULES if m not in names]
    assert not missing, missing


@pytest.mark.parametrize("module,allowed", [("utils/metrics.py", "fetch"),
                                            ("evaluation/eval_hub.py", "_sync")])
def test_evaluation_waits_for_the_card_in_one_place(module, allowed):
    """The metrics read back only in ``fetch`` (one copy a batch); EvalHub
    waits for the card only in ``_sync``, which ``time_models`` uses."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / module).read_text())
    inside = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
              and f.name == allowed for n in ast.walk(f)}
    bad = [f"{module}:{n.lineno} .{n.func.attr}()" for n in ast.walk(tree)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in SYNCING_CALLS and id(n) not in inside]
    assert not bad, bad


def test_flax_reader_imports_no_msgpack():
    path = ROOT / "rumpy_tpu_torch" / "utils" / "flax_msgpack.py"
    mods = {root for root, _ in _imported_roots(path)}
    assert "msgpack" not in mods and "flax" not in mods


def test_true_div_keeps_ieee_division():
    """On the card ``tensor / 255.0`` multiplies by the reciprocal of 255,
    one ulp off for 126 of the 256 levels; the device paths divide through
    ``device.true_div``, which gives numpy's quotients."""
    import numpy as np
    from rumpy_tpu_torch.device import true_div
    levels = torch.arange(256, dtype=torch.float32)
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    reciprocal = (levels * float(np.float32(1.0) / np.float32(255.0))).numpy()
    assert (reciprocal != want).sum() == 126
    got = true_div(levels, 255.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    q = torch.arange(1, 101, dtype=torch.float32)
    np.testing.assert_array_equal(true_div(5000.0, q).numpy(),
                                  np.float32(5000.0) / q.numpy())


BOBW_MODULES = ("models/attention_manipulators.py", "models/contrastive.py",
                "models/blind_sr.py", "utils/weights.py", "models/common.py")


def test_port_covers_the_bobw_modules():
    """The BoBW slice's modules are in the package, so the import scans
    above read them too; the registry finds both of its handlers."""
    from rumpy_tpu_torch.registry import available_models
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in BOBW_MODULES if m not in names]
    assert not missing, missing
    assert {"qrcan", "contrastiveblindqrcan"} <= set(available_models())


PREDICTOR_MODULES = ("models/contrastive_labelling.py", "models/contrastive.py",
                     "utils/losses.py", "data/metadata.py", "training/regression_trainer.py",
                     "evaluation/contrastive_eval.py")


def test_port_covers_the_predictor_modules():
    """The predictor slice's modules are in the package (so the import
    scans above read them) and the registry finds its five handlers."""
    from rumpy_tpu_torch.registry import available_models
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in PREDICTOR_MODULES if m not in names]
    assert not missing, missing
    assert {"moco", "supmoco", "weakcon", "supcon", "degradationregressor"} <= set(
        available_models())


@pytest.mark.parametrize("module,functions", [
    ("models/contrastive.py", ("train_batch", "compute_logits", "enqueue", "enqueue_sides",
                               "momentum_update", "class_matches", "moco_logits", "extra_losses",
                               "softmax_cross_entropy_first")),
    ("models/blind_sr.py", ("train_batch", "_joint_step")),
    ("training/regression_trainer.py", ("_degrade_views", "_assemble_contrastive_batch"))])
def test_contrastive_steps_read_nothing_back(module, functions):
    """A contrastive step (momentum update, key and query forwards, queue
    contrast, enqueue) and the trainer's view assembly stay on the device:
    no call in them waits for the card (chip_smoke.py runs the steps under
    torch.cuda.set_sync_debug_mode("error") as well)."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / module).read_text())
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name in functions]
    assert {f.name for f in fns} == set(functions)
    bad = [f"{module}:{n.lineno} .{n.func.attr}()" for f in fns for n in ast.walk(f)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in SYNCING_CALLS]
    assert not bad, bad


def test_predictor_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The predictor handlers and the regression trainer default to the
    card and raise without it."""
    from rumpy_tpu_torch.cli import train_sisr
    from rumpy_tpu_torch.config.loader import dump_toml
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("moco", "supmoco", "weakcon", "supcon", "degradationregressor"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model(name)()
    import numpy as np
    np.save(tmp_path / "a.npy", np.zeros((64, 64, 3), np.uint8))
    cfg = {"experiment": "e", "no_directories": True,
           "data": {"task_type": "regression", "scale": 2, "crop": 16,
                    "training_sets": {"d": {"lr_dir": str(tmp_path)}}},
           "model": {"name": "supmoco", "internal_params": {"K": 8, "dim": 32}}}
    dump_toml(cfg, str(tmp_path / "c.toml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sisr.main(["-p", str(tmp_path / "c.toml")])


METADATA_MODULES = ("models/attention_manipulators.py", "models/blind_sr.py",
                    "models/advanced.py", "models/sftmd_variants.py", "degradations/pca.py",
                    "degradations/blur.py", "degradations/noise.py", "evaluation/eval_hub.py",
                    "cli/eval_sisr.py", "utils/weights.py")
METADATA_MODELS = ("qrcan", "qedsr", "contrastiveblindqedsr", "srmd", "edsrmd", "sftmd")


def test_port_covers_the_metadata_conditioned_modules():
    """The metadata slice's modules are in the package (so the import scans
    above read them), the registries find its models and blur ops, and
    none of its options raises as a later slice's would."""
    from rumpy_tpu_torch.degradations.blur import RealESRGANBlur
    from rumpy_tpu_torch.degradations.noise import RealESRGANNoise
    from rumpy_tpu_torch.registry import available_models, available_tools, get_model
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in METADATA_MODULES if m not in names]
    assert not missing, missing
    assert set(METADATA_MODELS) <= set(available_models())
    assert {"srmdgaussianblur", "bsrganblur"} <= set(available_tools())
    small = dict(device="cpu", scale=2, n_feats=16, n_resgroups=1, n_resblocks=1, reduction=4)
    for kw in (dict(style="softmax"), dict(style="extended_attention"),
               dict(include_pixel_attention=True, include_sft_layer=True)):
        get_model("qrcan")(**small, **kw)
    for kw in (dict(sft_mode=True), dict(srmd_mode=True)):
        get_model("contrastiveblindqrcan")(**small, **kw)
    get_model("qedsr")(device="cpu", scale=2, num_features=16, num_blocks=1,
                       selective_meta_blocks="front_only")
    get_model("contrastiveblindqedsr")(device="cpu", scale=2, num_features=16, num_blocks=1)
    for name in ("srmd", "edsrmd", "sftmd"):
        get_model(name)(device="cpu", scale=2)
    RealESRGANBlur(request_pca_kernels=True, load_pca_matrix="standard")
    RealESRGANNoise(request_noise_image_pca=True, load_pca_matrix="standard")


def test_metadata_models_raise_without_cuda(monkeypatch):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in METADATA_MODELS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model(name)()


def test_pca_encoding_reads_nothing_back():
    """The PCA encoder runs inside the chain of a train step."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / "degradations" / "pca.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "PCAEncoder")
    call = next(n for n in cls.body if getattr(n, "name", "") == "__call__")
    bad = [n.lineno for n in ast.walk(call) if isinstance(n, ast.Call)
           and isinstance(n.func, ast.Attribute) and n.func.attr in SYNCING_CALLS]
    assert not bad, bad


def test_chip_smoke_drives_the_metadata_phases():
    """chip_smoke.py keeps its earlier phases and drives the three of the
    metadata slice from main()."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    for phase in ("meta_attention", "bobw_family", "metadata_maps", "bobw_joint",
                  "contrastive_train", "bobw_train", "degrade_train", "eval"):
        assert f"{phase}_phase" in called, phase
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("meta_attention", "bobw_family", "metadata_maps"):
        assert f'"phase": "{phase}"' in text, phase


def test_chip_smoke_holds_every_launched_shape():
    """chip_smoke.py records each RCAB kernel launch's shape, dtype and form
    and fails on one that no comparison held; and its comparisons cover,
    in both forms, every shape that eval_sisr (one image a forward) and
    validation (chunks of up to eight a shape) launch on its eval pairs."""
    import collections
    import importlib.util
    import torch
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"record_launches", "launch_coverage_phase"} <= called
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = set()
    for (h, w), k in collections.Counter(smoke.EVAL_LR_SHAPES).items():
        want.add((1, h, w, 64))
        want.update((len(range(i, min(i + 8, k))), h, w, 64) for i in range(0, k, 8))
    assert want <= set(smoke.EXTRA_SHAPES)
    assert want <= {s for s, dt in smoke.QRCAB_SHAPES if dt == torch.bfloat16}
