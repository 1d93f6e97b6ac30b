"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import ast
import os
import pathlib

import numpy as np
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
    PIL, pandas, click, msgpack, matplotlib, triton, scikit-learn, umap,
    OpenCV or aim when a module is imported (PIL is imported inside the
    function that opens an image file, cv2 inside the face tools that use
    it, aim inside the trainer that tracks to it)."""
    absent = ("PIL", "pandas", "click", "msgpack", "matplotlib", "triton", "sklearn", "umap",
              "cv2", "aim")
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


# The ops' host path (offline datagen on one image at a time) hands its
# results back to the host by design; it is these functions alone, by
# module and qualified name (a method as Class.method).
HOST_PATH_FUNCTIONS = {
    "degradations/base.py": ("host_metadata", "DegradationOp.__call__"),
    "degradations/blur.py": ("_BlurBase.__call__",),
    "degradations/resize_ops.py": ("_pil_resize_np", "Downsample.__call__",
                                   "Upsample.__call__"),
    "degradations/noise.py": ("RealESRGANNoise.__call__",),
    "degradations/compression.py": ("_h264_approximation", "JPEGCompress.__call__",
                                    "JMCompress.__call__", "RandomCompress.__call__",
                                    "FFMPEGCompress.__call__"),
    "degradations/pipeline.py": ("ImagePipeline.run_pipeline", "ImagePipeline._write_csvs"),
}


def _functions_by_qualified_name(tree):
    """{"Class.method" or "function": its FunctionDef} of a module's top
    level and its classes."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{f.name}": f for f in node.body
                        if isinstance(f, ast.FunctionDef)})
    return out


@pytest.mark.parametrize("module", DEGRADATION_MODULES)
def test_degradation_device_paths_read_nothing_back(module):
    """The chain runs inside every train step: none of its modules calls
    what would stall the card's queue outside the host path's functions,
    and no device path calls one of those (chip_smoke.py checks one
    degrade_batch under torch.cuda.set_sync_debug_mode("error") as well)."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / module).read_text())
    functions = _functions_by_qualified_name(tree)
    listed = HOST_PATH_FUNCTIONS.get(module, ())
    assert not [q for q in listed if q not in functions], listed
    host = {id(n) for q in listed for n in ast.walk(functions[q])}
    bad = [f"{module}:{n.lineno} .{n.func.attr}()" for n in ast.walk(tree)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in SYNCING_CALLS and id(n) not in host]
    host_names = {q.split(".")[-1] for qs in HOST_PATH_FUNCTIONS.values() for q in qs}
    device_fns = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                  and f.name in ("batch_apply", "_batch_apply_noise", "degrade_batch",
                                 "metadata_matrix", "_apply", "_kernels", "_draw")]
    bad += [f"{module}:{n.lineno} {f.name} calls {ast.unparse(n.func)}" for f in device_fns
            for n in ast.walk(f) if isinstance(n, ast.Call)
            and ast.unparse(n.func).split(".")[-1] in host_names]
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


ITERATIVE_MODULES = ("models/dan.py", "models/ikc.py", "models/dasr.py")
ITERATIVE_MODELS = {"dan": dict(init_ker_map=(0.0,) * 10), "ikc": {}, "dasr": {}, "dcls": {}}


def test_port_covers_the_iterative_blind_sr_modules():
    """The iterative blind-SR slice's modules are in the package (so the
    import scans above read them, neither jax nor rumpy_tpu among their
    imports), the registry finds dan, ikc, dasr and dcls, and
    danv1qrealesrgan, which raised naming item 9 until the GAN group came,
    builds and runs."""
    from rumpy_tpu_torch.registry import available_models, get_model
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in ITERATIVE_MODULES if m not in names]
    assert not missing, missing
    for m in ITERATIVE_MODULES:
        bad = [mod for mod, _ in _imported_roots(ROOT / "rumpy_tpu_torch" / m) if mod in FORBIDDEN]
        assert not bad, (m, bad)
    assert set(ITERATIVE_MODELS) | {"danv1qrealesrgan"} <= set(available_models())
    _builds_and_runs("danv1qrealesrgan")


@pytest.mark.parametrize("name", list(ITERATIVE_MODELS))
def test_iterative_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**ITERATIVE_MODELS[name])


def test_chip_smoke_drives_the_iterative_phases_and_gates_the_sums():
    """chip_smoke.py drives the slice's three phases from main(), and
    rcab_bwd_f32_sums fails where the bf16 backward stands more than its
    factor off the plain version's error."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = {n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    for phase in ("dan_train", "ikc_train", "dasr_train", "rcab_bwd_f32_sums", "rcab_bwd_c128"):
        assert f"{phase}_phase" in called, phase
    sums = fns["rcab_bwd_f32_sums_phase"]
    raises = [n for n in ast.walk(sums) if isinstance(n, ast.Raise)]
    assert raises, "rcab_bwd_f32_sums_phase has no gate"
    names = {n.id for n in ast.walk(sums) if isinstance(n, ast.Name)}
    assert "F32_FACTOR" in names


GENERATOR_MODULES = ("models/han_elan.py", "models/san.py", "ops/tiling.py")
GENERATOR_MODELS = {"han": {}, "elan": {}, "qhan": {}, "qelan": {}, "san": {}, "qsan": {},
                    "contrastiveblindqhan": {"block_encoder_loading": True},
                    "contrastiveblindqelan": {"block_encoder_loading": True},
                    "contrastiveblindqsan": {"block_encoder_loading": True}}
GAN_MODULES = ("models/gan_models.py", "models/feature_extractors.py", "models/metabed.py")
# tiny widths for the build-and-run checks
GAN_MODELS = {"esrgan": dict(nf=8, nb=1, gc=4, d_nf=4), "bsrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
              "realesrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
              "qrealesrgan": dict(nf=8, nb=1, gc=4, d_nf=4),
              "metabed": dict(num_features=8, num_blocks=2, meta_block="q-layer"),
              "metabedesrgan": dict(num_features=8, num_blocks=2, d_nf=4),
              "danv1qrealesrgan": dict(nf=8, nb=1, gc=4, d_nf=4, loop=2,
                                       init_ker_map=(0.0,) * 10),
              "contrastiveblindqrealesrgan": dict(nf=8, nb=1, gc=4, block_encoder_loading=True),
              "contrastiveblindmetabed": dict(num_features=8, block_encoder_loading=True)}
FACE_MODULES = ("models/face_models.py", "data/datasets.py", "data/loader.py",
                "data/metadata.py", "training/trainer.py")
# tiny widths for the build checks
FACE_MODELS = {"sparnet": dict(min_ch=8, max_ch=16, in_size=32, out_size=32, res_depth=1),
               "qsparnet": dict(metadata=["all"], min_ch=8, max_ch=16, in_size=32, out_size=32,
                                res_depth=1),
               "rcansplitceleb": dict(n_feats=16, n_resgroups=1, n_resblocks=1, reduction=4),
               "facegan": dict(latent_dim=8, nf=8)}
SLICE16_MODULES = ("models/basic.py", "models/swinir.py", "models/regressors.py",
                   "utils/lpips.py", "training/regression_trainer.py")
# tiny widths for the build-and-run checks
SLICE16_MODELS = {"srcnn": {}, "vdsr": {},
                  "swinir": dict(embed_dim=8, depths=(2,), num_heads=(2,), num_feat=8),
                  "basicnn": dict(output_size=3), "resnet": dict(output_size=3, width=8),
                  "densenet": dict(output_size=3, block_config=(1, 1), growth_rate=4,
                                   init_features=8),
                  "efficientnet": dict(output_size=3, width_mult=0.25, depth_mult=0.25),
                  "manet": dict(kernel_size=3, nc=(8, 16))}
SLICE17_MODULES = ("models/dic.py", "models/wavelet.py", "models/fssr.py",
                   "models/face_attribute_gans.py")
SLICE17_MODELS = {
    "dic": dict(num_steps=2, num_features=8, num_groups=2, hg_num_feature=16, num_fusion_block=1),
    "dicnet": dict(nf=8, iterations=1, num_groups=1, hg_num_feature=16, num_fusion_block=1),
    "waveletsrnet": dict(num_layers_res=1, wavelet_c=2),
    "waveletnet": dict(num_layers_res=1, wavelet_c=2),
    "waveletsrgan": dict(num_layers_res=1, wavelet_c=2, include_id_loss=False),
    "esrganfs": dict(nf=8, nb=1, gc=4, d_nf=4), "fssr": dict(nf=8, nb=1, gc=4, d_nf=4),
    "fssrdsgan": dict(n_res_blocks=1, use_perceptual_loss=False)}
# the attribute-conditioned GANs at tiny widths, 8 attributes
SLICE20_MODELS = {"facesrattributesgan": dict(n_feats=4, metadata_bypass_len=8),
                  "agagan": dict(n_feats=4, metadata_bypass_len=8),
                  "fmfnet": dict(n_feats=4, metadata_bypass_len=8)}
# every name the port registers that builds: all 59 of the JAX package's
BUILDING_MODELS = ("edsr", "rcan", "qrcan", "qedsr", "contrastiveblindqrcan",
                   "contrastiveblindqedsr", "srmd", "edsrmd", "sftmd", "moco", "supmoco",
                   "weakcon", "supcon", "degradationregressor", "dan", "ikc", "dasr",
                   "dcls") + tuple(GENERATOR_MODELS) + tuple(GAN_MODELS) + tuple(FACE_MODELS) \
    + tuple(SLICE16_MODELS) + tuple(SLICE17_MODELS) + tuple(SLICE20_MODELS)


def _builds_and_runs(name):
    """``name`` builds on the CPU at a tiny width and super-resolves a
    4 x 4 input (with one metadata value where it takes metadata) to a
    finite x4 image."""
    from rumpy_tpu_torch.registry import get_model
    handler = get_model(name)(device="cpu", **GAN_MODELS[name])
    state = handler.init_state()
    batch = {"lr": np.full((1, 4, 4, 3), 0.5, np.float32)}
    if getattr(handler, "uses_metadata", False):
        batch["metadata"] = np.full((1, getattr(handler, "num_metadata", 10)), 0.5, np.float32)
    out = handler.run_eval(state, batch)
    assert tuple(out.shape) == (1, 16, 16, 3) and bool(torch.isfinite(out).all())


def test_port_covers_the_bobw_generator_families():
    """The HAN, ELAN, SAN and GAN-group modules are in the package (so the
    import scans above read them, neither jax nor rumpy_tpu among their
    imports) and the registry finds 59 names that build (the face group's
    four, slice 16's eight, slice 17's eight and slice 20's three among them); the three that
    raised naming item 9 until gan_models and metabed came build and run."""
    from rumpy_tpu_torch.registry import available_models
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    missing = [m for m in GENERATOR_MODULES + GAN_MODULES if m not in names]
    assert not missing, missing
    for m in GENERATOR_MODULES + GAN_MODULES:
        bad = [mod for mod, _ in _imported_roots(ROOT / "rumpy_tpu_torch" / m) if mod in FORBIDDEN]
        assert not bad, (m, bad)
    registered = set(available_models())
    assert len(BUILDING_MODELS) == 59 and registered == set(BUILDING_MODELS)
    for name in ("contrastiveblindqrealesrgan", "contrastiveblindmetabed"):
        _builds_and_runs(name)


@pytest.mark.parametrize("name", list(GAN_MODELS))
def test_gan_group_models_build_and_run(name):
    _builds_and_runs(name)


@pytest.mark.parametrize("name", list(GAN_MODELS))
def test_gan_group_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**GAN_MODELS[name])


@pytest.mark.parametrize("name", list(GENERATOR_MODELS))
def test_generator_family_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**GENERATOR_MODELS[name])


def test_chip_smoke_drives_the_generator_family_phases():
    """chip_smoke.py drives the slice's four phases from main() and keeps
    the earlier ones."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    for phase in ("han_train", "bobw_qhan", "elan_train", "san_train", "dan_train",
                  "bobw_train", "degrade_train", "launch_coverage"):
        assert f"{phase}_phase" in called, phase
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("han_train", "bobw_qhan", "elan_train", "san_train"):
        assert f'"phase": "{phase}"' in text, phase


def test_chip_smoke_drives_the_gan_group_phases():
    """chip_smoke.py drives the GAN group's four phases from main(), after
    the earlier ones, and prints a row for each."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    for phase in ("realesrgan_train", "bobw_qrealesrgan", "gan_family", "metabed", "han_train",
                  "bobw_qhan", "dan_train", "launch_coverage"):
        assert f"{phase}_phase" in called, phase
    assert called.index("realesrgan_train_phase") > called.index("bobw_qhan_phase")
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("realesrgan_train", "bobw_qrealesrgan", "gan_family", "metabed"):
        assert f'"phase": "{phase}"' in text, phase


def test_port_covers_the_face_group():
    """The face slice's modules are in the package and import neither jax,
    rumpy_tpu, pandas nor PIL at module level (the CelebA, blacklist and
    patch readers use the stdlib); the registry finds sparnet, qsparnet,
    rcansplitceleb and facegan, and each builds and runs on the CPU."""
    from rumpy_tpu_torch.registry import available_models, get_model
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    assert not [m for m in FACE_MODULES if m not in names]
    for m in FACE_MODULES:
        path = ROOT / "rumpy_tpu_torch" / m
        bad = [mod for mod, _ in _imported_roots(path) if mod in FORBIDDEN + ("pandas",)]
        top = [mod for node in ast.parse(path.read_text()).body
               if isinstance(node, (ast.Import, ast.ImportFrom))
               for mod, _ in _imported_roots_of(node)]
        assert not bad and not {"PIL", "pandas"} & set(top), (m, bad, top)
    assert set(FACE_MODELS) <= set(available_models())
    for name, kw in FACE_MODELS.items():
        handler = get_model(name)(device="cpu", **kw)
        assert handler.module is not None


def _imported_roots_of(node):
    if isinstance(node, ast.Import):
        return [(a.name.split(".")[0], node.lineno) for a in node.names]
    return [((node.module or "").split(".")[0], node.lineno)] if node.level == 0 else []


@pytest.mark.parametrize("name", list(FACE_MODELS))
def test_face_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**FACE_MODELS[name])


def test_rcansplitceleb_step_reads_nothing_back():
    """RCANSplitCeleb's gate, losses and update hook stay on the device: no
    call in them waits for the card, and neither does the base step's
    update hook (chip_smoke.py runs its step under sync debug "error")."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / "models" / "face_models.py").read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "RCANSplitCelebHandler")
    fns = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
    assert {"_gate", "apply", "compute_losses", "transform_updates"} <= {f.name for f in fns}
    base = ast.parse((ROOT / "rumpy_tpu_torch" / "models" / "base.py").read_text())
    fns += [n for n in ast.walk(base) if isinstance(n, ast.FunctionDef) and n.name == "_optimize"]
    bad = [f"{f.name}:{n.lineno} .{n.func.attr}()" for f in fns for n in ast.walk(f)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in SYNCING_CALLS]
    casts = [f"{f.name}:{n.lineno} {n.func.id}()" for f in fns for n in ast.walk(f)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id in ("float", "bool") and f.name != "_optimize"]
    assert not bad and not casts, bad + casts


def test_chip_smoke_drives_the_face_phases():
    """chip_smoke.py drives the face slice's four phases from main(), after
    the earlier ones, and prints a row for each."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    for phase in ("face_data", "rcansplit_train", "sparnet_train", "facegan_train",
                  "realesrgan_train", "han_train", "launch_coverage"):
        assert f"{phase}_phase" in called, phase
    assert called.index("face_data_phase") > called.index("metabed_phase")
    assert called.index("launch_coverage_phase") > called.index("rcansplit_train_phase")
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("face_data", "rcansplit_train", "sparnet_train", "facegan_train"):
        assert f'"phase": "{phase}"' in text, phase


def test_port_covers_slice_16():
    """SwinIR, SRCNN/VDSR, LPIPS and the regressors are in the package and
    import neither jax nor rumpy_tpu; the registry finds the slice's eight
    names, and each builds on the CPU at a tiny width and runs on a 32 x 32
    input: SwinIR super-resolves it x4, SRCNN and VDSR (whose input is
    interpolated beforehand) keep its size, a regressor predicts its
    outputs, MANet spreads its kernel map x4."""
    from rumpy_tpu_torch.registry import available_models, get_model
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    assert not [m for m in SLICE16_MODULES if m not in names]
    for m in SLICE16_MODULES:
        bad = [mod for mod, _ in _imported_roots(ROOT / "rumpy_tpu_torch" / m) if mod in FORBIDDEN]
        assert not bad, (m, bad)
    assert set(SLICE16_MODELS) <= set(available_models())
    for name, kw in SLICE16_MODELS.items():
        handler = get_model(name)(device="cpu", **kw)
        c = handler.in_features
        out = handler.run_eval(handler.init_state(), {"lr": np.full((1, 32, 32, c), 0.5, np.float32)})
        want = {"basicnn": (1, 3), "resnet": (1, 3), "densenet": (1, 3), "efficientnet": (1, 3),
                "manet": (1, 128, 128, 9), "srcnn": (1, 32, 32, 1),
                "vdsr": (1, 32, 32, 1)}.get(name, (1, 128, 128, c))
        assert tuple(out.shape) == want and bool(torch.isfinite(out).all()), name


@pytest.mark.parametrize("name", list(SLICE16_MODELS))
def test_slice_16_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**SLICE16_MODELS[name])


def test_chip_smoke_drives_the_slice_16_phases():
    """chip_smoke.py drives the slice's three phases from main(), after the
    face group's, each printing its row and failing on an RCAB launch; the
    kernels line keeps its four entries."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = [n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    for phase in ("swinir_train", "basic_train", "regressor_train", "facegan_train",
                  "rcansplit_train", "launch_coverage"):
        assert f"{phase}_phase" in called, phase
    assert called.index("swinir_train_phase") > called.index("facegan_train_phase")
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("swinir_train", "basic_train", "regressor_train"):
        assert f'"phase": "{phase}"' in text, phase
        body = {n.func.id for n in ast.walk(fns[f"{phase}_phase"])
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        assert {"no_rcab", "step_without_sync"} <= body, phase
    kernels = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)]
    assert len(kernels) == 1 and len(kernels[0].value.elts) == 4


def test_port_covers_slice_17():
    """DIC, the wavelet family, the FSSR family and the two layers they take
    from face_attribute_gans are in the package and import neither jax nor
    rumpy_tpu; the registry finds the slice's eight names, and each builds on
    the CPU at a tiny width and runs on a 16 x 16 input: x4, or its own size
    for the scale-1 DSGAN."""
    from rumpy_tpu_torch.registry import available_models, get_model
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    assert not [m for m in SLICE17_MODULES if m not in names]
    for m in SLICE17_MODULES:
        bad = [mod for mod, _ in _imported_roots(ROOT / "rumpy_tpu_torch" / m) if mod in FORBIDDEN]
        assert not bad, (m, bad)
    assert set(SLICE17_MODELS) <= set(available_models())
    for name, kw in SLICE17_MODELS.items():
        handler = get_model(name)(device="cpu", **kw)
        out = handler.run_eval(handler.init_state(), {"lr": np.full((1, 16, 16, 3), 0.5,
                                                                    np.float32)})
        want = (1, 16, 16, 3) if name == "fssrdsgan" else (1, 64, 64, 3)
        assert tuple(out.shape) == want and bool(torch.isfinite(out).all()), name


@pytest.mark.parametrize("name", list(SLICE17_MODELS))
def test_slice_17_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**SLICE17_MODELS[name])


def test_slice_17_steps_read_nothing_back():
    """The slice's train steps and hooks call nothing that waits for the
    card (chip_smoke.py runs a step of each under sync debug "error"); DIC's
    landmarks go up through ``to_device``, its hourglass gate reads the
    handler's own step count."""
    calls = []
    for m, cls_names in (("models/dic.py", ("DICHandler",)),
                         ("models/wavelet.py", ("WaveletSRNetHandler", "WaveletSRGANHandler")),
                         ("models/fssr.py", ("FSSRDSGANHandler",))):
        tree = ast.parse((ROOT / "rumpy_tpu_torch" / m).read_text())
        for cls in (n for n in tree.body if isinstance(n, ast.ClassDef) and n.name in cls_names):
            fns = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
            calls += [f"{cls.name}.{f.name}:{n.lineno} .{n.func.attr}()" for f in fns
                      for n in ast.walk(f) if isinstance(n, ast.Call)
                      and isinstance(n.func, ast.Attribute) and n.func.attr in SYNCING_CALLS]
    assert not calls, calls


def test_chip_smoke_drives_the_slice_17_phases():
    """chip_smoke.py drives the slice's three phases from main(), after the
    regressors, each printing its row, failing on an RCAB launch and taking
    a step under sync debug "error"; the kernels line keeps its four
    entries."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = [n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    for phase in ("dic_train", "wavelet_train", "fssr_train", "regressor_train",
                  "launch_coverage"):
        assert f"{phase}_phase" in called, phase
    assert called.index("dic_train_phase") > called.index("regressor_train_phase")
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in ("dic_train", "wavelet_train", "fssr_train"):
        assert f'"phase": "{phase}"' in text, phase
        body = {n.func.id for n in ast.walk(fns[f"{phase}_phase"])
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        assert {"no_rcab", "step_without_sync"} <= body, phase
    kernels = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)]
    assert len(kernels) == 1 and len(kernels[0].value.elts) == 4


TOOLS_MODULES = ("native.py", "degradations/base.py", "degradations/pipeline.py",
                 "cli/image_manipulate.py", "cli/face_cli.py", "utils/face_segmentation.py",
                 "utils/face_tools.py", "utils/face_recognition.py", "utils/metrics.py",
                 "evaluation/eval_hub.py", "cli/eval_sisr.py", "utils/csv_text.py")


def test_port_covers_the_tools():
    """Offline degradation, the native codec's binding, the face tools and
    face recognition are in the package and import neither jax nor
    rumpy_tpu."""
    names = {str(p.relative_to(ROOT / "rumpy_tpu_torch")) for p in _port_files()[:-1]}
    assert not [m for m in TOOLS_MODULES if m not in names]
    for m in TOOLS_MODULES:
        bad = [mod for mod, _ in _imported_roots(ROOT / "rumpy_tpu_torch" / m) if mod in FORBIDDEN]
        assert not bad, (m, bad)


def test_tools_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from rumpy_tpu_torch.cli import face_cli
    from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
    from rumpy_tpu_torch.utils.face_recognition import FaceRecognizer
    from rumpy_tpu_torch.utils.face_segmentation import BiSeNetSegmenter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: ImagePipeline(["jpegcompress"]).run_pipeline(
                 images=[np.zeros((8, 8, 3), np.uint8)], progress_bar_off=True),
             lambda: BiSeNetSegmenter(str(tmp_path / "w.npz")),
             lambda: face_cli.face_segment(["-i", str(tmp_path), "-o", str(tmp_path / "o"),
                                            "--weights", str(tmp_path / "w.npz")]),
             lambda: FaceRecognizer(lambda x: x.mean((1, 2)))._extract(
                 np.zeros((1, 4, 4, 3), np.float32))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_native_build_writes_only_under_the_package_build_dir(monkeypatch):
    """The port builds native/rumpy_native.cpp into rumpy_tpu_torch/build/
    and writes nothing under native/: the compiler's output path, and the
    folder's listing before and after a build and a call."""
    import subprocess

    from rumpy_tpu_torch import native
    build = ROOT / "rumpy_tpu_torch" / "build"
    assert pathlib.Path(native.SO).parent == build == pathlib.Path(native.BUILD_DIR)
    assert pathlib.Path(native.SRC) == ROOT / "native" / "rumpy_native.cpp"
    seen = []

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        raise subprocess.CalledProcessError(1, cmd, stderr=b"")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.os.path, "isfile",
                        lambda p: p != native.SO and os.path.exists(p))
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+"):
        native.h264_intra(np.zeros((8, 8, 3), np.uint8), 30)
    out = pathlib.Path(seen[0][seen[0].index("-o") + 1])
    assert seen[0][0] == "g++" and out.parent == build and native.SRC in seen[0]
    monkeypatch.undo()
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (ROOT / "native").iterdir())
    monkeypatch.setattr(native, "_lib", None)
    native.h264_intra(np.zeros((8, 8, 3), np.uint8), 30)
    assert sorted((p.name, p.stat().st_mtime_ns) for p in (ROOT / "native").iterdir()) == before
    assert pathlib.Path(native.SO).is_file()


def test_chip_smoke_drives_the_tools_phases():
    """chip_smoke.py drives the slice's three phases from main(), after the
    FSSR family, each printing its row and failing on an RCAB launch; the
    kernels line keeps its four entries."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = [n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    phases = ("offline_degrade", "face_segment", "fr_eval")
    for phase in phases:
        assert f"{phase}_phase" in called, phase
        assert called.index(f"{phase}_phase") > called.index("fssr_train_phase")
    text = (ROOT / "chip_smoke.py").read_text()
    for phase in phases:
        assert f'"phase": "{phase}"' in text, phase
        body = {n.func.id for n in ast.walk(fns[f"{phase}_phase"])
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        assert "no_rcab" in body, phase
    kernels = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)]
    assert len(kernels) == 1 and len(kernels[0].value.elts) == 4


def test_port_covers_slice_20():
    """FaceSR-Attributes-GAN, AGA-GAN and FMFNet are in the package, whose
    face_attribute_gans module imports neither jax nor rumpy_tpu; the
    registry finds the slice's three names, and each builds on the CPU at a
    tiny width and super-resolves a 16 x 16 input with 40 metadata values
    (the CelebA attributes, ``metadata=["all"]``) to a finite 128 x 128
    image."""
    from rumpy_tpu_torch.registry import available_models, get_model
    path = ROOT / "rumpy_tpu_torch" / "models" / "face_attribute_gans.py"
    assert path in _port_files()
    bad = [mod for mod, _ in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, bad
    assert set(SLICE20_MODELS) <= set(available_models())
    for name in SLICE20_MODELS:
        handler = get_model(name)(device="cpu", n_feats=4, metadata=["all"])
        assert handler.num_metadata == 40 and handler.scale == 8
        out = handler.run_eval(handler.init_state(), {
            "lr": np.full((1, 16, 16, 3), 0.5, np.float32),
            "metadata": np.ones((1, 40), np.float32)})
        assert tuple(out.shape) == (1, 128, 128, 3) and bool(torch.isfinite(out).all()), name


@pytest.mark.parametrize("name", list(SLICE20_MODELS))
def test_slice_20_models_raise_without_cuda(monkeypatch, name):
    from rumpy_tpu_torch.registry import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(**SLICE20_MODELS[name])


def test_slice_20_steps_read_nothing_back():
    """The attribute GAN handler's steps and forwards, and the STN's grid and
    sample, call nothing that waits for the card (chip_smoke.py runs a step
    of each handler under sync debug "error")."""
    tree = ast.parse((ROOT / "rumpy_tpu_torch" / "models" / "face_attribute_gans.py").read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("_linspace", "affine_grid", "grid_sample", "_dropout")]
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        fns += [n for n in cls.body if isinstance(n, ast.FunctionDef)
                and n.name not in ("init_weights", "_jax_state_dict")]
    calls = [f"{f.name}:{n.lineno} .{n.func.attr}()" for f in fns for n in ast.walk(f)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr in SYNCING_CALLS]
    assert len(fns) > 40 and not calls, calls


def test_chip_smoke_drives_the_slice_20_phase():
    """chip_smoke.py drives attribute_gan_train from main(), after the
    tools, printing its row, failing on an RCAB launch and taking a step
    under sync debug "error"; the kernels line keeps its four entries."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = [n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "attribute_gan_train_phase" in called
    assert called.index("attribute_gan_train_phase") > called.index("fr_eval_phase")
    assert '"phase": "attribute_gan_train"' in (ROOT / "chip_smoke.py").read_text()
    body = {n.func.id for n in ast.walk(fns["attribute_gan_train_phase"])
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"no_rcab", "step_without_sync"} <= body
    kernels = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)]
    assert len(kernels) == 1 and len(kernels[0].value.elts) == 4


def test_chip_smoke_drives_the_slice_21_phase():
    """chip_smoke.py drives trainer_resume from main(), after the attribute
    GANs and before launch_coverage: a run resumed through
    _load_jax_checkpoint from the trees that optax_state_tree builds, its
    step under sync debug "error", the trainer with profile_steps and the
    Aim gate; the kernels line keeps its four entries and counts the
    phase's launches."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    called = [n.func.id for n in ast.walk(fns["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert (called.index("attribute_gan_train_phase") < called.index("trainer_resume_phase")
            < called.index("launch_coverage_phase"))
    assert '"phase": "trainer_resume"' in text
    body = {getattr(n.func, "id", None) or getattr(n.func, "attr", None)
            for n in ast.walk(fns["trainer_resume_phase"]) if isinstance(n, ast.Call)}
    assert {"exported_run", "_load_jax_checkpoint", "step_without_sync", "moment_places",
            "trace_step_kernels", "TrainingHandler"} <= body
    assert "optax_state_tree" in {n.func.id for n in ast.walk(fns["exported_run"])
                                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert text.count("launches_trainer_resume_path") == 2
    assert text.count("launches_trainer_profiled_path") == 2
    kernels = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)]
    assert len(kernels) == 1 and len(kernels[0].value.elts) == 4


def test_resumed_optimizer_steps_stay_on_the_host_clock():
    """A resumed optimizer's ``step`` is a CPU scalar, as torch makes it for
    a non-fused optimizer (on the card it would be read back every
    update), and its moments take their parameter's device and layout."""
    from rumpy_tpu_torch.models.base import set_optax_moments
    p = torch.nn.Parameter(torch.randn(4, 3, 3, 3).contiguous(memory_format=torch.channels_last))
    opt = torch.optim.Adam([p])
    mu = torch.randn(4, 3, 3, 3)
    set_optax_moments(opt, {"mu": {"w": mu}, "nu": {"w": mu.abs()}}, {id(p): "w"}, 5, "state")
    st = opt.state[p]
    assert st["step"].device.type == "cpu" and st["step"].dtype == torch.float32
    assert float(st["step"]) == 5 and st["exp_avg"].stride() == p.stride()
    assert torch.equal(st["exp_avg"], mu) and torch.equal(st["exp_avg_sq"], mu.abs())
