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
    PIL, pandas, click, msgpack, matplotlib or triton when a module is
    imported (PIL is imported inside the function that opens an image
    file)."""
    absent = ("PIL", "pandas", "click", "msgpack", "matplotlib", "triton")
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
