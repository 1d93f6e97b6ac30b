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


def test_kernel_wrapper_never_falls_back_on_cuda_tensors():
    """A CUDA tensor goes to the kernel or raises: the plain version is
    reached only through the CPU device check."""
    from rumpy_tpu_torch.ops.cuda import rcab_fused
    src = ast.parse(pathlib.Path(rcab_fused.__file__).read_text())
    fn = next(n for n in src.body
              if isinstance(n, ast.FunctionDef) and n.name == "rcab_fused")
    tries = [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    assert not tries
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "rcab_reference"]
    assert len(calls) == 1
