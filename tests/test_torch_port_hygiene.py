"""Port boundaries: the port imports nothing of JAX or of the JAX package,
builds and loads nothing from outside its own package, and its entry points
refuse to run quietly on the CPU when no GPU is present."""

import ast
import importlib
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "sgl_kernel_npu_tpu")


def _port_files():
    files = sorted((REPO / "sgl_kernel_npu_tpu_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def _forbidden(name: str | None) -> bool:
    return name is not None and any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module):
                    bad.append((path, node.module))
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                if node.value in FORBIDDEN:          # importlib.import_module("jax")
                    bad.append((path, node.value))
    assert not bad, bad


def _climb(node) -> int | None:
    """How many directories ``node`` climbs from ``__file__``'s path:
    ``.parents[k]`` climbs k + 1, each ``.parent`` one; None if ``node`` is
    not such an expression."""
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "parents" and isinstance(node.slice, ast.Constant):
        inner = _climb(node.value.value)
        return None if inner is None else inner + node.slice.value + 1
    if isinstance(node, ast.Attribute) and node.attr == "parent":
        inner = _climb(node.value)
        return None if inner is None else inner + 1
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("resolve", "absolute"):
        return _climb(node.func.value)
    if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
            in ("Path", "PurePath") and node.args:
        return _climb(node.args[0])
    if isinstance(node, ast.Name) and node.id == "__file__":
        return 0
    return None


def test_port_builds_no_path_above_its_package():
    """No port module builds a filesystem path above its own package (as
    ``Path(__file__).parents[2] / "csrc"`` once reached the JAX package's
    sources), and no module-level path of a port module lies outside it.
    Strings that only cite a JAX file for the record are not paths."""
    pkg = REPO / "sgl_kernel_npu_tpu_torch"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        depth = len(path.relative_to(pkg).parts)     # climbs that still end inside the package
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            up = _climb(node)
            if up is not None and up > depth:
                bad.append((path.name, node.lineno, ast.unparse(node)))
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and ("../" in node.value or node.value == ".."):
                bad.append((path.name, node.lineno, node.value))
        name = ".".join(path.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for attr, value in vars(importlib.import_module(name)).items():
            if isinstance(value, pathlib.PurePath) and not pathlib.Path(value).is_relative_to(pkg):
                bad.append((name, attr, str(value)))
    assert not bad, bad


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
    from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, deepseek_adapter

    cfg = tm.DeepSeekV3Config(num_layers=1, vocab_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_kv_cache(cfg, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_weights(cfg, 0)
    params = tm.init_weights(cfg, 0, device="cpu")
    moe = tm.quantize_moe_weights(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepseek_adapter(cfg, params, moe_weights_q=moe)
    adapter = deepseek_adapter(cfg, params, moe_weights_q=moe, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(adapter, num_pages=8)
