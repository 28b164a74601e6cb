"""Port boundaries: the port imports nothing of JAX or of the JAX package, and
its entry points refuse to run quietly on the CPU when no GPU is present."""

import ast
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
