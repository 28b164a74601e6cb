"""The ctypes signatures of ``utils/cuda_lib.py`` against the C entry points
of ``csrc/``: every name in ``_SIGNATURES`` is an ``extern "C" int``
function of one source, with as many parameters, each of the kind its
ctypes type passes (a pointer as ``c_void_p``, ``int``, ``float``, ``long
long``, ``unsigned long long``).  A mismatch would fail only on the card, at
load time or as a wrong argument."""

import ctypes
import re

import pytest

from sgl_kernel_npu_tpu_torch.utils import cuda_lib

_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
          "unsigned long long": ctypes.c_ulonglong}


def _entry_points() -> dict:
    """name → the parameter list's text of each ``extern "C" int`` function."""
    out = {}
    for src in sorted(cuda_lib._SRC_DIR.glob("*.cu*")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            assert m.group(1) not in out, f"{m.group(1)} defined twice"
            out[m.group(1)] = m.group(2)
    return out


def _kind(param: str):
    """The ctypes type a C parameter takes."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const ", "").split()[:-1]              # drop the name
    return _KINDS[" ".join(words)]


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_signature_matches_entry_point(name):
    params = _entry_points().get(name)
    assert params is not None, f"{name} is no extern \"C\" int function of csrc/"
    kinds = [_kind(p.strip()) for p in params.split(",") if p.strip()]
    assert kinds == cuda_lib._SIGNATURES[name], name
