"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process for ``sm_90a``, all started
together; one link step makes a shared library with a plain C interface, which
is loaded with ``ctypes``.  The build happens at first use, into ``_build/``
beside the package (git-ignored), named by a hash of the sources so an edited
source is rebuilt.  A build failure raises; nothing falls back.

Every C entry point takes device pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_ulonglong
# C entry points: name -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "decode_mla_launch": [_P] * 9 + [_I] * 7 + [_F, _I, _F, _P],
    "mla_prefill_launch": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    "mla_prefill_sparse_launch": [_P] * 9 + [_I] * 11 + [_F, _I, _P],
    "lightning_indexer_prefill_launch": [_P] * 7 + [_I] * 10 + [_P],
    "gmm1_ring_launch": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _I, _P, _P],
    "gmm2_combine_ring_launch": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _P, _P, _P],
    "quant_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "quant_per_token_launch": [_P] + [_I] * 8 + [_P, _P, _P],
    "swiglu_quant_launch": [_P, _I, _I, _I, _P] + [_I] * 6 + [_P, _P, _P],
    "grouped_matmul_int8_launch": [_P] * 4 + [_I] * 8 + [_P] * 3 + [_I, _I] + [_P] * 7,
    "grouped_matmul_bf16_launch": [_P] * 4 + [_I] * 6 + [_P, _I, _I, _P, _P, _P, _P],
    "grouped_matmul_combine_launch": [_P] * 3 + [_I] * 4 + [_P] * 4 + [_I, _I] + [_P] * 4,
    "rms_norm_launch": [_P, _P, _P, _I, _I, _I, _I, _F] + [_I] * 5 + [_P],
    "add_rms_norm_launch": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    "l1_norm_launch": [_P, _P, _I, _I, _I] + [_I] * 5 + [_P],
    "swiglu_oai_launch": [_P, _P, _I, _I, _I, _F, _F, _P],
    "sinks_decode_launch": [_P] * 4 + [_I, _P, _F, _I, _P, _F, _I] + [_P] * 6 + [_I] * 11
                           + [_F, _P],
    "sinks_prefill_launch": [_P] * 4 + [_I, _P, _F, _I, _P, _F, _I] + [_P] * 4 + [_I] * 12
                            + [_F, _P],
    "lora_shrink_launch": [_P] * 6 + [_F] + [_I] * 7 + [_P, _P, _P],
    "lora_expand_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "mla_train_fwd_launch": [_P] * 6 + [_I] * 3 + [_F, _P],
    "mla_train_bwd_dq_launch": [_P] * 9 + [_I] * 3 + [_F, _P],
    "mla_train_bwd_dk_launch": [_P] * 10 + [_I] * 4 + [_F, _P],
    "window_alloc": [_L, _P],
    "window_free": [_P],
    "window_ipc_handle": [_P, _P],
    "window_ipc_open": [_P, _P],
    "window_ipc_close": [_P],
    "a2a_launch": [_P, _I, _I, _U, _L, _P, _L, _L, _I, _L, _P, _P, _P, _P, _I, _L, _I, _I,
                   _P],
    "fused_full_launch": [_P, _P],
    "fused_full_blocks": [],
    "fused_kernel_launch": [_P, _P],
    "empty_launch": [_P],
}

_lib = None
_lock = threading.Lock()
build_seconds: float | None = None   # wall time of this process's build, if it built


def _sources() -> list[pathlib.Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the kernels "
                           "need nvcc to build")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def _build(target: pathlib.Path) -> None:
    import time

    t0 = time.perf_counter()
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-I", str(_SRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp_so = work / target.name
    # the shared CUDA runtime: the one PyTorch has loaded serves the kernels'
    # launches too, so torch.profiler's CUPTI tracing sees them as it sees
    # PyTorch's (with a static runtime in the library it at times recorded none)
    link = subprocess.run(
        [nvcc, *_NVCC_FLAGS, "-shared", "-cudart", "shared", *[str(o) for _, o, _ in procs],
         "-o", str(tmp_so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp_so, target)   # atomic: concurrent builders never see half a file
    shutil.rmtree(work)
    global build_seconds
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from the checkout's sources if the
    build directory does not hold it yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for src in sorted(_SRC_DIR.glob("*.cu*")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        target = _BUILD_DIR / f"libsgl_kernels_{h.hexdigest()[:16]}.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sgl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.sgl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
