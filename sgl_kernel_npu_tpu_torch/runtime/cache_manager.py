"""ctypes binding of the native radix cache manager (the port's own
``sgl_kernel_npu_tpu_torch/csrc/cache_manager.cpp``: host C++).

Counterpart of ``sgl_kernel_npu_tpu/runtime/cache_manager.py``: prefix-cache
matching, page allocation with LRU eviction, refcounted sharing.  The port
compiles its copy of the source with ``g++`` into its own git-ignored
``_build/`` directory at first use, and reads no file outside its package.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "cache_manager.cpp"
_LIB_DIR = pathlib.Path(__file__).resolve().parent / "_build"
_LIB = _LIB_DIR / "libcache_manager.so"

_lib = None
_lock = threading.Lock()


def _build() -> None:
    _LIB_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_LIB_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
                       check=True)
        os.replace(tmp, _LIB)   # atomic: concurrent builders never load half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.cm_create.restype = ctypes.c_void_p
        lib.cm_create.argtypes = [ctypes.c_int64, ctypes.c_int32]
        lib.cm_destroy.restype = None
        lib.cm_destroy.argtypes = [ctypes.c_void_p]
        lib.cm_free_count.restype = ctypes.c_int64
        lib.cm_free_count.argtypes = [ctypes.c_void_p]
        lib.cm_cached_count.restype = ctypes.c_int64
        lib.cm_cached_count.argtypes = [ctypes.c_void_p]
        lib.cm_match.restype = ctypes.c_int64
        lib.cm_match.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.cm_insert.restype = ctypes.c_int64
        lib.cm_insert.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                                  ctypes.c_int32, i32p]
        lib.cm_release.restype = None
        lib.cm_release.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
        lib.cm_alloc.restype = ctypes.c_int64
        lib.cm_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32p]
        lib.cm_free.restype = None
        lib.cm_free.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
        _lib = lib
        return lib


def _i32(a):
    arr = np.ascontiguousarray(a, dtype=np.int32)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class RadixCacheManager:
    """Refcounted radix prefix cache over physical KV pages."""

    def __init__(self, num_pages: int, page_size: int):
        self._lib = _load()
        self._h = self._lib.cm_create(num_pages, page_size)
        self.page_size = page_size
        self.num_pages = num_pages

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cm_destroy(self._h)
            self._h = None

    @property
    def free_pages(self) -> int:
        return self._lib.cm_free_count(self._h)

    @property
    def cached_pages(self) -> int:
        return self._lib.cm_cached_count(self._h)

    def match(self, tokens) -> tuple[int, np.ndarray]:
        """Longest cached prefix → (matched token count, page ids).  Matched
        pages' refcounts are bumped: pair with :meth:`release`."""
        toks, tp = _i32(tokens)
        cap = len(toks) // self.page_size
        out, op = _i32(np.empty(max(cap, 1), np.int32))
        matched = self._lib.cm_match(self._h, tp, len(toks), op, cap)
        return int(matched), out[: matched // self.page_size].copy()

    def insert(self, tokens, pages, ref: int = 1) -> tuple[int, np.ndarray]:
        """Cache the full-page chunks of ``tokens`` backed by ``pages`` →
        (inserted count, duplicate pages the caller should free)."""
        toks, tp = _i32(tokens)
        pg, pp = _i32(pages)
        dup, dp = _i32(np.empty(max(len(pg), 1), np.int32))
        packed = self._lib.cm_insert(self._h, tp, len(toks), pp, len(pg), ref, dp)
        inserted, ndup = packed >> 32, packed & 0xFFFFFFFF
        return int(inserted), dup[:ndup].copy()

    def release(self, tokens) -> None:
        toks, tp = _i32(tokens)
        self._lib.cm_release(self._h, tp, len(toks))

    def alloc(self, count: int) -> np.ndarray:
        out, op = _i32(np.empty(max(count, 1), np.int32))
        got = self._lib.cm_alloc(self._h, count, op)
        return out[:got].copy()

    def free(self, pages) -> None:
        pg, pp = _i32(pages)
        self._lib.cm_free(self._h, pp, len(pg))
