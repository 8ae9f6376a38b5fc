"""ctypes binding for the repository's C++ vector index (``native/hnsw``) —
the counterpart of ``gpt2_image_captioning_tpu/retrieval/hnsw.py``, with the
same signatures:

- :class:`HNSWIndex`: approximate inner-product HNSW (M / ef_construction /
  ef_search, defaults 32 / 200 / 64, the reference's FAISS settings);
- :class:`FlatIPIndex`: the exact scan (FAISS ``IndexFlatIP``'s role).

Both support ``add`` / ``search`` / ``reconstruct`` / ``save`` / ``load``;
the index files are the library's own, so either package reads the other's.

The library is ``native/build/libhnsw.so`` (``make -C native``) or the file
named by ``$GIC_HNSW_LIB``.  Where neither exists, the first use compiles
``native/hnsw/hnsw.cpp`` with ``g++`` and the Makefile's flags into
``gpt2_image_captioning_tpu_torch/_build/`` (a few seconds), keyed by a hash
of the source and the flags, so a fresh checkout needs no build step.  The
index runs on the host's cores; nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "hnsw" / "hnsw.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")  # native/Makefile

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _prebuilt() -> str | None:
    for p in (REPO_DIR / "native" / "build" / "libhnsw.so", os.environ.get("GIC_HNSW_LIB", "")):
        if p and os.path.exists(p):
            return os.path.abspath(p)
    return None


def compile_library() -> Path:
    """``native/hnsw/hnsw.cpp`` compiled into :data:`BUILD_DIR` as
    ``hnsw-<hash>/libhnsw.so``, or the file already there; written to a
    temporary name and renamed, so processes building at once never load a
    partial file."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"hnsw-{key}" / "libhnsw.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.hnsw_create.restype = c.c_void_p
    lib.hnsw_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64]
    lib.hnsw_free.argtypes = [c.c_void_p]
    lib.hnsw_add.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    lib.hnsw_size.restype = c.c_int64
    lib.hnsw_size.argtypes = [c.c_void_p]
    lib.hnsw_set_ef.argtypes = [c.c_void_p, c.c_int]
    lib.hnsw_search.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_int64), c.c_int,
    ]
    lib.hnsw_reconstruct.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_float)]
    lib.hnsw_save.restype = c.c_int
    lib.hnsw_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.hnsw_load.restype = c.c_void_p
    lib.hnsw_load.argtypes = [c.c_char_p]
    lib.flat_create.restype = c.c_void_p
    lib.flat_create.argtypes = [c.c_int]
    lib.flat_free.argtypes = [c.c_void_p]
    lib.flat_add.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    lib.flat_size.restype = c.c_int64
    lib.flat_size.argtypes = [c.c_void_p]
    lib.flat_search.argtypes = lib.hnsw_search.argtypes
    lib.flat_reconstruct.argtypes = lib.hnsw_reconstruct.argtypes
    lib.flat_save.restype = c.c_int
    lib.flat_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.flat_load.restype = c.c_void_p
    lib.flat_load.argtypes = [c.c_char_p]


def lib() -> ctypes.CDLL:
    """The loaded library: the prebuilt one, else compiled at first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(_prebuilt() or str(compile_library()))
            _declare(loaded)
            _lib = loaded
    return _lib


def available() -> bool:
    """Whether the library loads (compiling it where it must)."""
    try:
        lib()
        return True
    except (OSError, RuntimeError):
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class _BaseIndex:
    _prefix = ""

    def __init__(self, dim: int, handle=None, **_):
        self.dim = dim
        self._h = handle

    def _fn(self, name: str):
        return getattr(lib(), f"{self._prefix}_{name}")

    def add(self, vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(vecs, np.float32)
        assert vecs.ndim == 2 and vecs.shape[1] == self.dim
        self._fn("add")(self._h, _fptr(vecs), vecs.shape[0])

    def __len__(self) -> int:
        return int(self._fn("size")(self._h))

    def search(self, queries: np.ndarray, k: int, threads: int | None = None):
        """→ (scores (nq, k) float32 inner products, descending; ids (nq, k)
        int64, -1 where the index holds fewer than k vectors)."""
        queries = np.ascontiguousarray(queries, np.float32)
        nq = queries.shape[0]
        scores = np.empty((nq, k), np.float32)
        ids = np.empty((nq, k), np.int64)
        threads = threads or min(os.cpu_count() or 1, 8)
        self._fn("search")(self._h, _fptr(queries), nq, k, _fptr(scores), _iptr(ids), threads)
        return scores, ids

    def reconstruct(self, idx: int) -> np.ndarray:
        out = np.empty((self.dim,), np.float32)
        self._fn("reconstruct")(self._h, int(idx), _fptr(out))
        return out

    def save(self, path: str) -> None:
        if self._fn("save")(self._h, path.encode()) != 0:
            raise IOError(f"failed to save index to {path}")

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                self._fn("free")(self._h)
            except Exception:
                pass
            self._h = None


class HNSWIndex(_BaseIndex):
    """Approximate inner-product index (HNSW), FAISS ``IndexHNSWFlat``'s role."""

    _prefix = "hnsw"

    def __init__(self, dim: int, M: int = 32, ef_construction: int = 200, ef_search: int = 64,
                 seed: int = 42, handle=None):
        super().__init__(dim)
        self._h = handle or lib().hnsw_create(dim, M, ef_construction, ef_search, seed)

    def set_ef(self, ef: int) -> None:
        lib().hnsw_set_ef(self._h, ef)

    @classmethod
    def load(cls, path: str, dim: int) -> "HNSWIndex":
        h = lib().hnsw_load(path.encode())
        if not h:
            raise IOError(f"failed to load HNSW index from {path}")
        return cls(dim, handle=h)


class FlatIPIndex(_BaseIndex):
    """Exact inner-product scan, FAISS ``IndexFlatIP``'s role."""

    _prefix = "flat"

    def __init__(self, dim: int, handle=None):
        super().__init__(dim)
        self._h = handle or lib().flat_create(dim)

    @classmethod
    def load(cls, path: str, dim: int) -> "FlatIPIndex":
        h = lib().flat_load(path.encode())
        if not h:
            raise IOError(f"failed to load flat index from {path}")
        return cls(dim, handle=h)
