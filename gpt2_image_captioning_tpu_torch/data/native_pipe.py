"""ctypes binding of the native image pipeline (``native/imagepipe``) — the
counterpart of ``gpt2_image_captioning_tpu/data/native_pipe.py``.

JPEG decode → antialiased resize → center crop in C++, threaded over a
batch.  The library is loaded by path from ``native/build/libimagepipe.so``
(``make -C native``) or ``$GIC_IMAGEPIPE_LIB``; :func:`available` is False
when it is not built, and the extractors then decode with PIL.  Files that
are not JPEG go through PIL image by image.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from gpt2_image_captioning_tpu_torch.embeddings.preprocess import PreprocessSpec, resize_and_crop

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build", "libimagepipe.so"),
    os.environ.get("GIC_IMAGEPIPE_LIB", ""),
]

_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = next((p for p in _LIB_PATHS if p and os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                "libimagepipe.so is not built: run `make -C native` at the repository root")
        lb = ctypes.CDLL(os.path.abspath(path))
        lb.imagepipe_process_one.restype = ctypes.c_int
        lb.imagepipe_process_one.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lb.imagepipe_process_batch.restype = ctypes.c_int
        lb.imagepipe_process_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lb
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except (FileNotFoundError, OSError):
        return False


def _args(spec: PreprocessSpec) -> tuple[int, int, int, int]:
    return (spec.resize, spec.crop or 0, int(spec.interpolation == "bicubic"),
            int(spec.resize_shortest))


def process_one(path: str, spec: PreprocessSpec) -> np.ndarray:
    """One JPEG → uint8 (S, S, 3) per ``spec``."""
    s = spec.size
    out = np.empty((s, s, 3), np.uint8)
    rc = lib().imagepipe_process_one(path.encode(), *_args(spec),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"imagepipe failed to process {path}")
    return out


def process_batch(paths: list[str], spec: PreprocessSpec, threads: int = 4) -> np.ndarray:
    """JPEGs → uint8 (N, S, S, 3), decoded and resized in C++ threads."""
    s, n = spec.size, len(paths)
    out = np.empty((n, s, s, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib().imagepipe_process_batch(arr, n, *_args(spec),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                       threads)
    if rc != 0:
        raise RuntimeError(f"imagepipe failed on {paths[rc - 1]}")
    return out


class NativeImageBatchLoader:
    """``ImageBatchLoader``'s contract on the C++ pipeline: yields
    ``(filenames, batch_u8 (B, S, S, 3), valid)`` of a fixed batch shape."""

    def __init__(self, directory: str, spec: PreprocessSpec, batch_size: int = 64,
                 num_workers: int = 4):
        from gpt2_image_captioning_tpu_torch.data.images import ImageDirectory

        self.dir = ImageDirectory(directory)
        self.spec = spec
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return -(-len(self.dir) // self.batch_size)

    def __iter__(self):
        names = self.dir.filenames
        for start in range(0, len(names), self.batch_size):
            chunk = names[start : start + self.batch_size]
            paths = [self.dir.path(start + i) for i in range(len(chunk))]
            jpegs = [p.lower().endswith((".jpg", ".jpeg")) for p in paths]
            if all(jpegs):
                batch = process_batch(paths, self.spec, threads=self.num_workers)
            else:
                batch = np.stack([
                    process_one(p, self.spec) if is_jpeg
                    else resize_and_crop(self.dir.load_rgb(start + i), self.spec)
                    for i, (p, is_jpeg) in enumerate(zip(paths, jpegs))])
            valid = np.ones(self.batch_size, dtype=bool)
            if len(chunk) < self.batch_size:
                valid[len(chunk):] = False
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], self.batch_size - len(chunk), axis=0)])
            yield chunk, batch, valid
