"""Build, load and dispatch the port's hand-written CUDA kernels.

The sources are ``gpt2_image_captioning_tpu_torch/csrc/*.cu`` (plus their
``*.cuh`` headers).  At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``_build/<hash>/`` beside the
package (listed in ``.gitignore``), keyed by a hash of the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is loaded as is.
No PyTorch header is compiled, which keeps a build to seconds.

Dispatch: every kernel wrapper takes ``use_kernel``.  ``None`` launches the
kernel for CUDA tensors and runs the plain PyTorch twin for CPU tensors;
``False`` runs the twin; ``True`` on CPU tensors raises.  For a CUDA tensor
the kernel launches or the call raises; nothing falls back to the twin.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libgic_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills → nvcc.log
)

# element-type codes of the C interface (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k, v, out, key_mask, B, H, Tq, Tk, hd, strides (12 int64), causal, q_offset,
    # warps, stream
    "gic_flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P],
    # dtype, q, k_new, v_new, in_stride, k_cache, v_cache, out, B, D, H, idx, origin,
    # gather_start, start, k_scale, v_scale, stream
    "gic_decode_attention": [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                             _P],
    # dtype, ln, x, ln_scale, ln_bias, eps, q, sx, M, K, stream
    "gic_rowquant": [_I, _I, _P, _P, _P, _F, _P, _P, _I, _I, _P],
    # dtype, ln, epilogue, x, ln_scale, ln_bias, eps, w, w_scale, bias, out, stats, xa, sx, M,
    # K, N, bn, splits, k_slice, stream
    "gic_fused_linear": [_I, _I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _P],
    # dtype, x32, ln_scale, ln_bias, eps, wte, wte_scale, M, K, V, xf, sx, part_val, part_idx,
    # tok, stream
    "gic_logits_argmax": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # dtype, x32, ln_scale, ln_bias, eps, wte, wte_scale, M, K, V, xf, sx, logits, stream
    "gic_logits": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # dtype, x32, ln_scale, ln_bias, eps, wte, wte_scale, M, K, V, k, xf, sx, part_val,
    # part_idx, part_m, part_s, vals, ids, lse, stream
    "gic_logits_topk": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P],
    # dtype, x32, ln_scale, ln_bias, eps, wte, wte_scale, M, K, V, temp, top_p, key0, key1, k,
    # rounds, xf, sx, part_f, part_i, state_i, state_f, counters, tok, rnd, lse, stream
    "gic_logits_sample": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _P, _P, _U, _U, _I, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # dtype, L, B, T, D, H, eps, x32, qkvw, projw, fcw, cprojw, attnb, projb, fcb, cprojb, ln1s,
    # ln1b, ln2s, ln2b, k_cache, v_cache, cache_t, qbuf, abuf, hbuf, stream
    "gic_prefill": [_I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _I, _P, _P, _P, _P],
    # dtype, pixels, w, mean, inv_std, bias, out, B, S, patch, D, stream
    "gic_patch_embed": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def kernels_enabled(use_kernel: bool | None, device: torch.device) -> bool:
    """Resolve a wrapper's ``use_kernel`` flag for tensors on ``device``."""
    on_cuda = torch.device(device).type == "cuda"
    if use_kernel is None:
        return on_cuda
    if use_kernel and not on_cuda:
        raise ValueError(
            f"the CUDA kernels need CUDA tensors, got tensors on {device}; "
            "pass use_kernels=None or False to run the plain PyTorch path"
        )
    return bool(use_kernel)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Key of a build: the nvcc flags and every source file's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless this exact source
    set is already built; return the library's path.  Each source compiles in
    its own ``nvcc`` process, all at once; one more links the objects."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    jobs = []
    for cu in sorted(CSRC_DIR.glob("*.cu")):
        obj = out_dir / f"{cu.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, obj, proc))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *(str(obj) for _, obj, _ in jobs)]
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n--- stdout ---\n" + out + "\n--- stderr ---\n" + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit code {proc.returncode}):\n{err}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n--- stdout ---\n" + proc.stdout
                   + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit code {proc.returncode}):\n{proc.stderr}")
    (out_dir / "nvcc.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole file or none
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gic_error_string.argtypes = [_I]
    lib.gic_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry reported an error (its ``cudaGetLastError()``)."""
    if err != 0:
        msg = library().gic_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for the C interface; None (NULL) for None."""
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The current stream's handle, read without building a Stream object:
    a wrapper's host time sets the rate of kernels this short."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(cond: bool, kernel: str, what: str) -> None:
    """Argument check of a kernel wrapper."""
    if not cond:
        raise ValueError(f"{kernel}: {what}")
