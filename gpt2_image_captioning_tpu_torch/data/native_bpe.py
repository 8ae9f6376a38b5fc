"""ctypes binding for the native BPE merge engine (``native/bpe``) — the
counterpart of ``gpt2_image_captioning_tpu/data/native_bpe.py``, loading the
same ``native/build/libbpe.so`` by path with the same signatures.

It runs the per-word merge loop and the vocabulary lookup of
:class:`data.tokenizer.GPT2BPETokenizer` (pre-tokenization stays in Python).
The library is built by ``make -C native`` at the repository root (or named
by ``$GIC_BPE_LIB``); without it the tokenizer runs its plain-Python loop,
which gives the same ids.  This is the host's tokenizer: nothing here runs
on the card.
"""

from __future__ import annotations

import ctypes
import os

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build", "libbpe.so"),
    os.environ.get("GIC_BPE_LIB", ""),
]

_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        for p in _LIB_PATHS:
            if p and os.path.exists(p):
                l = ctypes.CDLL(os.path.abspath(p))
                l.bpe_create.restype = ctypes.c_void_p
                l.bpe_free.argtypes = [ctypes.c_void_p]
                l.bpe_add_token.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ]
                l.bpe_set_end_suffix.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ]
                l.bpe_add_merge.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ]
                l.bpe_encode_word.restype = ctypes.c_int64
                l.bpe_encode_word.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ]
                l.bpe_encode_words.restype = ctypes.c_int64
                l.bpe_encode_words.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ]
                _lib = l
                break
        else:
            raise FileNotFoundError(
                "libbpe.so not built — run `make -C native` at the repo root."
            )
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except FileNotFoundError:
        return False


class NativeBPE:
    """Holds a loaded vocab+merges table and encodes pre-tokenized words."""

    def __init__(
        self,
        encoder: dict[str, int],
        bpe_ranks: dict[tuple[str, str], int],
        end_suffix: str = "",
    ):
        self._h = lib().bpe_create()
        if end_suffix:
            b = end_suffix.encode("utf-8")
            lib().bpe_set_end_suffix(self._h, b, len(b))
        for tok, idx in encoder.items():
            b = tok.encode("utf-8")
            lib().bpe_add_token(self._h, b, len(b), idx)
        for (a, b_), rank in bpe_ranks.items():
            ab, bb = a.encode("utf-8"), b_.encode("utf-8")
            lib().bpe_add_merge(self._h, ab, len(ab), bb, len(bb), rank)
        self._buf = (ctypes.c_int64 * 4096)()

    def encode_word(self, word: str) -> list[int]:
        """word: a pre-token already mapped through bytes_to_unicode."""
        b = word.encode("utf-8")
        n = lib().bpe_encode_word(self._h, b, len(b), self._buf, len(self._buf))
        if n == -2:
            raise KeyError(f"token not in vocab while encoding {word!r}")
        if n < 0:
            raise ValueError(f"word too long for the id buffer: {word!r}")
        return list(self._buf[: n])

    def encode_words(self, words: list[str]) -> list[int]:
        """Encode a text's pre-token list in ONE FFI call (the hot path)."""
        if not words:
            return []
        encoded = [w.encode("utf-8") for w in words]
        blob = b"".join(encoded)
        offsets = (ctypes.c_int64 * (len(words) + 1))()
        pos = 0
        for i, e in enumerate(encoded):
            offsets[i] = pos
            pos += len(e)
        offsets[len(words)] = pos
        cap = max(4096, pos + len(words))
        if cap > len(self._buf):
            self._buf = (ctypes.c_int64 * (2 * cap))()
        n = lib().bpe_encode_words(self._h, blob, offsets, len(words), self._buf, len(self._buf))
        if n == -2:
            raise KeyError("token not in vocab while batch-encoding")
        if n < 0:
            raise ValueError("id buffer overflow in batch encode")
        return list(self._buf[: n])

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                lib().bpe_free(self._h)
            except Exception:
                pass
            self._h = None
