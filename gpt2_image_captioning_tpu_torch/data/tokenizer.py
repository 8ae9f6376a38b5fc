"""GPT-2 byte-level BPE tokenizer — a plain-Python copy of
``gpt2_image_captioning_tpu/data/tokenizer.py`` (``bytes_to_unicode``,
``GPT2BPETokenizer``, ``load_gpt2_tokenizer``), so the port never imports
the JAX package.

It exposes the slice of the HF API the captioning stack uses:
``tokenizer(text, max_length=..., padding="max_length", truncation=True)``,
``encode`` / ``decode`` / ``batch_decode(..., skip_special_tokens=True)`` and
the pad = eos convention.  Decoding needs nothing beyond the standard
library; encoding needs the ``regex`` package (GPT-2's pre-tokenization
pattern uses Unicode classes), imported on first use.  The JAX package's
optional native merge engine is not carried over: encoding runs the
pure-Python merge loop, which gives the same ids.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Iterable, Sequence

import numpy as np

# GPT-2's pre-tokenization pattern (contractions, letter runs, number runs,
# punctuation runs, trailing-space handling).
_GPT2_SPLIT_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

GPT2_EOS_TOKEN = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """The reversible byte→printable-unicode map used by byte-level BPE.

    Printable ASCII and two Latin-1 ranges map to themselves; the remaining
    68 byte values are shifted up past 0x100 so every byte has a visible,
    non-whitespace character representation.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPETokenizer:
    """Byte-level BPE tokenizer in the GPT-2 vocab/merges format."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Sequence[tuple[str, str]],
        eos_token: str = GPT2_EOS_TOKEN,
    ) -> None:
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._pat = None  # compiled on the first encode (needs `regex`)
        self._bpe_cache: dict[str, str] = {}

        self.eos_token = eos_token
        if eos_token not in self.encoder:
            # Special tokens always exist in the id space, appended if needed.
            self.encoder[eos_token] = len(self.encoder)
            self.decoder[self.encoder[eos_token]] = eos_token
        self.eos_token_id: int = self.encoder[eos_token]
        # GPT-2 has no dedicated pad token; the whole stack uses pad=eos.
        self.pad_token = eos_token
        self.pad_token_id: int = self.eos_token_id
        self.special_token_ids = {self.eos_token_id}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "GPT2BPETokenizer":
        with open(vocab_file, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_file, "r", encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained(cls, path: str) -> "GPT2BPETokenizer":
        """Load from a directory containing ``vocab.json`` + ``merges.txt``
        (the published GPT-2 tokenizer assets)."""
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def pat(self):
        if self._pat is None:
            import regex

            self._pat = regex.compile(_GPT2_SPLIT_PATTERN)
        return self._pat

    # -- BPE core ------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    # -- public encode/decode -------------------------------------------------
    def encode(self, text: str) -> list[int]:
        """Text → token ids.  Special tokens present verbatim in the text are
        emitted as their single id."""
        ids: list[int] = []
        for chunk in self._split_on_specials(text):
            if chunk in (self.eos_token,):
                ids.append(self.encoder[chunk])
                continue
            for tok in self.pat.findall(chunk):
                mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def _split_on_specials(self, text: str) -> Iterable[str]:
        parts = text.split(self.eos_token)
        for i, part in enumerate(parts):
            if part:
                yield part
            if i < len(parts) - 1:
                yield self.eos_token

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_token_ids:
                continue
            toks.append(self.decoder[i])
        text = "".join(toks)
        return bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace")

    def batch_decode(self, batch_ids, skip_special_tokens: bool = False) -> list[str]:
        return [
            self.decode(np.asarray(row).tolist(), skip_special_tokens=skip_special_tokens)
            for row in batch_ids
        ]

    # -- HF-style call with padding/truncation ------------------------------
    def __call__(
        self,
        text: str | Sequence[str],
        max_length: int | None = None,
        padding: str | bool = False,
        truncation: bool = False,
    ) -> dict[str, np.ndarray]:
        texts = [text] if isinstance(text, str) else list(text)
        all_ids = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            all_ids = [ids[:max_length] for ids in all_ids]
        if padding == "max_length" and max_length is not None:
            target = max_length
        elif padding in (True, "longest"):
            target = max((len(ids) for ids in all_ids), default=0)
        else:
            target = None
        if target is not None:
            masks = [[1] * len(ids) + [0] * (target - len(ids)) for ids in all_ids]
            all_ids = [ids + [self.pad_token_id] * (target - len(ids)) for ids in all_ids]
        else:
            masks = [[1] * len(ids) for ids in all_ids]
        return {
            "input_ids": np.asarray(all_ids, dtype=np.int32),
            "attention_mask": np.asarray(masks, dtype=np.int32),
        }


def load_gpt2_tokenizer(assets_dir: str | None = None) -> GPT2BPETokenizer:
    """Load the GPT-2 tokenizer with pad=eos from ``vocab.json`` +
    ``merges.txt`` under ``assets_dir``, ``$GPT2_TOKENIZER_DIR`` or
    ``./assets/gpt2``; raises, naming the places it looked, when none has
    them (the assets are not in the repository)."""
    looked = [c for c in (assets_dir, os.environ.get("GPT2_TOKENIZER_DIR"), "assets/gpt2") if c]
    for cand in looked:
        if os.path.exists(os.path.join(cand, "vocab.json")):
            return GPT2BPETokenizer.from_pretrained(cand)
    raise FileNotFoundError(
        "GPT-2 tokenizer assets (vocab.json + merges.txt) not found; looked for "
        + ", ".join(os.path.join(c, "vocab.json") for c in looked)
        + ". Set GPT2_TOKENIZER_DIR or pass assets_dir."
    )
