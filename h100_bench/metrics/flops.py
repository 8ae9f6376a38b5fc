"""Operations and bytes of the port's work, computed from shapes alone.

Every function counts what the algorithm needs, not what a kernel does:
a product of (M, K) by (K, N) is 2·M·K·N operations; each input byte is
read once and each output byte written once.  Causal attention counts only
the (query, key) pairs the mask keeps.  ``cfg`` is a configuration file of
``h100_bench/configs`` (its ``gpt2``, ``mapping`` and ``vision`` groups).
"""

from __future__ import annotations

BYTES = {"float32": 4, "bf16": 2, "int8": 1, "uint8": 1}


def linear(m: int, k: int, n: int, w_bytes: int, act_bytes: int, bias: bool = True
           ) -> tuple[float, float]:
    """(operations, bytes) of ``(m, k) @ (k, n) (+ bias)``: the weight in
    ``w_bytes`` a value, the activations in and out in ``act_bytes``, a
    float32 bias."""
    return 2.0 * m * k * n, float(k * n * w_bytes + m * k * act_bytes + m * n * act_bytes
                                  + (4 * n if bias else 0))


def gpt2_layer_linears(d: int) -> tuple[tuple[int, int], ...]:
    """(K, N) of a GPT-2 layer's four products: qkv, attention output, fc,
    fc projection."""
    return ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d))


def linears_of_rows(cfg: dict, rows: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of every GPT-2 layer's four products at ``rows``
    rows, the weights and activations in ``dtype``."""
    g = cfg["gpt2"]
    el = BYTES[dtype]
    ops = nbytes = 0.0
    for k, n in gpt2_layer_linears(g["n_embd"]):
        o, b = linear(rows, k, n, el, el)
        ops, nbytes = ops + o, nbytes + b
    return ops * g["n_layer"], nbytes * g["n_layer"]


def attention_ops(b: int, heads: int, tq: int, tk: int, hd: int, causal: bool,
                  q_offset: int = 0) -> float:
    """QKᵀ and PV: 4·hd operations for each (query, key) pair attended."""
    if causal:
        pairs = sum(min(tk, q_offset + i + 1) for i in range(tq))
    else:
        pairs = tq * tk
    return 4.0 * b * heads * pairs * hd


def attention(b: int, heads: int, tq: int, tk: int, hd: int, causal: bool, dtype: str
              ) -> tuple[float, float]:
    """(operations, bytes) of one attention call: q, k, v read and o written
    once in ``dtype``."""
    el = BYTES[dtype]
    return (attention_ops(b, heads, tq, tk, hd, causal),
            float(el * b * heads * hd * (2 * tq + 2 * tk)))


def vocab(rows: int, cfg: dict, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of the tied-embedding logits and their selection at
    ``rows`` rows: wte read once in ``dtype``, the float32 rows in, one int32
    token out a row."""
    g = cfg["gpt2"]
    d, v = g["n_embd"], g["vocab_size"]
    return 2.0 * rows * d * v, float(v * d * BYTES[dtype] + rows * d * 4 + rows * 4)


def decode_step(cfg: dict, rows: int, keys: int) -> float:
    """Operations of one decode step of ``rows`` rows whose attention reads
    ``keys`` cached positions (the new one included): the layers' products
    and attention, and the vocabulary."""
    g = cfg["gpt2"]
    d, layers = g["n_embd"], g["n_layer"]
    return (layers * (24.0 * rows * d * d + 4.0 * rows * keys * d)
            + 2.0 * rows * d * g["vocab_size"])


def prefill(cfg: dict, rows: int) -> float:
    """Operations of the prefill of ``rows`` prefixes of the mapper's length:
    every layer over the prefix (causal attention) and the first token's
    vocabulary."""
    g = cfg["gpt2"]
    d, layers, p = g["n_embd"], g["n_layer"], cfg["mapping"]["prefix_length"]
    attn = attention_ops(rows, 1, p, p, d, causal=True)
    return layers * (24.0 * rows * p * d * d + attn) + 2.0 * rows * d * g["vocab_size"]


def mapper(cfg: dict, rows: int) -> float:
    """Operations of the transformer mapper's forward at ``rows`` embeddings:
    the linear map to ``hidden_length`` tokens, then each encoder layer over
    hidden + prefix tokens (bidirectional attention, a 4·D ReLU MLP)."""
    m = cfg["mapping"]
    d, t = m["gpt_dim"], m["hidden_length"] + m["prefix_length"]
    first = 2.0 * rows * m["embed_dim"] * m["hidden_length"] * d
    layer = 24.0 * rows * t * d * d + attention_ops(rows, 1, t, t, d, causal=False)
    return first + m["num_layers"] * layer


def patch_embed(cfg: dict, images: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of one patch-embedding call at ``images`` images:
    the uint8 pixels read once, the (K, D) weight in ``dtype``, the float32
    patch rows written."""
    v = cfg["vision"]
    p, s, d = v["patch_size"], v["image_size"], v["hidden_size"]
    n, k = (s // p) ** 2, 3 * p * p
    return 2.0 * images * n * k * d, float(images * s * s * 3 + k * d * BYTES[dtype]
                                           + images * n * d * 4)


def decode_request(cfg: dict, rows: int, steps: int) -> float:
    """Operations of one request: the mapper, the prefill and ``steps``
    decode steps (step s attends prefix + s positions)."""
    p = cfg["mapping"]["prefix_length"]
    return (mapper(cfg, rows) + prefill(cfg, rows)
            + sum(decode_step(cfg, rows, p + s) for s in range(1, steps + 1)))


def train_step(cfg: dict, rows: int, caption_len: int) -> float:
    """Operations of a train step with GPT-2 frozen and the mapper trained:
    GPT-2's forward over prefix + caption and its activation gradients (one
    more pass of every product, two of attention; no weight gradients), the
    loss's logits over the caption positions and their gradient; the
    mapper's forward and both gradients (6·N·tokens for its products)."""
    g = cfg["gpt2"]
    d, layers = g["n_embd"], g["n_layer"]
    t = cfg["mapping"]["prefix_length"] + caption_len
    products = layers * 24.0 * rows * t * d * d
    attn = layers * attention_ops(rows, 1, t, t, d, causal=True)
    head = 2.0 * rows * caption_len * d * g["vocab_size"]
    gpt = 2 * products + 3 * attn + 2 * head
    return gpt + 3 * mapper(cfg, rows)
