"""GPT-2 decoder over plain dicts of tensors — the counterpart of
``gpt2_image_captioning_tpu/models/gpt2.py``.

Parameters keep the JAX package's layout: ``wte`` (V, D), ``wpe`` (P, D),
``ln_f``, and ``blocks`` stacked on a leading layer dim with ``Conv1D``
``(in, out)`` weights.  ``forward_hidden`` / ``forward`` are the
full-sequence causal forward of training; the KV cache of decoding is
(L, T, B, D) with T rounded up to :data:`ops.decode_attention.CHUNK_T`;
``forward_cached`` updates it in place and the cache's ``index`` is a host
int.  Attention goes through :func:`ops.attention.mha`: the flash kernel for
CUDA tensors unless ``use_kernels=False``.

Tensor parallelism (a ``mesh`` whose ``tp`` > 1, :mod:`core.mesh`) is
Megatron's: each tp rank holds the slice of the tree
:func:`shard_params` cuts by :func:`partition_specs` and runs the same rows.

- ``c_attn`` and ``c_fc`` split their output columns — ``c_attn`` by head
  inside each of q, k and v, so a rank holds whole heads of all three (the
  JAX spec ``P(None, None, "tp")`` cuts the fused columns contiguously,
  which gives rank 0 all of q; the port copies the math, not that layout).
  Their input's gradient is summed over tp (``copy_to_tp``'s backward),
  fused into the product's backward so that the ranks' float32 partials
  are summed before one rounding to the compute dtype, as one card rounds
  its product once (:class:`_ColumnParallelDot`).
- the two ``c_proj`` split their input rows; their partial products pass
  :func:`parallel.collectives.reduce_from_tp` (in float32) and the bias is
  added once, after it.
- ``wte`` is vocab-parallel: its rows split over tp, the vocabulary padded
  to a multiple of tp by zero rows whose logits are masked, so they never
  win.  The embedding looks up the rank's rows and sums over tp; decoding
  gathers each step's (B, V) logits on every rank before the selection;
  training takes :func:`ops.xent.xent_sum_tp`, the vocab-parallel
  cross-entropy, so no rank holds the (N, V) logits.  The JAX spec splits
  ``wte``'s features instead (``P(None, "tp")``): the logits product then
  needs a sum over tp of (N, V) partials, the traffic this form avoids.

Each rank's attention runs its H/tp heads through the same kernels, and its
KV cache is its own contiguous (L, T, B, D/tp) tensor
(:func:`init_cache` with the mesh).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.mesh import MODEL_AXIS, tp_active
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX
from gpt2_image_captioning_tpu_torch.parallel.collectives import (
    Split, all_reduce, gather_last_tp, gather_tree, reduce_from_tp, shard_tree,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def gpt2_medium() -> "GPT2Config":
        """355M.  Every decode kernel runs at this width and the two below:
        the port's kernels have no width gate (the JAX package routes these
        sizes off its fused step kernel)."""
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16)

    @staticmethod
    def gpt2_large() -> "GPT2Config":
        """774M — see :meth:`gpt2_medium`."""
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20)

    @staticmethod
    def gpt2_xl() -> "GPT2Config":
        """1.5B — see :meth:`gpt2_medium`."""
        return GPT2Config(n_embd=1600, n_layer=48, n_head=25)

    @staticmethod
    def tiny(vocab_size: int = 293) -> "GPT2Config":
        """Small config for CPU tests."""
        return GPT2Config(vocab_size=vocab_size, n_positions=128, n_embd=32, n_layer=2, n_head=2)


def init(generator: torch.Generator, cfg: GPT2Config) -> dict:
    """HF GPT-2 init scheme, as ``gpt2.init`` in the JAX package: N(0, 0.02)
    token embeddings and weights, N(0, 0.01) positions, zero biases, residual
    projections at std 0.02 / sqrt(2 · n_layer).  Float32, on the CPU."""
    d = cfg.n_embd
    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    wte = nn.normal(generator, (cfg.vocab_size, d), 0.02)
    wpe = nn.normal(generator, (cfg.n_positions, d), 0.01)
    layers = []
    for _ in range(cfg.n_layer):
        layers.append({
            "ln_1": nn.layer_norm_init(d),
            "attn": {
                "c_attn": nn.dense_init(generator, d, 3 * d, std=0.02),
                "c_proj": nn.dense_init(generator, d, d, std=proj_std),
            },
            "ln_2": nn.layer_norm_init(d),
            "mlp": {
                "c_fc": nn.dense_init(generator, d, 4 * d, std=0.02),
                "c_proj": nn.dense_init(generator, 4 * d, d, std=proj_std),
            },
        })
    return {"wte": wte, "wpe": wpe, "ln_f": nn.layer_norm_init(d), "blocks": stack_blocks(layers)}


def check_params(gpt: dict, cfg: GPT2Config, mesh=None) -> None:
    """Raise unless a GPT-2 tree's embedding and block shapes are ``cfg``'s,
    or with a tp ``mesh`` those of a rank's slice (:func:`shard_params`)."""
    tp = mesh.tp if tp_active(mesh) else 1
    want = {
        "wte": (-(-cfg.vocab_size // tp), cfg.n_embd),
        "wpe": (cfg.n_positions, cfg.n_embd),
        "c_attn": (cfg.n_layer, cfg.n_embd, 3 * cfg.n_embd // tp),
        "c_fc": (cfg.n_layer, cfg.n_embd, 4 * cfg.n_embd // tp),
    }
    got = {
        "wte": tuple(gpt["wte"].shape),
        "wpe": tuple(gpt["wpe"].shape),
        "c_attn": tuple(gpt["blocks"]["attn"]["c_attn"]["w"].shape),
        "c_fc": tuple(gpt["blocks"]["mlp"]["c_fc"]["w"].shape),
    }
    if got != want:
        raise ValueError(f"GPT-2 params do not match {cfg}: shapes {got}, expected {want}")


def partition_specs(cfg: GPT2Config) -> dict:
    """How each leaf is cut over the ``tp`` axis (the JAX ``partition_specs``,
    ``gpt2.py:127-160``, in Megatron's form — module docstring): a
    :class:`parallel.collectives.Split`, or None for a replicated leaf.
    Stacked blocks keep their leading layer dim whole."""
    col = {"w": Split(MODEL_AXIS, -1), "b": Split(MODEL_AXIS, -1)}
    qkv = {"w": Split(MODEL_AXIS, -1, groups=3), "b": Split(MODEL_AXIS, -1, groups=3)}
    row = {"w": Split(MODEL_AXIS, -2), "b": None}
    blocks = {"ln_1": None, "attn": {"c_attn": qkv, "c_proj": row}, "ln_2": None,
              "mlp": {"c_fc": col, "c_proj": row}}
    return {"wte": Split(MODEL_AXIS, 0, pad=True), "wpe": None, "ln_f": None, "blocks": blocks}


def cache_partition_specs(cfg: GPT2Config) -> dict:
    """The KV cache's axes (the JAX ``cache_partition_specs``): (L, T, B, D)
    with the batch over dp and the width over tp — heads are contiguous
    head_dim groups of D, so a rank's (L, T, B/dp, D/tp) cache holds whole
    heads."""
    return {"k": (None, None, "dp", MODEL_AXIS), "v": (None, None, "dp", MODEL_AXIS),
            "index": ()}


def shard_params(gpt: dict, cfg: GPT2Config, mesh) -> dict:
    """This tp rank's slice of a full GPT-2 tree (:func:`partition_specs`);
    replicated leaves are the tree's own tensors.  The tree itself without a
    tp axis."""
    if not tp_active(mesh):
        return gpt
    if cfg.n_head % mesh.tp:
        raise ValueError(f"tp={mesh.tp} must divide n_head={cfg.n_head}")
    return shard_tree(gpt, partition_specs(cfg), {MODEL_AXIS: mesh.tp},
                      {MODEL_AXIS: mesh.tp_rank})


def gather_params(gpt: dict, cfg: GPT2Config, mesh) -> dict:
    """The full tree from every tp rank's slice (:func:`shard_params`'
    inverse, bit for bit; every rank of the tp group must call): the JAX
    layout, ``wte`` trimmed back to the vocabulary."""
    if not tp_active(mesh):
        return gpt
    return gather_tree(gpt, partition_specs(cfg), mesh.backend, {MODEL_AXIS: mesh.tp_group},
                       {MODEL_AXIS: mesh.tp}, trims={"wte": cfg.vocab_size})


def stack_blocks(blocks: list[dict]) -> dict:
    """List of per-layer param dicts → one dict with a leading layer dim."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def embed_tokens(params: dict, token_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """``wte`` rows of ``token_ids``; with a tp ``mesh`` the vocab-parallel
    lookup: each rank's rows where it owns the id, zeros elsewhere, summed
    over tp."""
    wte = params["wte"]
    if not tp_active(mesh):
        return wte[token_ids]
    local = token_ids - mesh.tp_rank * wte.shape[0]
    mine = (local >= 0) & (local < wte.shape[0])
    rows = wte[torch.where(mine, local, 0)]
    return reduce_from_tp(mesh, torch.where(mine[..., None], rows, 0))


class _ColumnParallelDot(torch.autograd.Function):
    """``x @ w`` (float32, :func:`ops.nn.dot_f32`) of a tp rank's column
    slice ``w``, whose backward sums dx over tp in float32 and then rounds it
    to x's dtype once (``copy_to_tp`` fused into the product: summing the
    ranks' dx after each was rounded to bf16 would round twice); dw stays
    the rank's."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return nn.dot_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)  # as a product on one card rounds its incoming gradient
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce(ctx.mesh.backend, ctx.mesh.tp_group, nn.dot_f32(g, w.t()))
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
            dw = nn.dot_f32(x2.t(), g2).to(w.dtype)
        return dx, dw, None


def _col_dense(params: dict, x: torch.Tensor, policy: Policy, mesh) -> torch.Tensor:
    """A column-parallel product: ``x`` (the same on every tp rank) against
    the rank's columns of ``w``, plus its bias slice."""
    if not tp_active(mesh):
        return nn.dense(params, x, policy)
    y = _ColumnParallelDot.apply(policy.cast(x), params["w"].to(policy.compute_dtype), mesh)
    return (y + params["b"].float()).to(policy.compute_dtype)


def _row_dense(params: dict, x: torch.Tensor, policy: Policy, mesh) -> torch.Tensor:
    """A row-parallel product: the rank's rows of ``w`` against its slice of
    ``x``, the float32 partial products summed over tp, then the bias."""
    if not tp_active(mesh):
        return nn.dense(params, x, policy)
    y = reduce_from_tp(mesh, nn.dot_f32(policy.cast(x), params["w"].to(policy.compute_dtype)))
    return (y + params["b"].float()).to(policy.compute_dtype)


def local_heads(cfg: GPT2Config, mesh) -> int:
    """The heads a rank holds: all of them, or n_head / tp under a tp mesh."""
    return cfg.n_head // mesh.tp if tp_active(mesh) else cfg.n_head


def vocab_logits(params: dict, x: torch.Tensor, policy: Policy, vocab_size: int,
                 mesh=None) -> torch.Tensor:
    """Float32 logits (B, V) of final-LayerNorm rows ``x`` (B, D) against the
    tied ``wte``; under a tp mesh each rank's columns, gathered on every
    rank and trimmed of the padding."""
    logits = nn.dot_f32(policy.cast(x), params["wte"].t().to(policy.compute_dtype))
    if not tp_active(mesh):
        return logits
    return gather_last_tp(mesh, logits)[..., :vocab_size]


# ---------------------------------------------------------------------------
# Full-sequence forward (teacher forcing)
# ---------------------------------------------------------------------------

def _block(bp: dict, cfg: GPT2Config, x: torch.Tensor, key_mask: torch.Tensor | None,
           policy: Policy, use_kernels: bool | None, mesh=None) -> torch.Tensor:
    h = nn.layer_norm(bp["ln_1"], x, cfg.layer_norm_epsilon)
    qkv = _col_dense(bp["attn"]["c_attn"], h, policy, mesh)
    heads = local_heads(cfg, mesh)
    q, k, v = (nn.split_heads(t, heads) for t in torch.split(qkv, qkv.shape[-1] // 3, dim=-1))
    a = mha(q, k, v, causal=True, key_mask=key_mask, policy=policy, use_kernel=use_kernels)
    x = x + _row_dense(bp["attn"]["c_proj"], nn.merge_heads(a), policy, mesh)
    h = nn.layer_norm(bp["ln_2"], x, cfg.layer_norm_epsilon)
    h = nn.gelu_new(_col_dense(bp["mlp"]["c_fc"], h, policy, mesh))
    return x + _row_dense(bp["mlp"]["c_proj"], h, policy, mesh)


def run_blocks(blocks: dict, cfg: GPT2Config, x: torch.Tensor, attention_mask, policy: Policy,
               remat: bool = False, use_kernels: bool | None = None, mesh=None) -> torch.Tensor:
    """``x`` through every layer of the stacked ``blocks`` (all of GPT-2's, or
    a pipeline stage's), each checkpointed under ``remat``."""
    for i in range(blocks["ln_1"]["scale"].shape[0]):
        bp = _layer(blocks, i)
        if remat:
            x = checkpoint(_block, bp, cfg, x, attention_mask, policy, use_kernels, mesh,
                           use_reentrant=False)
        else:
            x = _block(bp, cfg, x, attention_mask, policy, use_kernels, mesh)
    return x


def forward_hidden(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    policy: Policy = F32,
    remat: bool = False,
    use_kernels: bool | None = None,
    mesh=None,
) -> torch.Tensor:
    """Full-sequence causal forward → final-LayerNorm hidden states (B, T, D)
    in the compute dtype.  ``attention_mask``: (B, T) key padding mask,
    1 = attend; positions are absolute from 0.  ``mesh``: a tp mesh whose
    rank's slice ``params`` is (module docstring); the hidden states are
    whole on every rank.

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes the block instead of keeping its
    activations, for identical loss and gradients.  Frozen weights need no
    unrolled loop as in the JAX package: tensors with ``requires_grad=False``
    get no weight gradients."""
    x = add_positions(params, inputs_embeds, policy)
    x = run_blocks(params["blocks"], cfg, x, attention_mask, policy, remat, use_kernels, mesh)
    return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)


def add_positions(params: dict, inputs_embeds: torch.Tensor, policy: Policy) -> torch.Tensor:
    """``inputs_embeds`` (B, T, D) plus the positions 0 … T - 1, in float32,
    then in the compute dtype: the first layer's input."""
    pos = params["wpe"][: inputs_embeds.shape[1]].float()
    return (inputs_embeds.float() + pos[None]).to(policy.compute_dtype)


def forward(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    policy: Policy = F32,
) -> torch.Tensor:
    """Full-sequence causal LM forward over embeddings → float32 logits (B, T, V)."""
    x = forward_hidden(params, cfg, inputs_embeds, attention_mask, policy)
    return vocab_logits(params, x, policy, cfg.vocab_size)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted next-token CE with -100 ignored → (sum, count), so callers can
    combine micro-batches before dividing.  The oracle of ``ops.xent.xent_sum``."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


# ---------------------------------------------------------------------------
# KV-cached decode
# ---------------------------------------------------------------------------

def init_cache(cfg: GPT2Config, batch: int, max_len: int, dtype=torch.float32,
               device=DEFAULT_DEVICE, mesh=None) -> dict:
    """KV cache laid out (L, T, B, D), T rounded up to ``CHUNK_T``; rows past
    ``index`` are masked everywhere.  Under a tp ``mesh`` the rank's own
    (L, T, B, D/tp) cache of its heads."""
    max_len = -(-max_len // DA.CHUNK_T) * DA.CHUNK_T
    width = cfg.n_embd // mesh.tp if tp_active(mesh) else cfg.n_embd
    shape = (cfg.n_layer, max_len, batch, width)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def forward_cached(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    cache: dict,
    policy: Policy = F32,
    use_kernels: bool | None = None,
    mesh=None,
    origin: torch.Tensor | None = None,
    gather_start: int = 0,
) -> tuple[torch.Tensor, dict]:
    """Forward ``inputs_embeds`` (B, T, D) from position ``cache['index']``;
    returns (last-position float32 logits (B, V), cache with index + T).

    T > 1 is the prefill of an empty cache (the prefix attends itself
    causally through :func:`ops.attention.mha`, as the JAX package's
    ``fresh_prefill``); T == 1 is a decode step whose attention goes through
    :func:`ops.decode_attention.decode_attention`.  Both run their kernels
    for CUDA tensors unless ``use_kernels=False``.  The cache tensors are
    written in place.  A step may read its history through a beam ancestry
    map ``origin`` from ``gather_start`` on (:func:`ops.decode_attention.decode_attention`).
    ``mesh``: a tp mesh; ``params`` and ``cache`` are then the rank's slices
    (:func:`shard_params`, :func:`init_cache`), and the logits are whole on
    every rank.
    """
    _, t, _ = inputs_embeds.shape
    idx = int(cache["index"])
    if t > 1 and idx != 0:
        raise ValueError(
            f"a {t}-token forward needs an empty cache (index {idx}); only the prefill of a "
            "fresh cache and one-token steps are ported"
        )
    pos = params["wpe"][idx : idx + t].float()
    x = (inputs_embeds.float() + pos[None]).to(policy.compute_dtype)
    k_all, v_all = cache["k"], cache["v"]
    blocks = params["blocks"]
    heads = local_heads(cfg, mesh)

    for i in range(cfg.n_layer):
        bp = _layer(blocks, i)
        h = nn.layer_norm(bp["ln_1"], x, cfg.layer_norm_epsilon)
        qkv = _col_dense(bp["attn"]["c_attn"], h, policy, mesh)
        q3, k3, v3 = torch.split(qkv, qkv.shape[-1] // 3, dim=-1)
        if t == 1:
            a_flat, _, _ = DA.decode_attention(
                q3[:, 0], k3[:, 0], v3[:, 0], k_all[i], v_all[i], idx, n_head=heads,
                origin=origin, gather_start=gather_start, use_kernel=use_kernels,
            )
            a = a_flat[:, None, :].to(policy.compute_dtype)
        else:
            k_all[i, :t] = k3.transpose(0, 1).to(k_all.dtype)
            v_all[i, :t] = v3.transpose(0, 1).to(v_all.dtype)
            a = nn.merge_heads(mha(
                nn.split_heads(q3, heads), nn.split_heads(k3, heads),
                nn.split_heads(v3, heads), causal=True, policy=policy,
                use_kernel=use_kernels,
            ))
        x = x + _row_dense(bp["attn"]["c_proj"], a, policy, mesh)
        h = nn.layer_norm(bp["ln_2"], x, cfg.layer_norm_epsilon)
        h = nn.gelu_new(_col_dense(bp["mlp"]["c_fc"], h, policy, mesh))
        x = x + _row_dense(bp["mlp"]["c_proj"], h, policy, mesh)

    x = nn.layer_norm(params["ln_f"], x[:, -1, :], cfg.layer_norm_epsilon)
    logits = vocab_logits(params, x, policy, cfg.vocab_size, mesh)
    return logits, {"k": k_all, "v": v_all, "index": idx + t}


def _layer(blocks: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}
