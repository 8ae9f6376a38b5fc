"""The image-captioning model: mapping network + GPT-2 decoder — the
counterpart of ``gpt2_image_captioning_tpu/models/captioner.py`` on its
training path (``loss_fn``, ``mean_loss``) and its serving paths: greedy and
sampled (top-p) ``generate``, ``beam_generate``, and the host-driven
continuous-batching primitives ``decode_segment`` and ``admit_prefill``.

Parameters split into a trainable and a frozen tree as in the JAX package.
Everything runs eagerly.  The mapper is torch ops around the
flash-attention kernel; the prefill is :func:`ops.prefill_step.prefill_into_cache`
(the prefill kernel); then each decode step is
:func:`ops.decode_step.fused_decode_step` — the hand-written CUDA kernels for
CUDA tensors, their plain twins on the CPU; ``use_kernels=False`` switches
every kernel off.  Greedy steps end in the argmax kernel, sampled steps emit
the float32 logits for :func:`ops.sampling.sample_token`, beam steps emit
each row's top-k and logsumexp and read the cache through an ancestry map.
With ``sample_in_kernel=True`` a sampled step draws its token inside the
step (``csrc/logits_sample.cu``).  ``generate``'s early exit reads one flag
from the device per step.  ``decode_quant=True`` decodes from a W8A8 pack
(int8 weights, int8 activations per row) in every mode, and
``decode_quant_cache=True`` keeps an int8 KV cache; the mapper, the prefill
and the first token stay at the compute precision, as in the JAX package,
and the prefill runs ``gpt2.forward_cached`` there (an int8 pack holds no
float weights), as the JAX package keeps its XLA prefill.

Under a dp mesh (:mod:`core.mesh`) ``generate`` and ``beam_generate`` run
the single-device path, kernels and all, on each rank's contiguous rows
(:func:`_dp_rows`) and gather the tokens in dp order, so every rank
returns the whole batch.

Under a tp mesh the trees are each rank's slices (:func:`shard_params`):
``loss_fn`` runs Megatron's GPT-2 (``models/gpt2.py``), and ``generate`` /
``beam_generate`` take the JAX package's layerwise branch
(``captioner.py:318-324``, ``:802-815``): the mapper, then
``gpt2.forward_cached`` prefills and steps on the rank's heads, each step's
attention the decode attention kernel over the rank's own (L, T, B, D/tp)
cache and its products plain ``torch.matmul``, as the JAX products there
are plain XLA; the step kernels and the prefill kernel, which walk whole
weight matrices, do not run.  Each step's logits are gathered whole on
every rank before the selection, so every rank picks the same tokens.  As
in the JAX branch, ``decode_quant`` / ``decode_quant_cache`` / a ``packed``
pack do not apply there (the steps run at the trees' precision, with a
warning for the quantized options) and ``sample_in_kernel`` warns and
samples from the logits.  Under dp × tp each tp group decodes its dp rows.

A prefix longer than the prefill kernel's :data:`ops.prefill_step.MAX_PREFIX`
tokens prefills through ``gpt2.forward_cached`` (the flash kernel, causal
at Tq = Tk = P), as the JAX package gates its prefill kernel at 32 tokens
and sends longer prefixes to ``forward_cached`` (``captioner.py:297-316``,
``:856-900``; its ``admit_prefill`` always does).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.mesh import tp_active
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32, Policy, cast_floating
from gpt2_image_captioning_tpu_torch.core.tree import tree_map
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.models import mapping as M
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.ops import prefill_step as PS
from gpt2_image_captioning_tpu_torch.ops.sampling import (
    NEG_INF, fold_seed, sample_token, topk_small,
)
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX, xent_sum, xent_sum_tp


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    gpt2: G.GPT2Config
    mapping: M.MappingConfig
    # token ids of the optional task prompt; its embeddings become trainable
    # parameters initialized from wte
    task_prompt_ids: tuple[int, ...] | None = None
    freeze_gpt_weights: bool = True
    eos_token_id: int = 50256
    # checkpoint each GPT-2 block in the training forward: one more block
    # forward in the backward for activation memory O(1) in depth, with
    # identical loss and gradients
    remat: bool = False

    @property
    def image_prefix_length(self) -> int:
        return self.mapping.prefix_length

    @property
    def total_prefix_length(self) -> int:
        extra = len(self.task_prompt_ids) if self.task_prompt_ids else 0
        return self.mapping.prefix_length + extra


def init_params(
    generator: torch.Generator, cfg: CaptionerConfig, device=DEFAULT_DEVICE,
    gpt_params: dict | None = None,
) -> tuple[dict, dict]:
    """Returns (trainable, frozen) trees of float32 tensors on ``device`` (the
    card unless the caller asks for the CPU), drawn from ``generator`` with
    the distributions of the JAX package's init (the draws themselves differ
    from ``jax.random``).

    ``gpt_params`` is a GPT-2 tree in the port's layout — pretrained weights
    from :func:`models.porting.port_gpt2` of an HF state dict, or a JAX tree
    through :func:`models.porting.from_jax_numpy` — used in place of a random
    GPT-2 (the mapper's draws are the same either way).  The task prefix is
    seeded from its ``wte``; unfrozen, it is trained as a copy, so the
    caller's tensors never change."""
    device = resolve_device(device)
    mapping_params = M.init_mapping(generator, cfg.mapping)
    if gpt_params is None:
        gpt_params = tree_map(lambda t: t.to(device), G.init(generator, cfg.gpt2))
    else:
        G.check_params(gpt_params, cfg.gpt2)

        def take(t):
            out = torch.as_tensor(t).to(device=device, dtype=torch.float32)
            if not cfg.freeze_gpt_weights and out.data_ptr() == torch.as_tensor(t).data_ptr():
                out = out.clone()
            return out

        gpt_params = tree_map(take, gpt_params)
    trainable: dict[str, Any] = {"mapping": tree_map(lambda t: t.to(device), mapping_params)}
    if cfg.task_prompt_ids:
        ids = torch.tensor(cfg.task_prompt_ids, dtype=torch.long, device=device)
        trainable["task_prefix"] = gpt_params["wte"][ids]
    frozen: dict[str, Any] = {}
    if cfg.freeze_gpt_weights:
        frozen["gpt"] = gpt_params
    else:
        trainable["gpt"] = gpt_params
    return trainable, frozen


def _gpt(trainable: dict, frozen: dict) -> dict:
    return frozen["gpt"] if "gpt" in frozen else trainable["gpt"]


def partition_specs(cfg: CaptionerConfig) -> tuple[dict, dict]:
    """(trainable, frozen) trees of how each leaf is cut over tp (the JAX
    ``partition_specs``): GPT-2's by :func:`models.gpt2.partition_specs`
    wherever it lives; the mapper and the task prefix replicated (None),
    as ``mapping.py:188-211`` and ``captioner.py:103-119`` keep them."""
    trainable: dict[str, Any] = {"mapping": M.mapping_partition_specs(cfg.mapping)}
    if cfg.task_prompt_ids:
        trainable["task_prefix"] = None
    frozen: dict[str, Any] = {}
    (frozen if cfg.freeze_gpt_weights else trainable)["gpt"] = G.partition_specs(cfg.gpt2)
    return trainable, frozen


def shard_params(trainable: dict, frozen: dict, cfg: CaptionerConfig, mesh
                 ) -> tuple[dict, dict]:
    """This tp rank's (trainable, frozen) slices of full trees: GPT-2 cut by
    :func:`models.gpt2.shard_params`, every other leaf the tree's own tensor
    (so a train step's in-place update of the replicated leaves reaches the
    full trees).  The trees themselves without a tp axis."""
    def cut(tree):
        if "gpt" not in tree:
            return dict(tree)
        return {**tree, "gpt": G.shard_params(tree["gpt"], cfg.gpt2, mesh)}

    return cut(trainable), cut(frozen)


def gather_params(tree: dict, cfg: CaptionerConfig, mesh) -> dict:
    """A tree shaped like the trainable or frozen one with GPT-2's tp slices
    joined back whole (:func:`models.gpt2.gather_params`; every rank of the
    tp group must call) — the trainable tree, or AdamW moments over it, in
    the single-device layout."""
    if "gpt" not in tree:
        return tree
    return {**tree, "gpt": G.gather_params(tree["gpt"], cfg.gpt2, mesh)}


def build_prefix(trainable: dict, cfg: CaptionerConfig, image_embeddings: torch.Tensor,
                 policy: Policy = F32, use_kernels: bool | None = None) -> torch.Tensor:
    """Image embeddings → (B, total_prefix_length, gpt_dim) prefix tokens
    (mapping output ⧺ broadcast task prefix)."""
    prefix = M.apply_mapping(trainable["mapping"], cfg.mapping, image_embeddings, policy,
                             use_kernels)
    if "task_prefix" in trainable:
        b = image_embeddings.shape[0]
        task = trainable["task_prefix"].to(prefix.dtype).expand(b, *trainable["task_prefix"].shape)
        prefix = torch.cat([prefix, task], dim=1)
    return prefix


def loss_fn(
    trainable: dict,
    frozen: dict,
    cfg: CaptionerConfig,
    batch: dict,
    policy: Policy = F32,
    use_kernels: bool | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced caption loss → (nll_sum, token_count).

    batch: token_ids (B, L) int, labels (B, L) int with -100 on padding,
    attention_mask (B, L), image_embedding (B, E).  The prefix gets -100
    labels and mask 1; the first p_len - 1 shifted positions predict prefix
    tokens, so ``hidden[:, p_len-1:-1]`` is sliced statically before the
    vocab-chunked :func:`ops.xent.xent_sum` (ignored rows add nothing to the
    loss or the gradients).  ``use_kernels=False`` switches the flash kernel
    off in the mapper and GPT-2.  ``mesh``: a tp mesh whose rank's slices
    the trees are (:func:`shard_params`); the vocab-parallel
    :func:`ops.xent.xent_sum_tp` then gives the same sum on every tp rank.
    """
    gpt_params = _gpt(trainable, frozen)
    inputs = teacher_inputs(trainable, frozen, cfg, batch, policy, use_kernels, mesh)
    mask = key_mask(batch["attention_mask"], cfg.total_prefix_length)
    hidden = G.forward_hidden(gpt_params, cfg.gpt2, inputs, mask, policy, remat=cfg.remat,
                              use_kernels=use_kernels, mesh=mesh)
    return caption_nll(gpt_params, cfg, hidden, batch["labels"], policy, mesh)


def teacher_inputs(trainable: dict, frozen: dict, cfg: CaptionerConfig, batch: dict,
                   policy: Policy = F32, use_kernels: bool | None = None, mesh=None
                   ) -> torch.Tensor:
    """The teacher-forced forward's input embeddings (B, P + L, D): the
    prefix ⧺ the caption's token embeddings (positions not yet added)."""
    caption_embeds = G.embed_tokens(_gpt(trainable, frozen), batch["token_ids"].long(), mesh)
    prefix = build_prefix(trainable, cfg, batch["image_embedding"], policy, use_kernels)
    return torch.cat([prefix.to(caption_embeds.dtype), caption_embeds], dim=1)


def key_mask(attention_mask: torch.Tensor, p_len: int) -> torch.Tensor:
    """The caption's (B, L) key padding mask behind ``p_len`` prefix keys
    of 1."""
    ones = torch.ones((attention_mask.shape[0], p_len), dtype=attention_mask.dtype,
                      device=attention_mask.device)
    return torch.cat([ones, attention_mask], dim=1)


def caption_nll(gpt_params: dict, cfg: CaptionerConfig, hidden: torch.Tensor,
                labels: torch.Tensor, policy: Policy = F32, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ NLL, token count) of the caption ``labels`` (B, L) from the final
    LayerNorm's hidden states (B, P + L, D): positions P - 1 … P + L - 2
    predict them (the prefix's -100 labels never enter)."""
    p_len = hidden.shape[1] - labels.shape[1]
    h2 = policy.cast(hidden[:, p_len - 1 : -1, :]).reshape(-1, hidden.shape[-1])
    lab2 = labels.reshape(-1)
    wte = gpt_params["wte"].to(policy.compute_dtype)
    if tp_active(mesh):
        nll = xent_sum_tp(h2, wte, lab2, mesh, cfg.gpt2.vocab_size)
    else:
        nll = xent_sum(h2, wte, lab2)
    return nll, (lab2 != IGNORE_INDEX).sum()


def mean_loss(trainable: dict, frozen: dict, cfg: CaptionerConfig, batch: dict,
              policy: Policy = F32, use_kernels: bool | None = None, mesh=None
              ) -> torch.Tensor:
    s, c = loss_fn(trainable, frozen, cfg, batch, policy, use_kernels, mesh)
    return s / torch.clamp(c, min=1)


def prepare_decode_weights(trainable: dict, frozen: dict, cfg: CaptionerConfig,
                           policy: Policy = F32, quant: bool = False) -> dict:
    """The step kernels' weight layout (:func:`ops.decode_step.pack_decode_weights`;
    ``quant=True`` the W8A8 pack); compute it once per weight set and pass it
    to :func:`generate`."""
    return DS.pack_decode_weights(_gpt(trainable, frozen), policy.compute_dtype, quant=quant)


def _decode_pack(packed, gpt_params, policy: Policy, decode_quant: bool) -> dict:
    """The pack a decode runs from: ``packed`` if given, which must be int8
    exactly when ``decode_quant`` asks for int8, else a new one."""
    if packed is None:
        return DS.pack_decode_weights(gpt_params, policy.compute_dtype, quant=decode_quant)
    if ("qkvs" in packed) != decode_quant:
        raise ValueError(f"decode_quant={decode_quant} needs a pack with quant={decode_quant} "
                         "(prepare_decode_weights)")
    return packed


def prefill(gpt_params, cfg: CaptionerConfig, prefix, cache, policy: Policy, packed: dict,
            use: bool):
    """The prefill of a fresh cache → (first-token logits, cache): the
    prefill kernel (:func:`ops.prefill_step.prefill_into_cache`) from the
    float decode pack for a prefix of up to :data:`ops.prefill_step.MAX_PREFIX`
    tokens; ``gpt2.forward_cached`` for a longer prefix or with an int8 pack,
    where the JAX package keeps its XLA prefill (``captioner.py:291-316``)."""
    if "qkvs" in packed or prefix.shape[1] > PS.MAX_PREFIX:
        return G.forward_cached(gpt_params, cfg.gpt2, prefix, cache, policy, use)
    return PS.prefill_into_cache(packed, gpt_params, cfg.gpt2, prefix, cache, policy,
                                 use_kernel=use)


def _dp_rows(mesh, decode, image_embeddings: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """``decode(rows, generator)`` → tokens, run on this rank's contiguous
    rows of the batch (those of its dp index: a tp group decodes the same
    rows together) and gathered in dp order (every rank returns all B rows).
    A batch that dp does not divide is padded by repeating its last row, and
    the extra rows are dropped after the gather: rows decode independently,
    so the tokens are the single-device ones.  A sampled decode's dp index
    draws from a seed with that index folded in
    (:func:`ops.sampling.fold_seed`) over a base seed drawn from
    ``generator``, the same draw on every rank.  Without a mesh, or on a
    mesh whose dp is 1, ``decode`` takes the batch as is."""
    if mesh is None or mesh.dp == 1:
        return decode(image_embeddings, generator)
    from gpt2_image_captioning_tpu_torch.parallel.collectives import all_gather_batch

    b, dp = image_embeddings.shape[0], mesh.dp
    per = -(-b // dp)
    x = image_embeddings
    if per * dp != b:
        x = torch.cat([x, x[-1:].expand(per * dp - b, *x.shape[1:])])
    local = x[mesh.dp_rank * per:(mesh.dp_rank + 1) * per].to(mesh.device)
    if generator is not None:
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        generator = torch.Generator(device=mesh.device).manual_seed(
            fold_seed(base, mesh.dp_rank) & 0x7FFFFFFFFFFFFFFF)
    return all_gather_batch(mesh, decode(local, generator))[:b]


def _tp_options(mesh, decode_quant: bool, decode_quant_cache: bool = False,
                sample_in_kernel: bool = False) -> bool:
    """Whether ``mesh`` is tp; warns then for the options the layerwise
    branch does not take (module docstring), as the JAX package does."""
    if not tp_active(mesh):
        return False
    if decode_quant or decode_quant_cache:
        warnings.warn("decode_quant / decode_quant_cache do not apply to the tensor-parallel "
                      "decode: it runs at the trees' precision", RuntimeWarning, stacklevel=3)
    if sample_in_kernel:
        warnings.warn("sample_in_kernel does not apply to the tensor-parallel decode; sampling "
                      "from the gathered logits instead", stacklevel=3)
    return True


@torch.no_grad()
def generate(
    trainable: dict,
    frozen: dict,
    cfg: CaptionerConfig,
    image_embeddings: torch.Tensor,
    *,
    max_length: int = 50,
    temperature: float = 1.0,
    top_p: float = 0.9,
    generator: torch.Generator | None = None,
    policy: Policy = F32,
    use_kernels: bool | None = None,
    packed: dict | None = None,
    mesh=None,
    sample_in_kernel: bool = False,
    sample_k: int = 3,
    decode_quant: bool = False,
    decode_quant_cache: bool = False,
) -> torch.Tensor:
    """Caption generation → token ids (B, max_length) int32, padded with EOS
    after each row's first EOS; the loop stops once every row has emitted EOS.

    ``temperature == 0`` decodes greedily (the argmax kernel ends each step).
    Otherwise every token is drawn by :func:`ops.sampling.sample_token` at
    ``temperature`` and ``top_p``: the first from the prefill's logits, each
    later one from the logits its step emits.  ``generator`` is the source of
    the draws and must live on the embeddings' device; None seeds one with 0
    there, as the JAX package defaults to ``PRNGKey(0)`` (the draws differ
    from ``jax.random``'s; the nucleus does not).

    ``sample_in_kernel=True`` (sampled decoding, ``top_p >= 0.5``) draws every
    token after the first inside the step by speculative accept
    (:func:`ops.sampling.sample_step_plain`, ``sample_k`` candidates): the
    (B, V) logits are never stored.  Its per-step seeds are drawn from
    ``generator`` once, after the first token (one host read); the first
    token is drawn from the prefill's logits by ``sample_token`` as without
    it.  At ``top_p < 0.5`` it warns and samples from the emitted logits, as
    the JAX package does: small nuclei make speculative accept retry often.

    ``decode_quant=True``: every decode step runs W8A8 (the int8 pack, from
    ``packed`` or made here), in every mode.  ``decode_quant_cache=True``:
    the prefilled cache is quantized once (:func:`ops.quant.quantize_cache`)
    and each step appends int8 rows with their scales; with it,
    ``sample_in_kernel`` warns and samples from the emitted logits, as the
    JAX package does (the in-kernel draw has no int8-cache variant).

    ``use_kernels``: None runs the CUDA kernels for CUDA inputs and their
    plain twins on the CPU; False runs the plain path (every kernel off, the
    mapper's and the prefill's attention included); True on the CPU raises.
    ``packed``: weights from :func:`prepare_decode_weights` (int8 exactly
    when ``decode_quant``), reused across calls.

    ``mesh``: a :class:`core.mesh.Mesh`, the same call on every rank; each
    dp index decodes its rows on its device and every rank returns the
    (B, max_length) tokens (:func:`_dp_rows`).  With ``tp`` > 1 the trees
    are the rank's slices (:func:`shard_params`) and the decode is the
    layerwise one (module docstring).
    """
    tp = _tp_options(mesh, decode_quant, decode_quant_cache, sample_in_kernel and temperature != 0)

    def decode(rows, gen):
        if tp:
            return _generate_tp(trainable, frozen, cfg, rows, max_length=max_length,
                                temperature=temperature, top_p=top_p, generator=gen,
                                policy=policy, use_kernels=use_kernels, mesh=mesh)
        return _generate(trainable, frozen, cfg, rows, max_length=max_length,
                         temperature=temperature, top_p=top_p, generator=gen, policy=policy,
                         use_kernels=use_kernels, packed=packed,
                         sample_in_kernel=sample_in_kernel, sample_k=sample_k,
                         decode_quant=decode_quant, decode_quant_cache=decode_quant_cache)

    if temperature == 0.0:
        generator = None  # greedy draws nothing
    elif generator is None:
        generator = torch.Generator(device=image_embeddings.device).manual_seed(0)
    return _dp_rows(mesh, decode, image_embeddings, generator)


def _generate(trainable, frozen, cfg, image_embeddings, *, max_length, temperature, top_p,
              generator, policy, use_kernels, packed, sample_in_kernel, sample_k,
              decode_quant, decode_quant_cache) -> torch.Tensor:
    """The single-device decode of :func:`generate`."""
    gpt_params = _gpt(trainable, frozen)
    eos = cfg.eos_token_id
    cdt = policy.compute_dtype
    device = image_embeddings.device
    use = DS.fused_greedy_enabled(use_kernels, device)
    packed = _decode_pack(packed, gpt_params, policy, decode_quant)
    greedy = temperature == 0.0
    in_kernel = sample_in_kernel and not greedy
    if in_kernel and (top_p < 0.5 or decode_quant_cache):
        why = (f"needs top_p >= 0.5 (got {top_p}): smaller nuclei reject most speculative "
               "candidates" if top_p < 0.5 else "has no int8-KV-cache variant")
        warnings.warn(f"sample_in_kernel {why}; sampling from the emitted logits instead",
                      stacklevel=2)
        in_kernel = False

    def select(logits):
        return sample_token(logits, temperature=temperature, top_p=top_p, generator=generator)

    prefix = build_prefix(trainable, cfg, image_embeddings, policy, use)
    b, p_len, _ = prefix.shape
    cache = G.init_cache(cfg.gpt2, b, p_len + max_length, dtype=cdt, device=prefix.device)
    logits, cache = prefill(gpt_params, cfg, prefix, cache, policy, packed, use)
    k_cache, v_cache, scales = cache["k"], cache["v"], {}
    if decode_quant_cache:
        k_cache, v_cache, ks, vs = DS.quantize_cache(k_cache, v_cache)
        scales = {"k_scale": ks, "v_scale": vs}

    nxt = select(logits)
    finished = nxt == eos
    tokens = torch.full((b, max_length), eos, dtype=torch.int32, device=prefix.device)
    tokens[:, 0] = nxt
    wte, wpe = gpt_params["wte"], gpt_params["wpe"]
    index = cache["index"]
    if in_kernel:
        seeds = torch.randint(0, 2 ** 62, (max_length,), generator=generator,
                              device=generator.device).tolist()
        temps = torch.full((b,), temperature, device=device)
        topps = torch.full((b,), top_p, device=device)
    mode = {}
    step = 1
    while step < max_length and not bool(finished.all()):
        x0 = (wte[nxt.long()] + wpe[index]).to(cdt)
        if in_kernel:
            mode = {"sample": {"temp": temps, "top_p": topps, "seed": seeds[step]},
                    "sample_k": sample_k}
        out = DS.fused_decode_step(
            packed, x0, k_cache, v_cache, index, n_head=cfg.gpt2.n_head,
            eps=cfg.gpt2.layer_norm_epsilon, emit_logits=not greedy and not in_kernel,
            use_kernels=use, **mode, **scales,
        )[0]
        nxt = out if greedy or in_kernel else select(out)
        finished = finished | (nxt == eos)
        nxt = torch.where(finished, eos, nxt).to(torch.int32)
        tokens[:, step] = nxt
        step += 1
        index += 1
    return tokens


def _generate_tp(trainable, frozen, cfg, image_embeddings, *, max_length, temperature, top_p,
                 generator, policy, use_kernels, mesh) -> torch.Tensor:
    """The tensor-parallel decode of :func:`generate` (the JAX layerwise
    branch): the prefill and each step through ``gpt2.forward_cached`` on
    the rank's heads and cache; the gathered logits select the tokens."""
    gpt_params = _gpt(trainable, frozen)
    G.check_params(gpt_params, cfg.gpt2, mesh)
    eos, cdt = cfg.eos_token_id, policy.compute_dtype
    prefix = build_prefix(trainable, cfg, image_embeddings, policy, use_kernels)
    b, p_len, _ = prefix.shape
    cache = G.init_cache(cfg.gpt2, b, p_len + max_length, dtype=cdt, device=prefix.device,
                         mesh=mesh)
    logits, cache = G.forward_cached(gpt_params, cfg.gpt2, prefix, cache, policy, use_kernels,
                                     mesh=mesh)
    tokens = torch.full((b, max_length), eos, dtype=torch.int32, device=prefix.device)
    finished = torch.zeros((b,), dtype=torch.bool, device=prefix.device)
    for step in range(max_length):
        nxt = sample_token(logits, temperature=temperature, top_p=top_p, generator=generator)
        finished = finished | (nxt == eos)
        nxt = torch.where(finished, eos, nxt).to(torch.int32)
        tokens[:, step] = nxt
        # every rank holds the same gathered logits, so the same exit
        if step == max_length - 1 or bool(finished.all()):
            break
        x = G.embed_tokens(gpt_params, nxt[:, None].long(), mesh).to(cdt)
        logits, cache = G.forward_cached(gpt_params, cfg.gpt2, x, cache, policy, use_kernels,
                                         mesh=mesh)
    return tokens


# ---------------------------------------------------------------------------
# Continuous batching (rolling admission): segment decode + admission prefill.
# The host-driven reference primitives; the on-device engine is
# models/continuous.py::macro_step.
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_segment(packed: dict, wte: torch.Tensor, wpe: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, idx: int, start: torch.Tensor, prev: torch.Tensor,
                   finished: torch.Tensor, *, cfg: CaptionerConfig, steps: int,
                   policy: Policy = F32, use_kernels: bool | None = None):
    """Run ``steps`` decode steps on a live continuous-serving batch.

    Caches ``k``/``v`` (L, Tmax, S, D) are updated in place; every row
    appends at the shared position ``idx`` (a host int) and attends only its
    window ``[start_r, idx)`` (``start`` (S,) int32), at the LOCAL position
    ``idx - start_r``; ``prev`` (S,) int32 are the previous tokens and
    ``finished`` (S,) bool the rows past EOS, which keep stepping on EOS
    padding.  Returns ``(tokens (S, steps) int32, k, v, idx + steps, prev',
    finished')``.
    """
    eos = cfg.eos_token_id
    toks = []
    for _ in range(steps):
        local = (idx - start).long()
        x0 = (wte[prev.long()] + wpe[local]).to(policy.compute_dtype)
        nxt, _, _ = DS.fused_decode_step(
            packed, x0, k, v, idx, n_head=cfg.gpt2.n_head, eps=cfg.gpt2.layer_norm_epsilon,
            start=start, use_kernels=use_kernels,
        )
        finished = finished | (nxt == eos)
        prev = torch.where(finished, eos, nxt).to(torch.int32)
        toks.append(prev)
        idx += 1
    return torch.stack(toks, dim=1), k, v, idx, prev, finished


@torch.no_grad()
def admit_prefill(trainable: dict, frozen: dict, cfg: CaptionerConfig, emb: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, idx: int, rows: torch.Tensor,
                  valid: torch.Tensor, *, policy: Policy = F32,
                  use_kernels: bool | None = None, packed: dict):
    """Admit up to n requests into freed rows of a live decode batch — the
    admission :func:`models.continuous.macro_step` runs at every burst.

    ``emb`` (n, E) → mapper prefix (n, P, D) → prefill with LOCAL positions;
    the K/V rows land in cache positions ``[idx - P, idx)`` of rows ``rows``
    (n,) distinct (an indexed write in place), so the admitted rows join the
    shared append position ``idx``; their start is ``idx - P``.  The prefill
    runs from ``packed`` (the engine's decode pack), as :func:`generate`'s
    does.  ``valid`` (n,) bool masks
    padding entries, whose rows keep their values: padding
    may name any rows the valid entries do not, live ones included, and may
    be every entry, so a caller that counts its admissions on the device
    never reads that count.  (The JAX function's padding instead repeats
    ``rows[0]``.)  Returns ``(logits (n, V) float32, k, v)``: each request's
    prefill logits, whose argmax is its first greedy token.
    """
    gpt_params = _gpt(trainable, frozen)
    use = DS.fused_greedy_enabled(use_kernels, emb.device)
    prefix = build_prefix(trainable, cfg, emb, policy, use)
    n, p, _ = prefix.shape
    cache_n = G.init_cache(cfg.gpt2, n, p, dtype=policy.compute_dtype, device=emb.device)
    logits, cache_n = prefill(gpt_params, cfg, prefix, cache_n, policy, packed, use)
    rows = rows.long()
    keep = valid[None, None, :, None]
    for cache, new in ((k, cache_n["k"]), (v, cache_n["v"])):
        win = cache[:, idx - p : idx]  # (L, P, S, D), a view
        win[:, :, rows] = torch.where(keep, new[:, :p].to(cache.dtype), win[:, :, rows])
    return logits, k, v


def _beam_select(scores, finished, vals, tok_k, lse, k: int, eos: int):
    """The union of each beam's top-k (the JAX package's ``select``): every
    global top-k candidate is in its own beam's top-k, so the K·K survivors
    replace the (B, K·V) candidate tensor.  Candidates are beam-major and
    both top-k stages take the lowest index on ties, which is the flat
    (beam, token) order.  Returns (new scores, parent beam, token), each
    (B, K)."""
    b = scores.shape[0]
    logp = (vals - lse).reshape(b, k, k)
    tok_k = tok_k.reshape(b, k, k).clone()
    # a finished beam may only continue with EOS, at no change of score
    logp = torch.where(finished[:, :, None], NEG_INF, logp)
    logp[:, :, 0] = torch.where(finished, 0.0, logp[:, :, 0])
    tok_k[:, :, 0] = torch.where(finished, eos, tok_k[:, :, 0])
    new_scores, ci = topk_small((scores[..., None] + logp).reshape(b, k * k), k)
    ci = ci.long()
    return new_scores, ci // k, tok_k.reshape(b, k * k).gather(1, ci)


@torch.no_grad()
def beam_generate(
    trainable: dict,
    frozen: dict,
    cfg: CaptionerConfig,
    image_embeddings: torch.Tensor,
    *,
    max_length: int = 50,
    beam_size: int = 4,
    length_penalty: float = 1.0,
    policy: Policy = F32,
    use_kernels: bool | None = None,
    packed: dict | None = None,
    mesh=None,
    decode_quant: bool = False,
) -> torch.Tensor:
    """Length-normalised beam search → the best beam's token ids
    (B, max_length) int32, EOS-padded after its EOS.

    The B·K beams are rows of one batch, beam-major.  The B images are
    prefilled once and their cache rows and logits repeated K times, as the
    JAX package's fused prefill does (with an int8 pack the expanded prefix
    is prefilled, as there); each step then selects the union of the beams'
    top-k, carries the beam state along the chosen parents and decodes the chosen
    tokens, whose attention reads the history through an ancestry map
    (``origin``) instead of a gathered cache; the image prefix, shared by
    every beam of an image, is read directly (``gather_start = p_len``).
    The search runs a fixed ``max_length`` steps, as the JAX scan does (the
    last step's forward, whose outputs nothing reads, is skipped).  Score =
    sum log-prob / length ** ``length_penalty``, lengths counting tokens up
    to and including EOS.  Any batch and ``beam_size`` <= 16 run on the
    kernels.  ``use_kernels``, ``packed`` and ``decode_quant`` (W8A8 steps;
    the prefill stays at the compute precision) as in :func:`generate`.
    ``mesh``: each dp index searches its images' beam groups and every rank
    returns the (B, max_length) tokens, as in :func:`generate`; with ``tp``
    > 1 the trees are the rank's slices and the search steps
    ``gpt2.forward_cached`` on the rank's heads (the JAX layerwise branch;
    ``decode_quant`` warns and does not apply, as there).
    """
    tp = _tp_options(mesh, decode_quant)

    def decode(rows, _):
        beams = _beam_search(trainable, frozen, cfg, rows, max_length=max_length,
                             beam_size=beam_size, policy=policy, use_kernels=use_kernels,
                             packed=packed, decode_quant=decode_quant,
                             mesh=mesh if tp else None)
        return _best_beam(*beams, length_penalty=length_penalty)[0]

    return _dp_rows(mesh, decode, image_embeddings)


def _best_beam(tokens, scores, lengths, *, length_penalty: float):
    """The length-normalised pick: (B, K, L) beams, (B, K) summed log-probs
    and lengths → (the best beam's tokens (B, L), its score (B,))."""
    norm = torch.pow(torch.clamp(lengths, min=1).float(), length_penalty)
    normalised = scores / norm
    best = torch.argmax(normalised, dim=1)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return tokens[rows, best], normalised[rows, best]


@torch.no_grad()
def _beam_search(trainable, frozen, cfg, image_embeddings, *, max_length: int, beam_size: int,
                 policy: Policy, use_kernels: bool | None, packed: dict | None,
                 decode_quant: bool = False, mesh=None):
    """The search of :func:`beam_generate`: every beam's tokens (B, K, L)
    int32, summed log-probs (B, K) float32 and lengths (B, K) int32 (tokens
    up to and including EOS; ``max_length`` for a beam that never ended).
    ``mesh``: a tp mesh, whose steps run ``gpt2.forward_cached`` on the
    rank's slices instead of the step kernels."""
    gpt_params = _gpt(trainable, frozen)
    eos, k = cfg.eos_token_id, beam_size
    cdt = policy.compute_dtype
    use = DS.fused_greedy_enabled(use_kernels, image_embeddings.device)
    if mesh is None:
        packed = _decode_pack(packed, gpt_params, policy, decode_quant)
    else:
        G.check_params(gpt_params, cfg.gpt2, mesh)

    prefix = build_prefix(trainable, cfg, image_embeddings, policy, use)
    b, p_len, _ = prefix.shape
    dev = prefix.device
    cache = G.init_cache(cfg.gpt2, b * k, p_len + max_length, dtype=cdt, device=dev, mesh=mesh)
    # every beam of an image is the image's prefix before the first token: the
    # B images are prefilled once and repeated K times, as the reference's
    # fused branch; its int8 branch prefills every beam's row
    rep = k if mesh is None and "qkvs" in packed else 1
    cache_p = G.init_cache(cfg.gpt2, b * rep, p_len, dtype=cdt, device=dev, mesh=mesh)
    if mesh is None:
        logits, cache_p = prefill(gpt_params, cfg, prefix.repeat_interleave(rep, dim=0),
                                  cache_p, policy, packed, use)
    else:
        logits, cache_p = G.forward_cached(gpt_params, cfg.gpt2, prefix, cache_p, policy, use,
                                           mesh=mesh)
    for name in ("k", "v"):
        cache[name][:, :p_len] = cache_p[name][:, :p_len].repeat_interleave(k // rep, dim=2)
    cache["index"] = p_len
    logits = logits.repeat_interleave(k // rep, dim=0)
    lf = logits.float()
    vals, tok_k = topk_small(lf, k)
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)

    # only beam 0 is live at first, so the first step does not duplicate beams
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((b, k, max_length), eos, dtype=torch.int32, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
    rows = torch.arange(b * k, dtype=torch.int32, device=dev)
    origin = rows.expand(cache["k"].shape[1], b * k).contiguous()
    group = torch.arange(b, device=dev)[:, None]
    wte, wpe = gpt_params["wte"], gpt_params["wpe"]
    for step in range(max_length):
        scores, parent, tok = _beam_select(scores, finished, vals, tok_k, lse, k, eos)
        tokens = tokens[group, parent]
        tokens[:, :, step] = tok
        was_finished = finished[group, parent]
        lengths = torch.where(was_finished, lengths[group, parent], step + 1)
        finished = was_finished | (tok == eos)
        if step == max_length - 1:
            break
        # new row r descends from row (image, parent): it inherits that row's
        # history through the map and appends its own K/V row at idx
        idx = p_len + step
        origin = origin[:, (group * k + parent).reshape(-1)]
        origin[idx] = rows
        if mesh is not None:
            x = G.embed_tokens(gpt_params, tok.reshape(-1, 1).long(), mesh).to(cdt)
            cache["index"] = idx
            lf, cache = G.forward_cached(gpt_params, cfg.gpt2, x, cache, policy, use, mesh=mesh,
                                         origin=origin, gather_start=p_len)
            vals, tok_k = topk_small(lf, k)
            lse = torch.logsumexp(lf, dim=-1, keepdim=True)
            continue
        x0 = (wte[tok.reshape(-1).long()] + wpe[idx]).to(cdt)
        vals, tok_k, lse, _, _ = DS.fused_decode_step(
            packed, x0, cache["k"], cache["v"], idx, n_head=cfg.gpt2.n_head,
            eps=cfg.gpt2.layer_norm_epsilon, topk=k, origin=origin, beam_k=k,
            gather_start=p_len, use_kernels=use,
        )
    return tokens, scores, torch.where(finished, lengths, max_length)


class ImageCaptioningModel:
    """Stateful façade with the JAX package's surface: forward, generate,
    generate_captions, decode_params, save_parameters and
    load_saved_parameters.  ``generator`` seeds the random init; ``device``
    holds the parameters and runs the model: the card unless the caller
    asks for the CPU; ``gpt_params`` is a GPT-2 tree used in place of the
    random one (:func:`init_params`).

    The decode copies (the bfloat16 trees of :meth:`decode_params` and the
    step kernels' packs of :meth:`decode_pack`) are cached on the identity of
    the live trees.  A weight swap (``load_saved_parameters``, a new tree)
    renews them; code that changes the live tensors in place, as the train
    step does, calls :meth:`drop_decode_caches` afterwards.
    """

    def __init__(
        self,
        cfg: CaptionerConfig,
        tokenizer=None,
        generator: torch.Generator | None = None,
        policy: Policy = F32,
        device=DEFAULT_DEVICE,
        gpt_params: dict | None = None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.policy = policy
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.trainable, self.frozen = init_params(generator, cfg, self.device, gpt_params)

    def forward(
        self,
        batch: dict | None = None,
        *,
        caption_token_ids=None,
        image_embeddings=None,
        attention_mask=None,
        labels=None,
    ) -> torch.Tensor:
        """Teacher-forced mean loss (:func:`mean_loss`) of a batch dict
        (token_ids, labels, attention_mask, image_embedding) or of the
        reference's keyword signature, where the mask defaults to ones and
        the labels to the token ids.  Arrays or tensors, moved to the
        model's device."""
        if batch is None:
            if attention_mask is None:
                attention_mask = torch.ones_like(torch.as_tensor(caption_token_ids))
            if labels is None:
                labels = caption_token_ids
            batch = {"token_ids": caption_token_ids, "labels": labels,
                     "attention_mask": attention_mask, "image_embedding": image_embeddings}
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
                 if k != "image_id"}
        return mean_loss(self.trainable, self.frozen, self.cfg, batch, self.policy)

    def generate(
        self,
        image_embeddings,
        max_length: int = 50,
        temperature: float = 1.0,
        top_p: float = 0.9,
        generator: torch.Generator | None = None,
        decode_precision: str | None = None,
        mesh=None,
        use_kernels: bool | None = None,
    ) -> torch.Tensor:
        """Top-p sampling at ``temperature`` by default, greedy at
        ``temperature=0.0`` (the module-level :func:`generate`; ``generator``
        on the model's device draws the tokens, seeded with 0 when None).
        ``decode_precision="bf16"`` decodes from a cached bfloat16 copy of the
        weights (half the bytes each step reads); ``"int8"`` decodes from that
        copy through the W8A8 pack (int8 weights and per-row int8
        activations, half the bytes again); None/"f32" keeps the float32
        parameters.  The packs are cached per precision, so bf16 and int8
        requests on one model both stay warm."""
        tr, fz, pol, packed, quant = self.decode_pack(decode_precision, mesh)
        emb = torch.as_tensor(image_embeddings, dtype=torch.float32, device=self.device)
        return generate(
            tr, fz, self.cfg, emb, max_length=max_length, temperature=temperature, top_p=top_p,
            generator=generator, policy=pol, use_kernels=use_kernels, packed=packed,
            mesh=mesh, decode_quant=quant,
        )

    def decode_pack(self, decode_precision: str | None = None, mesh=None):
        """(trainable, frozen, policy, packed, quant) for a decode at
        ``decode_precision``: :meth:`decode_params`' trees ("int8" decodes
        from the bfloat16 copy) and the step kernels' pack of them
        (:func:`prepare_decode_weights`, W8A8 when ``quant``), cached per
        precision and renewed when the trees are.  Under a tp ``mesh``: the
        rank's slices of those trees (:func:`shard_params`, cached likewise)
        and no pack, which the tensor-parallel decode does not read."""
        quant = decode_precision == "int8"
        tr, fz, pol = self.decode_params("bf16" if quant else decode_precision)
        if tp_active(mesh):
            cache = getattr(self, "_shard_cache", None)
            if cache is None or any(a is not b for a, b in zip(cache, (tr, fz, mesh))):
                cache = (tr, fz, mesh, shard_params(tr, fz, self.cfg, mesh))
                self._shard_cache = cache
            return (*cache[3], pol, None, quant)
        cache = getattr(self, "_packed_cache", None)
        if cache is None or cache[0] is not tr or cache[1] is not fz or cache[2] is not pol:
            cache = (tr, fz, pol, {})
            self._packed_cache = cache
        if quant not in cache[3]:
            cache[3][quant] = prepare_decode_weights(tr, fz, self.cfg, pol, quant=quant)
        return tr, fz, pol, cache[3][quant], quant

    def drop_decode_caches(self) -> None:
        """Forget the bfloat16 copy, the packs and the tp slices: the next
        decode rebuilds them from the live trees."""
        self._bf16_cache = None
        self._packed_cache = None
        self._shard_cache = None

    def decode_params(self, decode_precision: str | None = None):
        """(trainable, frozen, policy) for inference at the given precision.
        ``"bf16"`` returns a cached bfloat16 copy, rebuilt when the live
        parameter trees are replaced."""
        if decode_precision in (None, "f32"):
            return self.trainable, self.frozen, self.policy
        if decode_precision != "bf16":
            raise ValueError(f"decode_precision must be 'f32' or 'bf16', got {decode_precision!r}")
        cache = getattr(self, "_bf16_cache", None)
        if cache is None or cache[0] is not self.trainable or cache[1] is not self.frozen:
            self._bf16_cache = (
                self.trainable, self.frozen,
                cast_floating(self.trainable), cast_floating(self.frozen),
            )
        return self._bf16_cache[2], self._bf16_cache[3], BF16

    def generate_captions(self, image_embeddings, **kw) -> list[str]:
        ids = self.generate(image_embeddings, **kw)
        return self.tokenizer.batch_decode(ids.cpu().numpy(), skip_special_tokens=True)

    def save_parameters(self, output_path: str) -> None:
        """The trainable tree to ``.pt`` (reference names) or ``.npz``
        (:func:`train.checkpoint.save_captioner`)."""
        from gpt2_image_captioning_tpu_torch.train import checkpoint

        checkpoint.save_captioner(output_path, self.trainable, self.cfg)

    def load_saved_parameters(self, checkpoint_path: str) -> None:
        """Replace the trainable tree by a checkpoint's; the decode copies
        go with the old weights."""
        from gpt2_image_captioning_tpu_torch.train import checkpoint

        self.trainable = checkpoint.load_captioner(checkpoint_path, self.trainable, self.cfg)
        self.drop_decode_caches()
