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

Not ported yet, and refused rather than run another way: meshes (see
ROADMAP.md), and prefixes longer than the prefill kernel's
:data:`ops.prefill_step.MAX_PREFIX` tokens (the reference's gate).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32, Policy, cast_floating
from gpt2_image_captioning_tpu_torch.core.tree import tree_map
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.models import mapping as M
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.ops import prefill_step as PS
from gpt2_image_captioning_tpu_torch.ops.sampling import NEG_INF, sample_token, topk_small
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX, xent_sum


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
) -> tuple[dict, dict]:
    """Returns (trainable, frozen) trees of float32 tensors on ``device`` (the
    card unless the caller asks for the CPU), drawn from ``generator`` with
    the distributions of the JAX package's init (the draws themselves differ
    from ``jax.random``)."""
    device = resolve_device(device)
    mapping_params = M.init_mapping(generator, cfg.mapping)
    gpt_params = G.init(generator, cfg.gpt2)
    trainable: dict[str, Any] = {"mapping": mapping_params}
    if cfg.task_prompt_ids:
        ids = torch.tensor(cfg.task_prompt_ids, dtype=torch.long, device=gpt_params["wte"].device)
        trainable["task_prefix"] = gpt_params["wte"][ids]
    frozen: dict[str, Any] = {}
    if cfg.freeze_gpt_weights:
        frozen["gpt"] = gpt_params
    else:
        trainable["gpt"] = gpt_params
    return tree_map(lambda t: t.to(device), trainable), tree_map(lambda t: t.to(device), frozen)


def _gpt(trainable: dict, frozen: dict) -> dict:
    return frozen["gpt"] if "gpt" in frozen else trainable["gpt"]


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced caption loss → (nll_sum, token_count).

    batch: token_ids (B, L) int, labels (B, L) int with -100 on padding,
    attention_mask (B, L), image_embedding (B, E).  The prefix gets -100
    labels and mask 1; the first p_len - 1 shifted positions predict prefix
    tokens, so ``hidden[:, p_len-1:-1]`` is sliced statically before the
    vocab-chunked :func:`ops.xent.xent_sum` (ignored rows add nothing to the
    loss or the gradients).  ``use_kernels=False`` switches the flash kernel
    off in the mapper and GPT-2.
    """
    gpt_params = _gpt(trainable, frozen)
    caption_embeds = G.embed_tokens(gpt_params, batch["token_ids"].long())
    prefix = build_prefix(trainable, cfg, batch["image_embedding"], policy, use_kernels)
    b, p_len = prefix.shape[:2]
    inputs = torch.cat([prefix.to(caption_embeds.dtype), caption_embeds], dim=1)
    labels = torch.cat([
        torch.full((b, p_len), IGNORE_INDEX, dtype=batch["labels"].dtype, device=prefix.device),
        batch["labels"],
    ], dim=1)
    mask = batch["attention_mask"]
    mask = torch.cat([torch.ones((b, p_len), dtype=mask.dtype, device=mask.device), mask], dim=1)
    hidden = G.forward_hidden(gpt_params, cfg.gpt2, inputs, mask, policy, remat=cfg.remat,
                              use_kernels=use_kernels)
    h2 = policy.cast(hidden[:, p_len - 1 : -1, :]).reshape(-1, hidden.shape[-1])
    lab2 = labels[:, p_len:].reshape(-1)
    nll = xent_sum(h2, gpt_params["wte"].to(policy.compute_dtype), lab2)
    return nll, (lab2 != IGNORE_INDEX).sum()


def mean_loss(trainable: dict, frozen: dict, cfg: CaptionerConfig, batch: dict,
              policy: Policy = F32, use_kernels: bool | None = None) -> torch.Tensor:
    s, c = loss_fn(trainable, frozen, cfg, batch, policy, use_kernels)
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
    float decode pack, which refuses a prefix longer than
    :data:`ops.prefill_step.MAX_PREFIX`; ``gpt2.forward_cached`` with an int8
    pack, where the JAX package keeps its XLA prefill (``captioner.py:291-303``)."""
    if "qkvs" in packed:
        return G.forward_cached(gpt_params, cfg.gpt2, prefix, cache, policy, use)
    return PS.prefill_into_cache(packed, gpt_params, cfg.gpt2, prefix, cache, policy,
                                 use_kernel=use)


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded decode is not ported yet (ROADMAP.md, queue 1, item 13: parallelism)"
        )


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
    """
    _refuse_mesh(mesh)
    gpt_params = _gpt(trainable, frozen)
    eos = cfg.eos_token_id
    cdt = policy.compute_dtype
    device = image_embeddings.device
    use = DS.fused_greedy_enabled(use_kernels, device)
    packed = _decode_pack(packed, gpt_params, policy, decode_quant)
    greedy = temperature == 0.0
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
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
    """
    _refuse_mesh(mesh)
    beams = _beam_search(trainable, frozen, cfg, image_embeddings, max_length=max_length,
                         beam_size=beam_size, policy=policy, use_kernels=use_kernels,
                         packed=packed, decode_quant=decode_quant)
    return _best_beam(*beams, length_penalty=length_penalty)[0]


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
                 decode_quant: bool = False):
    """The search of :func:`beam_generate`: every beam's tokens (B, K, L)
    int32, summed log-probs (B, K) float32 and lengths (B, K) int32 (tokens
    up to and including EOS; ``max_length`` for a beam that never ended)."""
    gpt_params = _gpt(trainable, frozen)
    eos, k = cfg.eos_token_id, beam_size
    cdt = policy.compute_dtype
    use = DS.fused_greedy_enabled(use_kernels, image_embeddings.device)
    packed = _decode_pack(packed, gpt_params, policy, decode_quant)

    prefix = build_prefix(trainable, cfg, image_embeddings, policy, use)
    b, p_len, _ = prefix.shape
    dev = prefix.device
    cache = G.init_cache(cfg.gpt2, b * k, p_len + max_length, dtype=cdt, device=dev)
    # every beam of an image is the image's prefix before the first token: the
    # B images are prefilled once and repeated K times, as the reference's
    # fused branch; its int8 branch prefills every beam's row
    rep = k if "qkvs" in packed else 1
    cache_p = G.init_cache(cfg.gpt2, b * rep, p_len, dtype=cdt, device=dev)
    logits, cache_p = prefill(gpt_params, cfg, prefix.repeat_interleave(rep, dim=0), cache_p,
                              policy, packed, use)
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
    asks for the CPU.

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
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.policy = policy
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.trainable, self.frozen = init_params(generator, cfg, self.device)

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
        tr, fz, pol, packed, quant = self.decode_pack(decode_precision)
        emb = torch.as_tensor(image_embeddings, dtype=torch.float32, device=self.device)
        return generate(
            tr, fz, self.cfg, emb, max_length=max_length, temperature=temperature, top_p=top_p,
            generator=generator, policy=pol, use_kernels=use_kernels, packed=packed,
            mesh=mesh, decode_quant=quant,
        )

    def decode_pack(self, decode_precision: str | None = None):
        """(trainable, frozen, policy, packed, quant) for a decode at
        ``decode_precision``: :meth:`decode_params`' trees ("int8" decodes
        from the bfloat16 copy) and the step kernels' pack of them
        (:func:`prepare_decode_weights`, W8A8 when ``quant``), cached per
        precision and renewed when the trees are."""
        quant = decode_precision == "int8"
        tr, fz, pol = self.decode_params("bf16" if quant else decode_precision)
        cache = getattr(self, "_packed_cache", None)
        if cache is None or cache[0] is not tr or cache[1] is not fz or cache[2] is not pol:
            cache = (tr, fz, pol, {})
            self._packed_cache = cache
        if quant not in cache[3]:
            cache[3][quant] = prepare_decode_weights(tr, fz, self.cfg, pol, quant=quant)
        return tr, fz, pol, cache[3][quant], quant

    def drop_decode_caches(self) -> None:
        """Forget the bfloat16 copy and the packs: the next decode rebuilds
        them from the live trees."""
        self._bf16_cache = None
        self._packed_cache = None

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
