"""The continuous-batching engine: rolling admission inside a macro step —
the counterpart of ``gpt2_image_captioning_tpu/models/continuous.py``
(``init_state``, ``macro_step``).

A macro step runs ``bursts`` × (admission from a staged request block, then
``segment`` decode steps) over a fixed pool of ``slots`` rows, and returns
one packed int32 matrix of (tokens, row uids, admitted first tokens,
admitted uids) per step, so the host learns everything from one copy per
macro.  Every row appends at one shared cache position ``idx``; an admitted
request's prefix K/V land in its row's past positions ``[idx - P, idx)``
and the step attends each row's own window ``[start_r, idx)`` (the
``start`` mode of :func:`ops.decode_step.fused_decode_step`).  Finished rows
hold ``start = idx``, so their window is empty and compaction at macro entry
(every window shifted down by the smallest live start) stays tight.

The JAX engine is one compiled program.  Here it is a Python loop of
``bursts · segment`` steps whose admission bookkeeping (which rows are free,
how many requests to take, where each lands) stays on the device: the only
host read of a macro is the compaction shift at its entry, because the
kernels take ``idx`` as a host int.  ``idx`` and the step counter ``t`` are
host ints in the state; everything else is tensors on the pool's device.
The TPU's dense one-hot placement matmul and its cache-copy-free ``cond``
are not carried over: on the GPU an indexed write into the cache window is
cheap.  Sampling noise is keyed off the monotone step counter ``t`` (decode
steps ``2t``, the burst's admission point ``2t + 1``), never off the
rebased ``idx``, so compaction cannot replay or shift it.

Under a dp mesh the pool splits into ``dp`` sub-pools, one a rank
(:func:`init_state_dp`, :func:`macro_step_dp`); each runs this engine on its
own rows and only the packed output is gathered.
"""

from __future__ import annotations

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.models.captioner import CaptionerConfig, _gpt, admit_prefill
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.ops.sampling import fold_seed, sample_rows


def init_state(cfg: CaptionerConfig, slots: int, t_max: int, prefix_len: int,
               policy: Policy = F32, device=DEFAULT_DEVICE) -> dict:
    """Fresh engine state: ``slots`` empty rows, the append position at
    ``prefix_len`` (so the first admission's prefix fits below it)."""
    dev = resolve_device(device)
    shape = (cfg.gpt2.n_layer, t_max, slots, cfg.gpt2.n_embd)

    def vec(value, dtype):
        return torch.full((slots,), value, dtype=dtype, device=dev)

    return {
        "k": torch.zeros(shape, dtype=policy.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=policy.compute_dtype, device=dev),
        "idx": prefix_len,
        "start": vec(prefix_len, torch.int32),
        "prev": vec(0, torch.int32),
        "finished": vec(True, torch.bool),  # empty rows are free
        "gen": vec(0, torch.int32),
        "cap": vec(0, torch.int32),
        "uid": vec(-1, torch.int32),
        # per-row sampling parameters, carried like cap and uid
        "temp": vec(0.0, torch.float32),
        "topp": vec(1.0, torch.float32),
        # the global decode-step counter: monotone across macros and
        # compactions (unlike idx), the key of the sampling noise
        "t": 0,
        "host_reads": 0,  # blocking device-to-host reads made by macro_step
    }


def affinity_block(slots: int) -> int:
    """The batch-block width of the JAX engine's age-affine admission: 256 rows
    where the pool is a multiple of 256 (the JAX service then packs the
    256-row kernel blocks), else 128."""
    return 256 if slots % 256 == 0 else 128


def admission_rows(free: torch.Tensor, admit: int, affinity: bool = False) -> torch.Tensor:
    """The rows the next ``admit`` admissions take: free rows first, lowest
    row first; with ``affinity``, free rows of the block of
    :func:`affinity_block` rows with the most free rows first (the JAX
    engine's ``admit_affinity``).  Only which free rows admit changes, never
    a caption.  free (S,) bool → (admit,) int64 distinct rows."""
    s = free.shape[0]
    blk = affinity_block(s)
    if affinity and s % blk == 0 and s > blk:
        blk_free = free.reshape(s // blk, blk).sum(dim=1)
        block_of = torch.arange(s, device=free.device) // blk
        key = torch.where(free, -blk_free[block_of], s + 1)
    else:
        key = torch.where(free, 0, 1)
    return torch.argsort(key, stable=True)[:admit]


def compaction_shift(idx: int, start: torch.Tensor, finished: torch.Tensor, p_len: int) -> int:
    """How far macro entry shifts the pool's windows down: the smallest live
    row's start, at most ``idx - p_len`` (an all-free pool rebases to
    ``idx == p_len``, where an admission's prefix fits).  The macro's one
    host read."""
    return min(int(torch.where(finished, idx, start).min()), idx - p_len)


@torch.no_grad()
def macro_step(
    packed: dict,
    trainable: dict,
    frozen: dict,
    state: dict,
    emb_q: torch.Tensor,
    cap_q: torch.Tensor,
    uid_q: torch.Tensor,
    n_q: int,
    seed: int | None = None,
    temp_q: torch.Tensor | None = None,
    topp_q: torch.Tensor | None = None,
    *,
    cfg: CaptionerConfig,
    policy: Policy,
    seg: int,
    bursts: int,
    admit: int,
    temperature: float = 0.0,
    top_p: float = 1.0,
    sampled: bool | None = None,
    sample_in_kernel: bool = False,
    admit_affinity: bool = False,
    use_kernels: bool | None = None,
) -> tuple[dict, torch.Tensor]:
    """``bursts · seg`` decode steps with admission every ``seg``-th step.

    ``emb_q`` (Q, E) float32 staged embeddings (the front of the host
    queue), ``cap_q`` / ``uid_q`` (Q,) int32 per-request token caps and
    uids, ``n_q`` the host int count of valid staged entries, all on the
    pool's device.  At each burst's admission point up to ``admit`` staged
    requests (in order) are prefilled into free rows (lowest free row first)
    by :func:`captioner.admit_prefill` — the mapper and the GPT-2 prefill
    with LOCAL positions, the K/V written into ``[idx - P, idx)`` of the
    rows — then the slot bookkeeping.  The prefill
    runs on ``admit`` staged rows at every admission point while ``n_q > 0``
    and its results are masked by the number the device takes, so the host
    never waits.  Rows finish on EOS or at their ``cap`` and are reusable
    from the next admission point.

    Returns ``(state', out)`` with ``out`` int32 (bursts · seg, 4, S), per
    step: ``out[t, 0]`` the tokens (rows free or finished at the step's
    start emit EOS), ``out[t, 1]`` each row's occupant uid or -1 for such
    rows, ``out[t, 2]`` / ``out[t, 3]`` the step's admitted first tokens /
    uids in admission order, -1-padded (all -1 but on a burst's first step).

    Capacity contract (held by the caller): ``t_max >= P + max(cap) +
    bursts · seg``.  Compaction at entry (one host read: the shift) rebases
    ``idx`` to the longest live window.

    Sampled serving: ``sampled=True`` (default: ``temperature != 0``) draws
    every row with its own temperature and top_p (``temp_q`` / ``topp_q``,
    default the scalar ``temperature`` / ``top_p``, carried in the state);
    temperature-0 rows take the argmax.  Noise stream ``seed``, keyed off
    ``state["t"]`` by :func:`ops.sampling.fold_seed`.  ``sample_in_kernel``
    draws decode tokens inside the step (the first token of an admission
    keeps the eager draw).  ``use_kernels`` as in :func:`captioner.generate`.
    """
    if sampled is None:
        sampled = temperature != 0.0
    if sampled and seed is None:
        raise ValueError("sampled macro_step needs a seed")
    gpt = _gpt(trainable, frozen)
    wte, wpe = gpt["wte"], gpt["wpe"]
    eos = cfg.eos_token_id
    k, v = state["k"], state["v"]
    s = k.shape[2]
    if not 1 <= admit <= s:
        raise ValueError(f"admit must be in [1, {s}], got {admit}")
    dev = k.device
    q_cap = emb_q.shape[0]
    cdt = policy.compute_dtype
    use = DS.fused_greedy_enabled(use_kernels, dev)
    p_len = cfg.total_prefix_length
    if temp_q is None:
        temp_q = torch.full((q_cap,), temperature, dtype=torch.float32, device=dev)
    if topp_q is None:
        topp_q = torch.full((q_cap,), top_p, dtype=torch.float32, device=dev)
    step_kw = dict(n_head=cfg.gpt2.n_head, eps=cfg.gpt2.layer_norm_epsilon, use_kernels=use)

    # compaction at macro entry: shift every live window down by the smallest
    # live start
    idx, start, finished = state["idx"], state["start"], state["finished"]
    shift = compaction_shift(idx, start, finished, p_len)
    host_reads = state["host_reads"] + 1
    if shift > 0:
        n = idx - shift
        for cache in (k, v):
            cache[:, :n] = cache[:, shift:idx].clone()
        idx -= shift
        start = start - shift

    prev, gen, cap, uid = state["prev"], state["gen"], state["cap"], state["uid"]
    temp, topp, t = state["temp"], state["topp"], state["t"]
    out = torch.full((bursts * seg, 4, s), -1, dtype=torch.int32, device=dev)
    slots_a = torch.arange(admit, device=dev)
    qhead = torch.zeros((), dtype=torch.int64, device=dev)
    for burst in range(bursts):
        if n_q > 0:
            rows = admission_rows(finished, admit, admit_affinity)
            ntake = torch.clamp(torch.minimum(finished.sum(), n_q - qhead), max=admit)
            valid = slots_a < ntake
            qidx = torch.clamp(qhead + slots_a, max=q_cap - 1)
            logits, k, v = admit_prefill(trainable, frozen, cfg, emb_q[qidx], k, v, idx, rows,
                                         valid, policy=policy, use_kernels=use, packed=packed)
            if sampled:
                noise = torch.Generator(device=dev).manual_seed(fold_seed(seed, 2 * t + 1))
                first = sample_rows(logits, temp_q[qidx], topp_q[qidx], noise)
            else:
                first = torch.argmax(logits, dim=-1).to(torch.int32)
            lo = idx - p_len

            def place(vals, old):
                return old.index_put((rows,), torch.where(valid, vals.to(old.dtype), old[rows]))

            cap_a = cap_q[qidx]
            start = place(torch.full_like(first, lo), start)
            prev = place(first, prev)
            gen = place(torch.ones_like(first), gen)
            cap = place(cap_a, cap)
            uid = place(uid_q[qidx], uid)
            temp = place(temp_q[qidx], temp)
            topp = place(topp_q[qidx], topp)
            finished = place((first == eos) | (cap_a <= 1), finished)
            qhead = qhead + ntake
            out[burst * seg, 2, :admit] = torch.where(valid, first, -1)
            out[burst * seg, 3, :admit] = torch.where(valid, uid_q[qidx], -1)

        for j in range(seg):
            # finished rows hold an empty window at the append position
            start = torch.where(finished, idx, start)
            live = ~finished
            x0 = (wte[prev.long()] + wpe[(idx - start).long()]).to(cdt)
            if not sampled:
                tok = DS.fused_decode_step(packed, x0, k, v, idx, start=start, **step_kw)[0]
            elif sample_in_kernel:
                # dead rows carry temperature 0: the argmax, no candidates to test
                sample = {"temp": torch.where(live, temp, 0.0), "top_p": topp,
                          "seed": fold_seed(seed, 2 * t)}
                tok = DS.fused_decode_step(packed, x0, k, v, idx, start=start, sample=sample,
                                           **step_kw)[0]
            else:
                lg = DS.fused_decode_step(packed, x0, k, v, idx, start=start, emit_logits=True,
                                          **step_kw)[0]
                noise = torch.Generator(device=dev).manual_seed(fold_seed(seed, 2 * t))
                tok = sample_rows(lg, temp, topp, noise)
            tok = torch.where(live, tok, eos).to(torch.int32)
            row = burst * seg + j
            out[row, 0] = tok
            out[row, 1] = torch.where(live, uid, -1)
            t += 1
            gen = gen + live.to(torch.int32)
            finished = finished | (tok == eos) | (gen >= cap)
            prev = tok
            idx += 1

    state = {"k": k, "v": v, "idx": idx, "start": start, "prev": prev, "finished": finished,
             "gen": gen, "cap": cap, "uid": uid, "temp": temp, "topp": topp, "t": t,
             "host_reads": host_reads}
    return state, out


def init_state_dp(cfg: CaptionerConfig, mesh, slots: int, t_max: int, prefix_len: int,
                  policy: Policy = F32) -> dict:
    """This rank's sub-pool of a dp-sharded engine: rank r of ``mesh`` holds
    rows ``[r · slots/dp, (r+1) · slots/dp)`` of the ``slots``-row pool, as
    :func:`init_state` of ``slots // dp`` rows on the mesh's device, with
    its own ``idx`` and ``t`` (each sub-pool compacts and counts on its
    own), as the JAX package's per-pool ``(dp,)`` vectors have."""
    if slots % mesh.dp != 0:
        raise ValueError(f"slots {slots} must divide over dp={mesh.dp}")
    return init_state(cfg, slots // mesh.dp, t_max, prefix_len, policy, mesh.device)


def macro_step_dp(
    mesh,
    packed: dict,
    trainable: dict,
    frozen: dict,
    state: dict,
    emb_q: torch.Tensor,
    cap_q: torch.Tensor,
    uid_q: torch.Tensor,
    n_q,
    seed: int | None = None,
    temp_q: torch.Tensor | None = None,
    topp_q: torch.Tensor | None = None,
    **kw,
) -> tuple[dict, torch.Tensor]:
    """Data-parallel continuous serving: every rank, called with the same
    arguments, runs :func:`macro_step` on its own sub-pool
    (:func:`init_state_dp`) — no collective inside the decode loop.

    The staged block is ``dp`` contiguous per-pool blocks: ``emb_q`` (Q, E),
    ``cap_q`` / ``uid_q`` / ``temp_q`` / ``topp_q`` (Q,) are split on the
    queue axis and rank r admits from block r; ``n_q`` holds one count of
    valid staged entries a pool (host ints).  Sampled noise folds the pool's
    index into ``seed`` (:func:`ops.sampling.fold_seed`, as the JAX engine
    folds ``axis_index("dp")`` into its key).  Returns ``(state', out)``
    with ``out`` (bursts · seg, 4, S) gathered over the pools on the slot
    axis, so the host's harvest is that of one pool of S rows and the uids
    stay global.  ``kw``: :func:`macro_step`'s keywords."""
    from gpt2_image_captioning_tpu_torch.parallel.collectives import all_gather_batch

    dp, r = mesh.dp, mesh.rank
    q_per = emb_q.shape[0] // dp

    def block(x):
        return None if x is None else x[r * q_per:(r + 1) * q_per].to(mesh.device)

    state, out = macro_step(packed, trainable, frozen, state, block(emb_q), block(cap_q),
                            block(uid_q), int(n_q[r]),
                            None if seed is None else fold_seed(seed, r), block(temp_q),
                            block(topp_q), **kw)
    out = all_gather_batch(mesh, out.permute(2, 0, 1).contiguous()).permute(1, 2, 0)
    return state, out.contiguous()
