"""Continuous-batching caption serving — the counterpart of
``gpt2_image_captioning_tpu/serving.py::ContinuousCaptionService``, fed by
image embeddings.

``ContinuousCaptionService`` keeps a fixed pool of ``slots`` decode rows live
across requests: whenever a row's caption finishes (EOS or its length cap)
the next queued request is prefilled into the freed row mid-flight while
every other row keeps decoding.  The loop runs in
:func:`models.continuous.macro_step`: ``bursts`` × (admission from a staged
request block + ``segment`` decode steps) per dispatch, and the host copies
one packed int32 matrix of tokens and uids per macro into pinned memory,
kept one macro behind the dispatch, so the copy and the bookkeeping overlap
the next macro's device time (a CUDA event says when the copy landed).

Greedy serving gives every request the tokens of one-shot greedy
:func:`models.captioner.generate`.  ``temperature`` / ``top_p`` (or
``per_request_sampling``) select sampled serving, each request with its own
values; ``sample_in_kernel`` draws decode tokens inside the step.
``decode_precision="int8"`` decodes from the W8A8 pack of the bf16 weights
(admission's prefill stays bf16), as the JAX service does.

Not ported here, and refused: image intake (``submit_array``,
``submit_bytes``, ``submit_prepped``, ``caption_arrays``) and the HTTP
endpoints need the vision towers (ROADMAP.md, queue 1, item 10); ``mesh``
needs parallelism (item 13).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import continuous as CE

_VISION = ("image intake needs the vision towers, which are not ported yet (ROADMAP.md, "
           "queue 1, item 10: vision); submit image embeddings with submit_embedding")


class ContinuousCaptionService:
    """Rolling-admission ("continuous batching") caption serving of image
    embeddings.

    ``model`` is an :class:`models.captioner.ImageCaptioningModel` with a
    tokenizer; the pool runs on its device.  ``vision_params`` /
    ``vision_cfg`` must be None (image intake is not ported).  ``slots`` decode
    rows, ``segment`` steps between admission points, ``bursts`` admission
    points per macro, up to ``admit`` admissions at each; ``max_length`` is
    the longest caption a request may ask for.  ``pipeline_depth`` macros
    may be in flight.  ``use_kernels`` as in :func:`models.captioner.generate`.
    """

    def __init__(
        self,
        model,
        vision_params=None,
        vision_cfg=None,
        *,
        slots: int = 64,
        segment: int = 4,
        bursts: int = 8,
        admit: int | None = None,
        max_length: int = 50,
        t_max: int | None = None,
        decode_precision: str | None = None,
        temperature: float = 0.0,
        top_p: float = 0.9,
        per_request_sampling: bool = False,
        sample_in_kernel: bool = False,
        seed: int = 0,
        pipeline_depth: int = 1,
        mesh=None,
        admit_affinity: bool = False,
        use_kernels: bool | None = None,
    ):
        if vision_params is not None or vision_cfg is not None:
            raise NotImplementedError(_VISION)
        if mesh is not None:
            raise NotImplementedError(
                "a dp mesh of sub-pools is not ported yet (ROADMAP.md, queue 1, item 13: "
                "parallelism)")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.model = model
        cfg = model.cfg
        self.cfg = cfg
        quant = decode_precision == "int8"
        self._tr, self._fz, self._pol = model.decode_params("bf16" if quant else decode_precision)
        self._packed = C.prepare_decode_weights(self._tr, self._fz, cfg, self._pol, quant=quant)
        self.device = model.device
        self._use_kernels = use_kernels
        self.slots = slots
        self.segment = segment
        self.bursts = bursts
        self.admit = min(admit if admit is not None else 32, slots)
        self.max_length = max_length
        self.admit_affinity = bool(admit_affinity)
        self.temperature, self.top_p = float(temperature), float(top_p)
        # sampled serving draws every row with its own temperature and top_p;
        # temperature-0 rows take the argmax, so greedy and sampled requests
        # mix in one pool
        self.sampled = bool(per_request_sampling) or temperature != 0.0
        self.sample_in_kernel = bool(sample_in_kernel) and self.sampled
        if self.sample_in_kernel and self.top_p < 0.5:
            raise ValueError(f"sample_in_kernel needs top_p >= 0.5, got {self.top_p}")
        self.seed = int(seed)
        self._emb_dim = cfg.mapping.embed_dim
        p = cfg.total_prefix_length
        # capacity: compaction rebases idx to the longest live window
        # (<= P + max_length - 1), then idx grows by bursts * segment
        t_max = max(t_max or 0, p + max_length + bursts * segment)
        self.t_max = -(-t_max // 8) * 8
        # staging block: everything one macro could admit
        self.q_cap = max(slots, min(bursts * self.admit, 4 * slots))
        self.pipeline_depth = pipeline_depth
        self._state = CE.init_state(cfg, slots, self.t_max, p, self._pol, self.device)
        self._queue: list[tuple[int, np.ndarray]] = []
        self._inflight: collections.deque = collections.deque()
        self._host_bufs: list[torch.Tensor] = []  # pinned output buffers, reused
        self._live: set[int] = set()
        self._emitted: dict[int, list[int]] = {}
        self._req_max: dict[int, int] = {}
        self._req_temp: dict[int, float] = {}
        self._req_topp: dict[int, float] = {}
        self._submit_t: dict[int, float] = {}
        self._latencies: list[float] = []
        self._results: dict[int, str] = {}
        self._next_id = 0
        self._stats = {
            "images": 0, "macros": 0, "device_s": 0.0,
            # seconds: staging + dispatch, waiting for the packed output, host bookkeeping
            "dispatch_s": 0.0, "sync_s": 0.0, "host_s": 0.0,
        }
        self._occ_sum, self._occ_n = 0.0, 0

    # -- request intake ------------------------------------------------------
    def submit_embedding(self, emb: np.ndarray, max_length: int | None = None,
                         temperature: float | None = None, top_p: float | None = None) -> int:
        """Queue one image embedding (E,); returns a request id.
        ``max_length`` caps this request's caption below the service's;
        ``temperature`` / ``top_p`` override the service's for this request
        (sampled services only; ``temperature=0`` is greedy)."""
        if max_length is not None and not 1 <= max_length <= self.max_length:
            raise ValueError(f"per-request max_length must be in [1, {self.max_length}]")
        if temperature is not None:
            if not self.sampled and temperature != 0.0:
                raise ValueError(
                    "per-request temperature needs a sampled service — construct with "
                    "temperature>0 or per_request_sampling=True (the greedy service's step "
                    "ends in the argmax kernel and never stores logits)")
            if temperature < 0.0:
                raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p is not None and self.sample_in_kernel and top_p < 0.5:
            raise ValueError(
                f"this service draws tokens in the step (sample_in_kernel=True), which needs "
                f"per-request top_p >= 0.5; got {top_p}")
        emb = np.asarray(emb, np.float32)
        if emb.shape != (self._emb_dim,):
            raise ValueError(f"an embedding must have shape ({self._emb_dim},), got {emb.shape}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, emb))
        if max_length is not None:
            self._req_max[rid] = max_length
        if temperature is not None:
            self._req_temp[rid] = float(temperature)
        if top_p is not None:
            self._req_topp[rid] = float(top_p)
        self._submit_t[rid] = time.perf_counter()
        return rid

    def submit_array(self, *args, **kwargs) -> int:
        raise NotImplementedError(_VISION)

    def submit_bytes(self, *args, **kwargs) -> int:
        raise NotImplementedError(_VISION)

    def submit_prepped(self, *args, **kwargs) -> int:
        raise NotImplementedError(_VISION)

    def caption_arrays(self, *args, **kwargs) -> list[str]:
        raise NotImplementedError(_VISION)

    @property
    def live(self) -> int:
        """Requests admitted to the pool and not yet completed, by the host's
        knowledge (an in-flight macro may have finished some)."""
        return len(self._live)

    @property
    def queued(self) -> int:
        return len(self._queue)

    # -- serving loop --------------------------------------------------------
    def _complete(self, rid: int) -> None:
        toks = self._emitted.pop(rid)
        self._req_max.pop(rid, None)
        self._req_temp.pop(rid, None)
        self._req_topp.pop(rid, None)
        self._live.discard(rid)
        t_sub = self._submit_t.pop(rid, None)
        if t_sub is not None:
            self._latencies.append(time.perf_counter() - t_sub)
        if toks and toks[-1] == self.cfg.eos_token_id:
            toks = toks[:-1]
        self._results[rid] = self.model.tokenizer.batch_decode(
            np.asarray([toks], np.int32) if toks else np.zeros((1, 0), np.int32),
            skip_special_tokens=True,
        )[0]
        self._stats["images"] += 1

    def _dispatch(self) -> None:
        """Stage a request block, run one macro step, and start the copy of
        its packed output to pinned host memory."""
        td = time.perf_counter()
        entries = self._queue[: self.q_cap]
        del self._queue[: len(entries)]
        n = len(entries)
        emb = np.zeros((self.q_cap, self._emb_dim), np.float32)
        ints = np.full((2, self.q_cap), -1, np.int32)  # cap, uid
        floats = np.empty((2, self.q_cap), np.float32)  # temperature, top_p
        ints[0] = self.max_length
        floats[0], floats[1] = self.temperature, self.top_p
        for i, (rid, payload) in enumerate(entries):
            emb[i] = payload
            ints[:, i] = self._req_max.get(rid, self.max_length), rid
            floats[:, i] = self._req_temp.get(rid, self.temperature), self._req_topp.get(
                rid, self.top_p)
        dev = self.device
        ints_d, floats_d = torch.from_numpy(ints).to(dev), torch.from_numpy(floats).to(dev)
        self._state, out = CE.macro_step(
            self._packed, self._tr, self._fz, self._state, torch.from_numpy(emb).to(dev),
            ints_d[0], ints_d[1], n, self.seed if self.sampled else None, floats_d[0],
            floats_d[1],
            cfg=self.cfg, policy=self._pol, seg=self.segment, bursts=self.bursts,
            admit=self.admit, temperature=self.temperature, top_p=self.top_p,
            sampled=self.sampled, sample_in_kernel=self.sample_in_kernel,
            admit_affinity=self.admit_affinity, use_kernels=self._use_kernels,
        )
        event = None
        if out.is_cuda:
            host = (self._host_bufs.pop() if self._host_bufs
                    else torch.empty(out.shape, dtype=out.dtype, pin_memory=True))
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            out = host
        self._inflight.append((out, event, entries))
        self._stats["macros"] += 1
        self._stats["dispatch_s"] += time.perf_counter() - td

    def _harvest(self, inflight) -> None:
        """Apply a dispatched macro's packed output: a request occupies one
        pool row for its whole life, so each row's uid column splits into
        contiguous per-request segments, each handed its tokens in one go.
        A step's admissions land before its decode token; tokens append in
        time order, cut at the request's cap, complete at EOS or the cap."""
        out_t, event, entries = inflight
        ts = time.perf_counter()
        if event is not None:
            event.synchronize()
        out = out_t.numpy().copy()
        if event is not None:
            self._host_bufs.append(out_t)
        th = time.perf_counter()
        self._stats["sync_s"] += th - ts
        eos = self.cfg.eos_token_id
        toks_mat, uid_mat = out[:, 0], out[:, 1]  # (T, S)
        adm_first, adm_uid = out[:, 2], out[:, 3]
        # occupancy: the share of (step, row) cells live this macro
        self._occ_sum += float((uid_mat >= 0).mean())
        self._occ_n += 1
        for t_i, a_i in zip(*np.nonzero(adm_uid >= 0)):  # in time order
            u = int(adm_uid[t_i, a_i])
            first = int(adm_first[t_i, a_i])
            self._emitted[u] = [first]
            self._live.add(u)
            if first == eos or self._req_max.get(u, self.max_length) <= 1:
                self._complete(u)
        for r in np.nonzero((uid_mat >= 0).any(axis=0))[0]:
            col = uid_mat[:, r]
            valid = col >= 0
            us = col[valid]
            change = np.nonzero(np.diff(us) != 0)[0]
            starts = np.concatenate(([0], change + 1))
            ends = np.concatenate((change + 1, [us.size]))
            toks_col = toks_mat[:, r][valid]
            for s0, s1 in zip(starts, ends):
                u = int(us[s0])
                if u not in self._live:
                    continue
                stream = self._emitted[u]
                cap = self._req_max.get(u, self.max_length)
                room = cap - len(stream)
                if room <= 0:
                    self._complete(u)
                    continue
                take = toks_col[s0:s1][:room]
                ep = np.nonzero(take == eos)[0]
                if ep.size:
                    take = take[: ep[0] + 1]
                stream.extend(take.tolist())
                if len(stream) >= cap or (take.size and take[-1] == eos):
                    self._complete(u)
        # the entries the macro did not reach go back to the queue front, in order
        consumed = int((adm_uid >= 0).sum())
        self._queue[:0] = entries[consumed:]
        self._stats["host_s"] += time.perf_counter() - th

    def step(self) -> dict[int, str]:
        """Dispatch the next macro if there is visible work, then harvest down
        to ``pipeline_depth - 1`` older in-flight macros, whose copies and
        bookkeeping overlap the newest macro's device time.  With nothing
        visible (queue and live empty) but macros in flight, every in-flight
        output is harvested instead.  Returns the requests completed during
        this call ({id: caption}); they stay until :meth:`pop_result`."""
        t0 = time.perf_counter()
        before = set(self._results)
        dispatched = False
        if self._queue or self._live:
            self._dispatch()
            dispatched = True
        keep = self.pipeline_depth if dispatched else 0
        while len(self._inflight) > keep:
            self._harvest(self._inflight.popleft())
        self._stats["device_s"] += time.perf_counter() - t0
        return {r: c for r, c in self._results.items() if r not in before}

    def drain(self) -> dict[int, str]:
        """Run until the queue, every in-flight macro and every live request
        are exhausted."""
        per_req = -(-self.max_length // (self.segment * self.bursts)) + 2
        pending = self.queued + self.live + len(self._inflight)
        limit = 8 + self.pipeline_depth + (pending + 1) * per_req
        guard = 0
        while (self._queue or self._live or self._inflight) and guard < limit:
            guard += 1
            self.step()
        if self._queue or self._live or self._inflight:
            raise RuntimeError("continuous serving loop failed to drain")
        return dict(self._results)

    def pop_result(self, rid: int) -> str:
        return self._results.pop(rid)

    def recommended_inflight(self, expected_len: int | None = None) -> int:
        """The least in-system population (queued + live) that keeps the pool
        full in steady state, slots · (1 + 2 · bursts · segment /
        expected_len): admission draws only from what was staged at dispatch
        and the host learns of completions one macro late.  ``expected_len``
        defaults to half the service's cap."""
        el = max(1, expected_len or max(1, self.max_length // 2))
        steps = self.bursts * self.segment
        return int(self.slots * (1 + 2 * steps / el) + 0.5)

    @property
    def stats(self) -> dict:
        """images, macros, img_per_s, occupancy (the mean share of live (step,
        row) cells), latency_p50_s / latency_p95_s (submit to completion on
        the host clock), the dispatch / sync / host seconds, and host_reads
        (blocking device reads inside the macros: one compaction shift each)."""
        s = dict(self._stats, host_reads=self._state["host_reads"])
        if s["device_s"] > 0:
            s["img_per_s"] = s["images"] / s["device_s"]
        if self._occ_n:
            s["occupancy"] = self._occ_sum / self._occ_n
        if self._latencies:
            lat = np.sort(self._latencies)
            s["latency_p50_s"] = float(lat[len(lat) // 2])
            s["latency_p95_s"] = float(lat[int(len(lat) * 0.95)])
        return s
