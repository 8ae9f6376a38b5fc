"""Image → caption serving — the counterpart of
``gpt2_image_captioning_tpu/serving.py``: ``CaptionService`` (fixed
batches) and ``ContinuousCaptionService`` (rolling admission), fed by images
or by image embeddings.

The vision frontend (:func:`_make_frontend`) takes host-preprocessed uint8
(B, S, S, 3) pixels to L2-normalised embeddings on the model's device: the
named towers (``encoder="clip"``, ``"vit"``, ``"dino"``) through their uint8
entry points, whose patch embedding is the patch-embed kernel on the card;
a custom ``encode_fn`` after :func:`embeddings.preprocess.normalize_on_device`.
The host's geometry (decode, resize, crop) uses PIL, imported only where a
file or an array of another size is taken in.

``CaptionService`` encodes and decodes fixed device batches of
``batch_size`` images (the last one padded by repeating its last image), with
the model façade's packs cached across requests; sampled decoding draws from
a fresh ``torch.Generator`` per device batch, seeded from the service's
seed and a counter (the JAX service folds its key the same way).

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

:func:`serve_http` (coalesced fixed batches) and :func:`serve_http_continuous`
(rolling admission) put a stdlib HTTP endpoint in front of either service:
``POST /caption`` with an encoded image, ``GET /healthz``.  Handler threads
read and decode the bodies; one thread (the dispatcher, or the pump) makes
every call into the service, on its own CUDA stream context — the default
stream of the service's device — so the kernels' launches keep stream order
(the sampler's counters rely on it: one zeroed buffer a device).  While a
server runs, nothing else may call its service.

Both services take a ``mesh`` (:mod:`core.mesh`), every rank called with
the same requests and returning every caption.  ``CaptionService`` encodes
each dp index's shard of a device batch (the vision tower is replicated
within a tp group), gathers the embeddings over dp and decodes through
``generate``'s mesh path: dp rows, and at ``tp`` > 1 the tensor-parallel
decode on the rank's slices (the JAX ``serving.py:124-135``).
``ContinuousCaptionService`` splits its pool into ``dp`` sub-pools of
``slots // dp`` rows, one a rank (:func:`models.continuous.macro_step_dp`),
and routes the queue's entries round-robin over them; its meshes must be
dp-only, as the JAX service's (``serving.py:359-360``).

The HTTP endpoints take a service of several ranks, each rank calling them
with its own service over the mesh (the same script under ``torchrun``).
The main rank (``mesh.is_main``) listens and answers; before each call into
its service it broadcasts the call's inputs over the mesh's group — a
coalesced batch's pixels, or a pump turn's accepted requests and whether it
steps — and every other rank gets a :class:`_Follower`, whose
``serve_forever()`` makes the same calls in the same order, so the
service's collectives meet.  A request the main rank's service refuses is
never broadcast.  The main rank's ``shutdown()`` broadcasts stop, which
ends the followers' ``serve_forever()``; while idle it broadcasts a beat
every ``_IDLE_BEAT_S`` seconds, so no follower's wait outlives the process
group's timeout.  A broadcast that fails (a follower died, or the group
timed out) answers 500 to every request waiting or queued and to every
later one, and stops the server.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import logging
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.mesh import shard_bounds, tp_active
from gpt2_image_captioning_tpu_torch.core.precision import BF16
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import (
    SPECS, normalize_on_device, resize_and_crop,
)
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import continuous as CE
from gpt2_image_captioning_tpu_torch.ops.sampling import fold_seed
from gpt2_image_captioning_tpu_torch.parallel.collectives import all_gather_batch


def _make_frontend(vision_cfg, encoder: str, encode_fn, spec, policy,
                   use_kernels: bool | None = None):
    """The vision frontend shared by both services → ``(spec, encode)``:
    ``encode(vision_params, batch_u8)`` takes a uint8 (B, S, S, 3) tensor on
    the device to (B, E) L2-normalised embeddings.  Named encoders run their
    uint8 entry point (``encode_image_u8``: the patch-embed kernel, then the
    tower); a custom ``encode_fn(params, cfg, pixels, policy=, normalize=)``
    gets :func:`normalize_on_device`'s pixels and needs ``spec`` when
    ``encoder`` names no tower.  A named spec's resize is scaled when the
    tower's ``image_size`` differs from the 224-pixel production towers."""
    if spec is None:
        if encoder not in SPECS:
            raise ValueError(f"unknown encoder {encoder!r}; pass spec= with a custom encode_fn")
        spec = SPECS[encoder]
    size = getattr(vision_cfg, "image_size", None)
    base = spec.crop or spec.resize
    if size and size != base:
        spec = dataclasses.replace(spec, resize=max(1, round(spec.resize * size / base)),
                                   crop=size if spec.crop else None)
    final = spec
    if encode_fn is not None:
        def encode(vparams, batch_u8):
            px = normalize_on_device(batch_u8, final)
            return encode_fn(vparams, vision_cfg, px, policy=policy, normalize=True)
        return spec, encode
    if encoder == "clip":
        from gpt2_image_captioning_tpu_torch.models.clip import encode_image_u8
    elif encoder == "vit":
        from gpt2_image_captioning_tpu_torch.models.vit import encode_image_u8
    elif encoder == "dino":
        from gpt2_image_captioning_tpu_torch.models.dino import encode_image_u8
    else:
        raise ValueError(f"unknown encoder {encoder!r}")

    def encode(vparams, batch_u8):
        return encode_image_u8(vparams, vision_cfg, batch_u8, final, policy=policy,
                               normalize=True, use_kernels=use_kernels)

    return spec, encode


def _decode_rgb(blob: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"), np.uint8)


class CaptionService:
    """images → captions in fixed device batches.

    ``model``: an :class:`models.captioner.ImageCaptioningModel` with a
    tokenizer, on the device the service runs on; ``vision_params`` /
    ``vision_cfg``: a tower's tree (on the same device) and config,
    ``encoder`` naming it, or ``encode_fn`` (and ``spec``) for another one.
    ``policy`` is the vision tower's (bf16 by default, as in the JAX
    package); ``decode_precision`` the decoder's (the façade's option).
    ``temperature=0`` decodes greedily; otherwise top-p sampling at
    ``top_p``, each device batch drawing from a fresh generator seeded by
    :func:`ops.sampling.fold_seed` of ``seed`` and the batch's counter.
    ``use_kernels`` as in :func:`models.captioner.generate`.  ``mesh``: a
    mesh on whose device the model lives; ``batch_size`` must divide over
    its ``dp`` ranks (module docstring).
    """

    def __init__(self, model, vision_params, vision_cfg, *, encoder: str = "clip",
                 encode_fn=None, batch_size: int = 64, max_length: int = 50,
                 temperature: float = 0.0, top_p: float = 0.9,
                 decode_precision: str | None = None, policy=None, spec=None, seed: int = 0,
                 mesh=None, use_kernels: bool | None = None):
        tp_active(mesh)  # a tp axis must come with its group
        if mesh is not None and batch_size % mesh.dp != 0:
            raise ValueError(f"batch_size {batch_size} must divide over dp={mesh.dp}")
        self._mesh = mesh
        self.model = model
        self.spec, self._encode = _make_frontend(vision_cfg, encoder, encode_fn, spec,
                                                 policy or BF16, use_kernels)
        self._vparams = vision_params
        self.batch_size = batch_size
        self.max_length = max_length
        self.temperature = temperature
        self.top_p = top_p
        self.decode_precision = decode_precision
        self.seed = int(seed)
        self._use_kernels = use_kernels
        self._draws = 0
        self._stats = {"images": 0, "requests": 0, "device_s": 0.0}

    def _next_generator(self) -> torch.Generator:
        """A fresh generator per device batch (greedy decoding ignores it)."""
        self._draws += 1
        return torch.Generator(device=self.model.device).manual_seed(
            fold_seed(self.seed, self._draws) & 0x7FFFFFFFFFFFFFFF)

    def _caption_batch(self, batch_u8: np.ndarray) -> list[str]:
        """Captions of one device batch; under a mesh each dp index encodes
        its contiguous shard and the embeddings are gathered over dp."""
        mesh = self._mesh
        if mesh is not None:
            lo, hi = shard_bounds(mesh, len(batch_u8))
            batch_u8 = batch_u8[lo:hi]
        u8 = torch.from_numpy(np.ascontiguousarray(batch_u8, np.uint8)).to(self.model.device)
        with torch.no_grad():
            emb = self._encode(self._vparams, u8)
        if mesh is not None:
            emb = all_gather_batch(mesh, emb)
        return self.model.generate_captions(
            emb, max_length=self.max_length, temperature=self.temperature, top_p=self.top_p,
            generator=self._next_generator(), decode_precision=self.decode_precision,
            use_kernels=self._use_kernels, mesh=mesh)

    def _to_square_u8(self, rgb: np.ndarray) -> np.ndarray:
        return resize_and_crop(np.asarray(rgb, np.uint8), self.spec)

    def caption_arrays(self, images: Sequence[np.ndarray]) -> list[str]:
        """uint8 RGB arrays of any size → captions, in order."""
        if len(images) == 0:
            return []
        return self.caption_prepped(np.stack([self._to_square_u8(im) for im in images]))

    def caption_prepped(self, prepped: np.ndarray) -> list[str]:
        """An already resized and cropped uint8 batch (N, S, S, 3) → captions;
        the last device batch is padded by repeating its last image."""
        n = len(prepped)
        if n == 0:
            return []
        captions: list[str] = []
        t0 = time.perf_counter()
        for start in range(0, n, self.batch_size):
            chunk = prepped[start : start + self.batch_size]
            k = len(chunk)
            if k < self.batch_size:  # pad to the fixed serving shape
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.batch_size - k, axis=0)])
            captions.extend(self._caption_batch(chunk)[:k])
        self._stats["images"] += n
        self._stats["requests"] += 1
        self._stats["device_s"] += time.perf_counter() - t0
        return captions

    def caption_bytes(self, blobs: Sequence[bytes]) -> list[str]:
        """Encoded image bytes (JPEG, PNG, ...) → captions."""
        return self.caption_arrays([_decode_rgb(b) for b in blobs])

    def caption_paths(self, paths: Sequence[str]) -> list[str]:
        from PIL import Image

        return self.caption_arrays(
            [np.asarray(Image.open(p).convert("RGB"), np.uint8) for p in paths])

    def caption_dir(self, image_dir: str, num_workers: int = 4) -> dict[str, str]:
        """Caption every image of a directory → {filename: caption}, through
        the prefetching batch loader (the C++ pipeline when built, PIL threads
        otherwise), so the host's decode of batch i + 1 overlaps batch i."""
        from gpt2_image_captioning_tpu_torch.embeddings.extract import _make_loader

        loader = _make_loader(image_dir, self.spec, self.batch_size, num_workers)
        out: dict[str, str] = {}
        t0 = time.perf_counter()
        for names, batch_u8, _valid in loader:
            out.update(zip(names, self._caption_batch(batch_u8)))
        self._stats["images"] += len(out)
        self._stats["requests"] += 1
        self._stats["device_s"] += time.perf_counter() - t0
        return out

    @property
    def stats(self) -> dict:
        s = dict(self._stats)
        if s["device_s"] > 0:
            s["img_per_s"] = s["images"] / s["device_s"]
        return s


class ContinuousCaptionService:
    """Rolling-admission ("continuous batching") caption serving of images
    and image embeddings.

    ``model`` is an :class:`models.captioner.ImageCaptioningModel` with a
    tokenizer; the pool runs on its device.  ``vision_params`` /
    ``vision_cfg`` (with ``encoder``, or ``encode_fn`` and ``spec``) are the
    vision tower of image submissions, as in :class:`CaptionService`; the
    tower runs at the decoder's policy, and each macro's staged images are
    encoded once, together, before it.  Without them only
    :meth:`submit_embedding` takes requests.  ``slots`` decode
    rows, ``segment`` steps between admission points, ``bursts`` admission
    points per macro, up to ``admit`` admissions at each; ``max_length`` is
    the longest caption a request may ask for.  ``pipeline_depth`` macros
    may be in flight.  ``use_kernels`` as in :func:`models.captioner.generate`.

    ``mesh``: a dp mesh on whose device the model lives; ``slots`` must
    divide over its ``dp`` ranks, each of which serves a sub-pool of ``slots
    // dp`` rows and admits up to ``admit`` (at most ``slots // dp``) at each
    admission point.  The staging block is ``dp`` per-pool blocks of
    ``q_cap // dp`` rows; entry i of the queue lands in row ``(i % dp) ·
    q_per + i // dp``, so the queue spreads round-robin over the pools.
    Each rank encodes the staged images of its own block.
    """

    def __init__(
        self,
        model,
        vision_params=None,
        vision_cfg=None,
        *,
        encoder: str = "clip",
        encode_fn=None,
        spec=None,
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
        if mesh is not None and mesh.tp != 1:
            raise ValueError("ContinuousCaptionService meshes must be dp-only")
        self._mesh = mesh
        self._dp = 1 if mesh is None else mesh.dp
        if slots % self._dp != 0:
            raise ValueError(f"slots {slots} must divide over dp={self._dp}")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.model = model
        cfg = model.cfg
        self.cfg = cfg
        quant = decode_precision == "int8"
        self._tr, self._fz, self._pol = model.decode_params("bf16" if quant else decode_precision)
        self._packed = C.prepare_decode_weights(self._tr, self._fz, cfg, self._pol, quant=quant)
        self.spec, self._encode = _make_frontend(vision_cfg, encoder, encode_fn, spec, self._pol,
                                                 use_kernels)
        self._vparams = vision_params
        self.device = model.device
        self._use_kernels = use_kernels
        self.slots = slots
        self.segment = segment
        self.bursts = bursts
        sp = slots // self._dp  # rows of one sub-pool
        self.admit = min(admit if admit is not None else 32, sp)
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
        # staging block: everything one macro could admit, a block a sub-pool
        self._q_per = max(sp, min(bursts * self.admit, 4 * sp))
        self.q_cap = self._dp * self._q_per
        self.pipeline_depth = pipeline_depth
        if self._dp == 1:
            self._state = CE.init_state(cfg, slots, self.t_max, p, self._pol, self.device)
        else:
            self._state = CE.init_state_dp(cfg, mesh, slots, self.t_max, p, self._pol)
        # (request id, payload, is_embedding): an embedding (numpy, or a device
        # row once encoded) or a prepped uint8 image
        self._queue: list[tuple[int, object, bool]] = []
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
        """Queue one image embedding (E,), skipping the vision tower; returns a
        request id.  ``max_length`` caps this request's caption below the
        service's; ``temperature`` / ``top_p`` override the service's for this
        request (sampled services only; ``temperature=0`` is greedy)."""
        emb = np.asarray(emb, np.float32)
        if emb.shape != (self._emb_dim,):
            raise ValueError(f"an embedding must have shape ({self._emb_dim},), got {emb.shape}")
        return self._enqueue(emb, True, max_length, temperature, top_p)

    def submit_array(self, rgb: np.ndarray, max_length: int | None = None,
                     temperature: float | None = None, top_p: float | None = None) -> int:
        """Queue one uint8 RGB image of any size (resized and cropped on the
        host by the tower's spec); the rest as :meth:`submit_embedding`."""
        return self.submit_prepped(resize_and_crop(np.asarray(rgb, np.uint8), self.spec),
                                   max_length, temperature, top_p)

    def submit_bytes(self, blob: bytes, max_length: int | None = None,
                     temperature: float | None = None, top_p: float | None = None) -> int:
        """Queue one encoded image (JPEG, PNG, ...)."""
        return self.submit_array(_decode_rgb(blob), max_length, temperature, top_p)

    def submit_prepped(self, arr: np.ndarray, max_length: int | None = None,
                       temperature: float | None = None, top_p: float | None = None) -> int:
        """Queue one uint8 image already resized and cropped to the spec's
        (S, S, 3)."""
        if self._vparams is None:
            raise ValueError("this service has no vision tower: pass vision_params and "
                             "vision_cfg, or submit embeddings")
        a = np.asarray(arr, np.uint8)
        side = self.spec.size
        if a.shape != (side, side, 3):
            raise ValueError(f"a prepped image must be {(side, side, 3)}, got {a.shape}")
        return self._enqueue(a, False, max_length, temperature, top_p)

    def caption_arrays(self, images: Sequence[np.ndarray]) -> list[str]:
        """Submit every image and drain; the captions in input order."""
        ids = [self.submit_array(im) for im in images]
        self.drain()
        return [self._results.pop(i) for i in ids]

    def _enqueue(self, payload, is_emb: bool, max_length: int | None,
                 temperature: float | None, top_p: float | None) -> int:
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
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, payload, is_emb))
        if max_length is not None:
            self._req_max[rid] = max_length
        if temperature is not None:
            self._req_temp[rid] = float(temperature)
        if top_p is not None:
            self._req_topp[rid] = float(top_p)
        self._submit_t[rid] = time.perf_counter()
        return rid

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
        its packed output to pinned host memory.  Under a dp mesh entry i
        goes to sub-pool ``i % dp`` (staging row ``(i % dp) · q_per + i //
        dp``), and this rank encodes the images of its own pool's block."""
        td = time.perf_counter()
        dp, q_per = self._dp, self._q_per
        mine = 0 if self._mesh is None else self._mesh.rank
        entries = self._queue[: self.q_cap]
        del self._queue[: len(entries)]
        pos = [(i % dp) * q_per + i // dp for i in range(len(entries))]
        emb = np.zeros((self.q_cap, self._emb_dim), np.float32)
        ints = np.full((2, self.q_cap), -1, np.int32)  # cap, uid
        floats = np.empty((2, self.q_cap), np.float32)  # temperature, top_p
        ints[0] = self.max_length
        floats[0], floats[1] = self.temperature, self.top_p
        images, encoded = [], []
        for i, (rid, payload, is_emb) in enumerate(entries):
            ints[:, pos[i]] = self._req_max.get(rid, self.max_length), rid
            floats[:, pos[i]] = self._req_temp.get(rid, self.temperature), self._req_topp.get(
                rid, self.top_p)
            if i % dp != mine:  # another rank's sub-pool embeds this entry
                continue
            if not is_emb:
                images.append(i)
            elif isinstance(payload, torch.Tensor):  # an image encoded by an earlier macro
                encoded.append(i)
            else:
                emb[pos[i]] = payload
        dev = self.device
        emb_d = torch.from_numpy(emb).to(dev)
        if encoded:
            emb_d[[pos[i] for i in encoded]] = torch.stack([entries[i][1] for i in encoded])
        if images:
            u8 = torch.from_numpy(np.stack([entries[i][1] for i in images])).to(dev)
            with torch.no_grad():
                enc = self._encode(self._vparams, u8).float()
            emb_d[[pos[i] for i in images]] = enc
            # entries the macro does not reach go back to the queue as
            # embeddings, so each image is encoded once
            for j, i in enumerate(images):
                entries[i] = (entries[i][0], enc[j], True)
        ints_d, floats_d = torch.from_numpy(ints).to(dev), torch.from_numpy(floats).to(dev)
        kw = dict(cfg=self.cfg, policy=self._pol, seg=self.segment, bursts=self.bursts,
                  admit=self.admit, temperature=self.temperature, top_p=self.top_p,
                  sampled=self.sampled, sample_in_kernel=self.sample_in_kernel,
                  admit_affinity=self.admit_affinity, use_kernels=self._use_kernels)
        seed = self.seed if self.sampled else None
        if dp == 1:
            self._state, out = CE.macro_step(
                self._packed, self._tr, self._fz, self._state, emb_d, ints_d[0], ints_d[1],
                len(entries), seed, floats_d[0], floats_d[1], **kw)
        else:
            n_q = [len(range(s, len(entries), dp)) for s in range(dp)]
            self._state, out = CE.macro_step_dp(
                self._mesh, self._packed, self._tr, self._fz, self._state, emb_d, ints_d[0],
                ints_d[1], n_q, seed, floats_d[0], floats_d[1], **kw)
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
        # the entries the macro did not reach go back to the queue front, in
        # submission order: sub-pool s admits its staged entries (s, s + dp,
        # ...) in order, as many as its column block shows admissions
        dp, sp = self._dp, self.slots // self._dp
        left = []
        for s in range(dp):
            consumed = int((adm_uid[:, s * sp:(s + 1) * sp] >= 0).sum())
            left += list(range(s, len(entries), dp))[consumed:]
        self._queue[:0] = [entries[i] for i in sorted(left)]
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


# ---------------------------------------------------------------------------
# HTTP endpoints
# ---------------------------------------------------------------------------

_log = logging.getLogger(__name__)


class _Pending:
    """One in-flight /caption request: decoded pixels in, caption/error out."""

    __slots__ = ("array", "event", "caption", "error", "max_length", "temperature", "top_p")

    def __init__(self, array: np.ndarray, max_length: int | None = None,
                 temperature: float | None = None, top_p: float | None = None):
        self.array = array
        self.event = threading.Event()
        self.caption: str | None = None
        self.error: str | None = None
        self.max_length = max_length
        self.temperature = temperature
        self.top_p = top_p


_IDLE_BEAT_S = 60.0  # an idle main rank's beat to its followers (module docstring)


class _Relay:
    """The main rank's service calls, broadcast from it over the mesh's
    group (every rank: the dp ranks and, at tp, the slices): a header of two
    int64 (a count, or -1 for stop; a flag), then arrays whose shapes the
    header and the service fix.  Under gloo the tensors go through the
    host, under nccl through the rank's card."""

    def __init__(self, mesh):
        self.group = mesh.group
        self.is_main = mesh.is_main
        self.device = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
        self.lost: str | None = None  # the error once a broadcast has failed

    def send(self, n: int, flag: int = 0, *arrays: np.ndarray) -> None:
        self.header(n, flag)
        for a in arrays:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(a)).to(self.device), src=0,
                           group=self.group)

    def header(self, n: int = 0, flag: int = 0) -> tuple[int, int]:
        """The main rank's (n, flag), which the other ranks' arguments do
        not change."""
        h = torch.tensor([n, flag], dtype=torch.int64, device=self.device)
        dist.broadcast(h, src=0, group=self.group)
        return int(h[0]), int(h[1])

    def array(self, shape, dtype) -> np.ndarray:
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        dist.broadcast(buf, src=0, group=self.group)
        return buf.cpu().numpy()


def _relay(service) -> _Relay | None:
    """The relay of a service whose mesh has several ranks, else None."""
    mesh = service._mesh
    return _Relay(mesh) if mesh is not None and mesh.world_size > 1 else None


def _relayed(relay: _Relay | None, server, waiting, queued: queue.Queue, *args) -> bool:
    """``relay.send(*args)``; True without a relay.  A failed broadcast (a
    follower died, or the group timed out) leaves the ranks unable to meet
    again: every request in ``waiting`` and in ``queued`` gets 500 with the
    error, later requests get it at once (:func:`_fail_if_lost`), ``server``
    (None: none) stops listening, and False tells the service thread to
    return."""
    if relay is None:
        return True
    try:
        relay.send(*args)
        return True
    except Exception as e:
        _log.exception("broadcast to the follower ranks failed")
        relay.lost = f"the service's other ranks are lost: {e}"
        failed = list(waiting)
        while True:
            try:
                failed.append(queued.get_nowait())
            except queue.Empty:
                break
        for p in failed:
            if isinstance(p, _Pending):
                p.error = relay.lost
                p.event.set()
        if server is not None:
            threading.Thread(target=server.shutdown, daemon=True).start()
        return False


def _fail_if_lost(relay: _Relay | None, p: _Pending) -> None:
    """Answer ``p``, just queued, with the relay's error if a broadcast has
    failed: one queued before the failure was drained by :func:`_relayed`,
    one queued after it is caught here."""
    if relay is not None and relay.lost is not None:
        p.error = relay.lost
        p.event.set()


def _on_device(device: torch.device, body):
    """``body`` wrapped to run with grad mode off on ``device``'s default
    stream: grad mode, the current device and the current stream are a
    thread's own, so none is taken from the thread that built the server."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def run():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            body()

    return run


def _service_thread(device: torch.device, body, name: str):
    """A daemon thread that runs ``body`` as :func:`_on_device` wraps it."""
    return threading.Thread(target=_on_device(device, body), daemon=True, name=name)


class _Follower:
    """What an HTTP endpoint gives a rank other than the main one:
    ``serve_forever()`` replays the main rank's service calls on this
    rank's service until the main rank shuts down; ``shutdown()`` and
    ``server_close()`` do nothing."""

    def __init__(self, device: torch.device, replay):
        self._run = _on_device(device, replay)

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._run()

    def shutdown(self) -> None:
        pass

    def server_close(self) -> None:
        pass


def _decode_body(handler, max_body_bytes: int, prep) -> np.ndarray | None:
    """Read a POST body and turn it into a prepped uint8 image with ``prep``;
    on a bad request send its error (411, 413 before any read, 400) and
    return None."""
    try:
        length = int(handler.headers.get("Content-Length", 0))
    except (TypeError, ValueError):
        handler._json(411, {"error": "missing or malformed Content-Length"})
        return None
    if not 0 <= length <= max_body_bytes:
        # a negative length would make rfile.read(-1) buffer the stream to EOF
        handler._json(413, {"error": f"body exceeds {max_body_bytes} byte limit"})
        return None
    blob = handler.rfile.read(length)
    from PIL import UnidentifiedImageError

    try:
        # decode and geometry on the handler's thread: host work runs in
        # parallel across clients; the device calls are the service thread's
        return prep(_decode_rgb(blob))
    except (UnidentifiedImageError, OSError, ValueError) as e:
        handler._json(400, {"error": f"not a decodable image: {e}"})
        return None


def _http_server(host: str, port: int, service, do_post, stop_thread):
    """A ``ThreadingHTTPServer`` with the two services' common routes:
    ``GET /healthz`` → ``{"ok": true, ...stats}``, ``POST`` → ``do_post``;
    ``shutdown()`` also stops the service thread (``stop_thread()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        # the listen backlog: socketserver's 5 drops the connections of a
        # burst of clients beyond it, which retry a second later and miss
        # the coalescing window
        request_queue_size = 1024

        def shutdown(self):
            stop_thread()
            super().shutdown()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._json(200, {"ok": True, **service.stats})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            do_post(self)

        def log_message(self, *a):  # quiet
            pass

    return Server((host, port), Handler)


def _answer(handler, p: _Pending, timeout_s: float, timeout_msg: str) -> None:
    if not p.event.wait(timeout=timeout_s):
        handler._json(504, {"error": timeout_msg})
    elif p.error is not None:
        handler._json(500, {"error": p.error})
    else:
        handler._json(200, {"caption": p.caption})


def serve_http(service: CaptionService, host: str = "127.0.0.1", port: int = 5152, *,
               window_ms: float = 5.0, max_body_bytes: int = 32 << 20,
               request_timeout_s: float = 300.0):
    """HTTP endpoint with request coalescing around a :class:`CaptionService`.

    - ``POST /caption`` with an encoded image body → ``{"caption": str}``
    - ``GET /healthz`` → ``{"ok": true, ...stats}``

    Each POST is handled on its own thread (body read, decode, resize and
    crop); one dispatcher thread gathers the prepped images for up to
    ``window_ms`` or until ``service.batch_size`` wait, makes one
    ``caption_prepped`` call, and fans the captions back out.  A service
    failure answers 500 to every waiter of its batch; a request unanswered
    after ``request_timeout_s`` gets 504; a body larger than
    ``max_body_bytes`` gets 413 before any of it is read.

    Returns the ``ThreadingHTTPServer`` (call ``serve_forever()`` from a
    thread); its ``shutdown()`` also stops and joins the dispatcher
    (``server.dispatcher_thread``).  Over a service of several ranks the
    main rank gets the server and broadcasts each batch's pixels before its
    ``caption_prepped`` call; the other ranks get a :class:`_Follower`
    (module docstring).
    """
    relay = _relay(service)
    if relay is not None and not relay.is_main:
        side = service.spec.size

        def replay():
            while (n := relay.header()[0]) >= 0:
                if n == 0:  # the main rank's idle beat
                    continue
                pixels = relay.array((n, side, side, 3), torch.uint8)
                try:
                    service.caption_prepped(pixels)
                except Exception:  # the main rank answers its clients for it
                    _log.exception("caption batch of %d failed", n)

        return _Follower(service.model.device, replay)
    pending: queue.Queue = queue.Queue()
    stop = object()  # sentinel

    def dispatcher():
        while True:
            try:
                item = pending.get(timeout=_IDLE_BEAT_S if relay else None)
            except queue.Empty:
                if not _relayed(relay, server, [], pending, 0):
                    return
                continue
            if item is stop:
                _relayed(relay, None, [], pending, -1)
                return
            batch = [item]
            deadline = time.monotonic() + window_ms / 1000.0
            while len(batch) < service.batch_size:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    nxt = pending.get(timeout=remain)
                except queue.Empty:
                    break
                if nxt is stop:
                    pending.put(stop)  # for the outer loop, after this batch
                    break
                batch.append(nxt)
            pixels = np.stack([p.array for p in batch])
            if not _relayed(relay, server, batch, pending, len(batch), 0, pixels):
                return
            try:
                captions = service.caption_prepped(pixels)
                for p, cap in zip(batch, captions):
                    p.caption = cap
            except Exception as e:  # a device failure is the server's, not the client's
                _log.exception("caption batch of %d failed", len(batch))
                for p in batch:
                    p.error = str(e)
            for p in batch:
                p.event.set()

    def do_post(handler):
        if handler.path != "/caption":
            handler._json(404, {"error": "not found"})
            return
        arr = _decode_body(handler, max_body_bytes, service._to_square_u8)
        if arr is None:
            return
        p = _Pending(arr)
        pending.put(p)
        _fail_if_lost(relay, p)
        _answer(handler, p, request_timeout_s, "caption batch timed out")

    thread = _service_thread(service.model.device, dispatcher, "caption-dispatcher")

    def stop_thread():
        pending.put(stop)
        thread.join(timeout=request_timeout_s)

    server = _http_server(host, port, service, do_post, stop_thread)
    thread.start()
    server.dispatcher_thread = thread
    return server


def serve_http_continuous(service: ContinuousCaptionService, host: str = "127.0.0.1",
                          port: int = 5152, *, max_body_bytes: int = 32 << 20,
                          request_timeout_s: float = 300.0):
    """HTTP endpoint over a :class:`ContinuousCaptionService`.

    - ``POST /caption[?max_length=N&temperature=T&top_p=P]`` with an encoded
      image body → ``{"caption": str}`` (400 on a value the service refuses)
    - ``GET /healthz`` → ``{"ok": true, ...stats}``

    Each request is admitted into a freed decode row mid-flight and
    completes at its own length.  Handler threads read, decode, resize and
    crop; one pump thread owns every ``service`` call: it submits the queued
    images, turns the serving loop (:meth:`ContinuousCaptionService.step`:
    dispatch the next macro, harvest the one before, whose pinned copy a CUDA
    event says has landed) and fans completions out.  With nothing to serve
    it blocks on the intake queue.  A device failure answers 500 to every
    waiter; requests still waiting at ``shutdown()`` get 500 "server shut
    down".

    Returns the ``ThreadingHTTPServer`` (run ``serve_forever()`` from a
    thread); its ``shutdown()`` also stops and joins the pump
    (``server.pump_thread``).  Over a service of several ranks the main
    rank gets the server: each turn its pump submits the new requests, then
    broadcasts those its service accepted (pixels, and max_length,
    temperature and top_p with NaN for none) and whether it steps, and
    steps; the other ranks get a :class:`_Follower`, which submits the same
    requests in the same order and steps with it (module docstring).
    """
    relay = _relay(service)
    side = service.spec.size
    if relay is not None and not relay.is_main:
        def replay():
            while (head := relay.header())[0] >= 0:
                n, stepping = head
                if n:
                    pixels = relay.array((n, side, side, 3), torch.uint8)
                    params = relay.array((n, 3), torch.float64)
                    for arr, (max_length, temperature, top_p) in zip(pixels, params):
                        service.submit_prepped(
                            arr, None if np.isnan(max_length) else int(max_length),
                            None if np.isnan(temperature) else float(temperature),
                            None if np.isnan(top_p) else float(top_p))
                if stepping:
                    try:
                        for rid in service.step():
                            service.pop_result(rid)
                    except Exception:  # the main rank answers its clients for it
                        _log.exception("serving step failed")

        return _Follower(service.device, replay)
    intake: queue.Queue = queue.Queue()
    stop = object()

    def busy() -> bool:
        return bool(service.queued or service.live or service._inflight)

    def pump():
        rid_map: dict[int, _Pending] = {}
        while True:
            idle = not (rid_map or busy())
            try:  # block only when there is nothing to serve
                item = intake.get(timeout=_IDLE_BEAT_S if relay else None) if idle \
                    else intake.get_nowait()
            except queue.Empty:
                item = None
            accepted = []
            while item is not None:  # drain the burst
                if item is stop:
                    _relayed(relay, None, [], intake, -1)
                    for p in rid_map.values():
                        p.error = "server shut down"
                        p.event.set()
                    return
                try:
                    rid_map[service.submit_prepped(item.array, item.max_length,
                                                   item.temperature, item.top_p)] = item
                    accepted.append(item)
                except Exception as e:  # bad geometry etc.
                    item.error = str(e)
                    item.event.set()
                try:
                    item = intake.get_nowait()
                except queue.Empty:
                    item = None
            stepping = busy()
            if relay and (accepted or stepping or idle):  # before the step; idle: a beat
                arrays = [np.stack([p.array for p in accepted]),
                          np.array([[np.nan if v is None else v
                                     for v in (p.max_length, p.temperature, p.top_p)]
                                    for p in accepted], np.float64)] if accepted else []
                if not _relayed(relay, server, rid_map.values(), intake, len(accepted),
                                int(stepping), *arrays):
                    return
            if not stepping:
                continue
            try:
                done = service.step()
            except Exception as e:  # a device failure: fail every waiter
                _log.exception("serving step failed")
                for p in rid_map.values():
                    p.error = str(e)
                    p.event.set()
                rid_map.clear()
                continue
            for rid, caption in done.items():
                service.pop_result(rid)
                p = rid_map.pop(rid, None)
                if p is not None:
                    p.caption = caption
                    p.event.set()

    def query(handler, qs: dict):
        """(max_length, temperature, top_p) from the query string, or None
        after a 400."""
        out = []
        checks = (
            ("max_length", int, lambda v: 1 <= v <= service.max_length,
             f"max_length must be in [1, {service.max_length}]"),
            ("temperature", float, lambda v: v >= 0.0 and (service.sampled or v == 0.0),
             "temperature must be >= 0 (and the service sampled for temperature > 0)"),
            ("top_p", float, lambda v: 0.0 < v <= 1.0, "top_p must be in (0, 1]"),
        )
        for key, kind, ok, msg in checks:
            value = None
            if qs.get(key):
                try:
                    value = kind(qs[key][0])
                    if not ok(value):
                        raise ValueError
                except ValueError:
                    handler._json(400, {"error": msg})
                    return None
            out.append(value)
        return out

    def do_post(handler):
        from urllib.parse import parse_qs, urlparse

        u = urlparse(handler.path)
        if u.path != "/caption":
            handler._json(404, {"error": "not found"})
            return
        params = query(handler, parse_qs(u.query))
        if params is None:
            return
        arr = _decode_body(handler, max_body_bytes,
                           lambda rgb: resize_and_crop(rgb, service.spec))
        if arr is None:
            return
        p = _Pending(arr, *params)
        intake.put(p)
        _fail_if_lost(relay, p)
        _answer(handler, p, request_timeout_s, "caption timed out")

    thread = _service_thread(service.device, pump, "caption-pump")

    def stop_thread():
        intake.put(stop)
        thread.join(timeout=request_timeout_s)

    server = _http_server(host, port, service, do_post, stop_thread)
    thread.start()
    server.pump_thread = thread
    return server
