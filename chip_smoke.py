"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--only linear`` runs the build and the projections' checks alone,
bf16, float32 (wgmma TF32: its header bound against float64, the TF32
instantiation by name in each trace, its registers and local bytes) and
int8, and prints their records without the summary lines: the way to read
an earlier tree's ``fused_linear`` on the same card.
``--only vocab`` does the same for the four vocabulary kernels — the
greedy argmax, the stored logits, the top-k and the sampler — in bf16, int8
and float32, with their contract sweeps and the float32 walk kernels'
registers and local bytes; ``--only prefill`` for the prefill
kernel (bf16 and float32, its device time by part: LayerNorm, attention,
each product, and the products' kernel names); ``--only quant`` for
the int8 row quantizer and the int8 products whose rows carry no LayerNorm,
which quantize them inside the product; ``--only flash`` for flash
attention (bf16 and float32 at every path shape and its contract, each
path shape's time by CUDA events and from a trace beside its bound, the
twin and SDPA; each instantiation's layout, registers and local bytes; the
backward); ``--only patch`` for the patch embedding (bf16 and float32 at
the three towers' shapes and its contract, events and device ms beside the
bound, the twin and the library route; each route's layout, registers and
local bytes).  ``--only http``, ``--only
pipeline``, ``--only sizes``, ``--only rat`` and ``--only parallel`` run one
of the last five phases below alone, with its launch counts by path.)

It builds the port's CUDA kernels from ``gpt2_image_captioning_tpu_torch/csrc``
(one ``nvcc`` per source, in parallel) and holds each against its plain
PyTorch twin at the main paths' shapes (the GPT-2 prefill at a request of
128 images and an admission of 8, the uint8 patch embedding at the three
towers' shapes among them), with its time beside its bound (the
least time the card could take for the same work) and, where one PyTorch
call computes the same function, that call's time — the int8 modes too: the
row quantizer, int8 weights in the projections and the four vocabulary
kernels (``torch._int_mm`` beside them), the int8 KV cache.  Flash attention
is also held to its twin on its contract beyond the paths' shapes (a causal
tail with a q_offset, T 1,024 masked and causal, hd 96 at T 197), and so
are decode attention (every mode and cache at hd 64 and 128, and hd 42
on its one-element-a-lane route, B 3-128, idx on each boundary of its
walk, the appended rows and scales equal) and the patch embedding (patch 8
and 14, M and D off its tiles), and so are the decode step's projections
in bf16 and int8 (``fused_linear``: every role at D 768, 1024 and 1600, M
1-512, and each role called twice for equal bits), and so are the four
vocabulary kernels (``vocab_contract``: B 1-512 on each boundary of the
walk's row tiles, V 50,257, 1,025 and 100, the argmax and the stored
logits, k 1-16 for the top-k and 1-4 for the sampler, every call twice for
equal bits, bf16, int8 and float32; the argmax's ties forced across ids,
tiles and blocks go to the lowest id).  Decode attention, the patch
embedding and the projections (at the 128 rows of a request and the 512 of
beam-4 and continuous serving, the int8 quantizer's launch apart) also
report their device time from a profiler trace beside the events time,
their library call's too; so do the four vocabulary kernels, at B 128 and
512 (the argmax and the stored logits in float32 too).  Then it drives the
paths the port has, each with the kernels' launch counters set to 0 just
before and read just after:

- greedy serving: exact greedy tokens against the plain path on a tiny
  float32 model (sampled, in-kernel sampled, beam and continuous too), then
  three requests of 128 image embeddings through
  ``ImageCaptioningModel.generate`` at GPT-2 124M width (random weights from
  a seed, bf16, greedy, 50 tokens), and one more traced with
  ``torch.profiler`` for the decode loop's device idle share;
- sampled serving: the same model and requests through
  ``ImageCaptioningModel.generate`` at temperature 1.0, top_p 0.9 (the
  façade's defaults): exact tokens against the plain path on the tiny model
  with one generator seed, then at full width every drawn token must lie in
  the plain path's nucleus, teacher-forced along the kernels' tokens;
- float32 greedy serving, the façade's default (``ImageCaptioningModel``'s
  F32 policy): the three requests with the kernels and with
  ``use_kernels=False``, every token teacher-forced against the float32
  plain path, one request traced for the device time a step;
- beam search: ``beam_generate`` with 4 beams on 128 images (512 decode
  rows), 50 tokens: exact beams against the plain path on the tiny model;
  at full width the score the kernels' search gave each chosen caption
  must be within 0.05 of the plain path's score of it, the kernels'
  captions must score no worse than the plain path's on average, and in
  float32 the captions must be the plain path's; then float32 beam-4 on the
  three requests, one traced for the device time a step;
- a prefix past the prefill kernel's 32 tokens: one greedy request of 128
  embeddings to GPT-2 124M behind a mapper with a 40-token prefix, bf16 and
  float32, kernels and plain in one call; the prefill runs
  ``gpt2.forward_cached`` (flash attention at T 40, causal, 12 launches a
  request beside the mapper's 8), every token teacher-forced;
- int8 serving, each beside its bf16 figure from the same run: greedy W8A8
  through ``ImageCaptioningModel.generate(decode_precision="int8")``, the
  same with the int8 KV cache through ``generate(decode_quant=True,
  decode_quant_cache=True)``, sampled on the logits tail and in the kernel,
  and beam-4 with ``decode_quant=True``: exact tokens against the plain path
  on the tiny float32 model, and at full width every token held to the int8
  plain path (teacher-forced logits within 0.05, the nucleus, beam scores);
- continuous serving: ``ContinuousCaptionService`` fed by image embeddings,
  greedy, sampled on the logits tail and sampled in the kernel: exact
  captions against one-shot ``generate`` on the tiny float32 model, kernels
  on and off; then at full width, 512 slots, 2,048 requests with caps in
  [8, 50], every greedy token teacher-forced against the plain path and
  every sampled token inside the plain path's nucleus; then greedy in int8
  (``decode_precision="int8"``) against the int8 plain path;
- the vision towers at full width, bf16 and float32, random seeded weights, on
  synthetic uint8 pixels already at 224 x 224 (no PIL): CLIP ViT-B/32 at b
  256, ViT-B/16 at b 128, DINOv3 ViT-L/16 at b 64, each through its uint8
  entry point (the patch-embed kernel, the flash kernel at T 50 / 197 /
  201), img/s, launches, features against the plain path, one traced encode;
- images to captions: ``CaptionService(batch_size=128)`` on CLIP B/32 + the
  serving model, greedy and sampled at the façade's defaults, over 4
  batches of synthetic pixels: img/s, the encode / decode split, launches,
  every token held to the plain path; tiny float32 captions from pixels
  equal with and without the kernels, through ``CaptionService`` and the
  continuous service's ``submit_prepped``; extraction (``_run_extraction``
  from an in-memory loader) with the ``.pt`` read back;
- training: the train step (``make_train_step``) at full width — GPT-2 124M
  frozen, the transformer mapper trainable, bf16 compute, AdamW, b 128,
  captions padded to 50 — fed by the ``Batcher``: step-1 loss and gradients
  against the plain path, captions/s over timed steps, peak memory, a
  float32 check at a tiny config, and ten steps on one batch that must
  lower the loss;
- the epoch loop and COCO evaluation: ``train()`` at the same width on a
  synthetic COCO split made here (a 50,257-token byte-level BPE table, 320
  train images x 3 random word captions, 256 val images x 2, 512-d
  embeddings through ``embeddings_io``), two epochs with greedy bf16
  evaluation each epoch: the artifacts on disk, 20 flash launches a step,
  finite losses, a run stopped after one epoch and resumed equal to the
  straight one, one caption per val image; then ``generate_predictions``
  on the trained model in greedy, sampled, beam-4 and int8 greedy, the
  first batch's captions equal to the façade's own decode: captions/s of
  an epoch beside the train step's, seconds by part, eval img/s by mode,
  and which BPE merge loop ran;
- HTTP serving: ``CaptionService(batch_size=128)`` (CLIP B/32 + the serving
  model, bf16, greedy) behind ``serve_http`` with a 50 ms window, 256 JPEG
  bodies of mixed sizes from 32 client threads with every request in
  flight at once: every answer 200 with the caption ``caption_bytes`` gives
  the same body, at most 2 device batches per 128 requests plus 2, the
  400 / 404 / 411 / 413 answers, ``shutdown()`` joining the dispatcher;
  then ``ContinuousCaptionService`` (512 slots, segment 4) behind
  ``serve_http_continuous``, a max_length of 8-50 a request in the query:
  every caption within its cap and teacher-forced against the plain path
  from the embeddings it was served from (its share equal to one-shot
  greedy reported); requests/s and latency p50 / p95 a surface;
- config-driven training: a config.yml-schema file (the transformer mapper
  512 -> 768, GPT-2 124M, bf16, b 128, one epoch, greedy evaluation) on
  synthetic COCO splits and the fabricated tokenizer's ``vocab.json`` +
  ``merges.txt`` in ``$GPT2_TOKENIZER_DIR``: ``training_pipeline.run``,
  then ``sweep.run_one`` for ids 1 and 2 of automation_config.yml and id 1
  with an unfrozen GPT-2: every artifact under its JAX name, GPT-2 moved
  only by the unfrozen run, the test predictions decoded again from
  ``select_test_checkpoint``'s file equal; ``python -m
  gpt2_image_captioning_tpu_torch`` exits 0 naming the card;
- the wide sizes: GPT-2 medium, large and XL at full width, 12 layers, with
  config.yml's transformer mapper at their width (flash at hd 128, 160 and
  200), b 16, 20 tokens, greedy in bf16 and float32 and sampled in bf16,
  held to the plain path by the 124M bounds, peak memory; exact float32
  tokens of a 2-layer, 211-token model of each width;
- retrieval-augmented training (``--only rat``): a ``DeviceVectorStore`` at
  COCO train2017's scale (118,287 images, 591,753 captions, 512-d, float32
  on the card), its fused retrieval's ids against a float64 reference and
  its caption rows bit-equal to a walk of the table, its device ms against
  its bound; the fused RAT train step (b 128, top_k 10, top_i 4, attention
  and mean) against ``use_kernels=False``, captions/s beside the plain
  step's, peak memory, a trace; caption extraction with the CLIP text
  tower at full size (b 256, 4,096 captions, features against the plain
  path); ``sweep.run_one`` for ids 18 and 19 with the test predictions
  decoded again through the rebuilt store, RAT eval img/s in greedy and
  beam-4; ``train_rat`` with the flat and the HNSW store over 8,192
  clustered images (the flat store's ids equal the device store's, HNSW
  recall@4 >= 0.95), the host retrieval's ms a batch and the prefetched
  loop's device idle share; tiny float32 RAT tokens exact;
- data parallelism (``--only parallel``): ranks started as subprocesses of
  this script (``--parallel-rank``) over a ``file://`` rendezvous, after the
  kernel library is built, so the ranks only load it — two gloo ranks
  sharing the card and one nccl rank (a world of one).  Every rank, tiny
  and float32: greedy, W8A8 and beam-4 ``generate`` of 5 rows and
  continuous greedy serving, tokens equal to this process's one-process
  run; three train steps, the losses and the first step's gradients within
  1e-5 of it (the parameters' distance reported), the ranks' parameters
  bit-equal.  The two gloo ranks at full width (GPT-2 124M,
  config.yml's mapper, bf16): greedy ``generate`` of 128 images, 64 rows a
  rank, teacher-forced against the plain path; continuous greedy serving
  over 2 x 256 slots (1,024 requests) held as continuous serving is; one
  train step at b 128 against one process's (the train bounds); CLIP
  extraction at b 256, the file order and features within 1e-2 of one
  process's.  Each rank prints its launch counts by kernel and part, which
  must show the step kernels, decode attention, the prefill, flash
  attention and the patch embedding inside it.  A rank that fails or
  outlives its limit is killed and fails the run.  The phase's seconds are
  those of two ranks sharing one card, not a dp speed.  Tensor and
  pipeline parallelism: two more pairs of gloo ranks on the card, started
  with the dp ranks: at
  tp 2, tiny float32 greedy and beam-4 tokens equal to one process's
  (kernels on both sides), and at full width greedy ``generate`` of 128
  images (teacher-forced as above), ``CaptionService`` from 128 images'
  pixels and the bf16 train step at b 128; at pp 2 the bf16 train step at
  b 128 in 4 microbatches; each train step's loss within 2e-3 of one
  process's, its gradients within 5e-2, its update no farther from one
  process's than one process's own step on the flash kernel's plain twin
  (MP_TRAIN_TOL).  The tp ranks must launch decode
  attention, flash attention and the patch embedding and none of the step
  kernels (the JAX package's layerwise tp branch); the pp ranks flash
  attention.  Decode attention and flash attention are also held to their
  twins at tp's local heads (6 and 3 heads of 64).  Sequence parallelism:
  an sp-2 pair of gloo ranks, started with the others, in the all-gather
  and the ring form: tiny float32 losses and gradients, GPT-2 frozen and
  unfrozen, within 1e-5 of one process's ``mean_loss``; at full width (the
  train step's model and b 128 batch, 66 rows) the loss within 2e-3 and
  the gradients within 5e-2; the all-gather form must launch flash
  attention once a layer more than the ring form (its blocks at the sp
  shape, which ``check_flash`` also holds to the twin: FLASH_SP_SHAPES).
  The dp pair also serves both HTTP endpoints over its tiny float32
  services (rank 0 listens, rank 1 follows): 128 JPEG POSTs each, whose
  captions must equal one process's services' on the same pixels.

Every request and admission prefills through the prefill kernel (an int8
decode through ``forward_cached``, as the reference), and the launch checks
count it.  Each phase prints one JSON line (an ``environment`` record lists
which of PIL, transformers, triton and numpy import); the last three lines
are the kernel table,
the card's name and power limit, and ``{"ok": true, ...}``; the record
before them gives the script's seconds.  Any failed
check raises, so the script exits non-zero without the ``ok`` line.
Without a CUDA device it exits non-zero at once.  Longer output (nvcc's
log, every phase's record) goes to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# Main-path shapes: GPT-2 124M, batch 128, 15 prefix + 50 tokens → Tpad 80.
B, D, H, T, V = 128, 768, 12, 80, 50257
ATTN_IDX = (0, 1, 15, 16, 17, 64)
# Beam search: 4 beams per image, 512 decode rows; the image prefix (15
# positions) is read directly, the rest through the ancestry map.  The
# kernel rows are timed at idx 40, the middle of the 49-step walk.
BEAM_K, P_LEN = 4, 15
B_BEAM = B * BEAM_K
ORIGIN_IDX = (15, 16, 17, 40, 64)
# Decode attention's contract beyond the paths' shapes, every mode (plain,
# origin from position 15, start windows with dead and chunk-straddling
# rows) and cache (float and int8), held to its twin under TOL with the
# appended rows and scales equal: (B, D, H) — GPT-2's, hd 128 at B 3, the
# tiny config's D 192 = 3 x 64 at B 5, and hd 42 at B 3, whose head rows
# (84, 168 and 42 bytes) miss the 16-byte (int8: 8-byte) vector, so the
# kernel walks them one element a lane — at idx on each boundary of the
# kernel's walk (a warp load holds 1, 2, 4 or 8 positions, a block pass 8,
# 32 or 64) and the cache's last row.
ATTN_CONTRACT_SHAPES = ((B, D, H), (3, D, 6), (5, 192, 3), (3, 126, 3))
ATTN_CONTRACT_IDX = (0, 1, 3, 4, 5, 15, 16, 17, 31, 32, 33, 63, 64, 65, 79)
TOP_P = 0.9
# Continuous serving: the pool of 512 rows; the kernel rows of the start
# window and the sampler are timed at its width, attention at idx 64.
B_SERVE = 512
CONTINUOUS = dict(slots=B_SERVE, segment=4, bursts=8, admit=32, max_length=50)
CONTINUOUS_REQUESTS = 2048  # >= recommended_inflight() = 1,823 at these settings
CONTINUOUS_MODES = {"greedy": {}, "sampled": dict(temperature=1.0, top_p=TOP_P),
                    "in_kernel": dict(temperature=1.0, top_p=TOP_P, sample_in_kernel=True)}

# Tolerances, |kernel - plain| <= atol + rtol * |plain|.
# bf16 outputs: the kernel and the twin accumulate in float32 in different
# orders, which can move a result across a bf16 rounding boundary: one ulp,
# 2^-8 relative (0.4 %), so rtol 1e-2 with atol 1e-2 for values near 0.
# float32 residual-stream outputs and all float32 runs: only summation order
# differs, ~1e-6 relative over K <= 3072 terms, so 1e-4.
TOL = {
    torch.bfloat16: {"out": (1e-2, 1e-2), "f32": (1e-4, 1e-4), "gap": 1e-2},
    torch.float32: {"out": (1e-4, 1e-4), "f32": (1e-4, 1e-4), "gap": 1e-4},
}
# Teacher-forced check of the bf16 main path: every token the kernels chose
# must have a plain logit within TF_TOL of that step's plain max logit.
# Random-init logits have std ~0.55 (wte ~ N(0, 0.02) over 768 LN'd inputs);
# the two paths differ by bf16 rounding flips that compound over 12 layers and
# up to 49 steps of cache, measured below as the one-step drift on identical
# inputs.  0.05 is ~9 % of the logit std and several times the drift, yet far
# below the gap to a wrong token picked by a broken kernel (~1 logit std).
# The int8 paths hold the same bound against the int8 twins, started from
# the kernels' prefill (see plain_logits_along); their integer products are
# exact and the step's order-sensitive sums (LayerNorm statistics, gelu,
# attention) run in float64 in kernel and twin alike, so the int8 step's
# one-step drift reads 0.
TF_TOL = 0.05
# The float32 greedy path (the façade's default) by the same check: the
# kernels and the twins differ in summation order and the TF32 split's
# ~2^-21 relative error a product (one_step_drift reports one step's logit
# difference), far below the ~0.1 logit expected between the best two of
# 50,257 random-init logits, and a broken kernel's token lies ~1 logit std
# below the max.  1e-3.
TF_TOL_F32 = 1e-3
# The int8 service's served tokens: 58,000 of them, against 19,200 in a
# one-shot path, and int8's drift is 4.6x bf16's (NUCLEUS_SLACK_INT8), so the
# tail of its deficits reaches further: worst 0.058 in two runs (bf16's
# service 0.016, one-shot int8 0.038).  0.15 is 2.6x that and still ~4x
# below a wrong token of a broken kernel (~1 logit std); the record counts
# the tokens above TF_TOL.
TF_TOL_INT8_SERVED = 0.15
# Sampled path, bf16, teacher-forced along the kernels' tokens: the plain
# path's probability mass strictly above each drawn token's logit must be
# <= top_p + NUCLEUS_SLACK.  The two paths' logits differ by the drift above
# (at most ~1e-2 of a logit); a token whose logit crosses the drawn token's
# moves that mass by its own probability (~2e-5 among 50,257 flat random
# logits), and a few hundred lie within the drift, so the mass moves by
# ~1e-3.  A token drawn outside the nucleus (a wrong mask, or a draw from the
# raw softmax) lies above 0.9 + 0.01 about one time in ten and shows within
# a few draws.
NUCLEUS_SLACK = 0.01
# The int8 paths against the int8 twins: their logits drift 4.6x as far as
# bf16's (worst teacher-forced deficit 0.038 against 0.008, one-step drift
# 0.062 against 0.014; PERF.md §6), so by the same reckoning the mass
# above a drawn token moves 4.6x as far: 0.03.  A draw from outside the
# nucleus lies above 0.93 about one time in fourteen, and a path draws
# ~19,000 tokens.
NUCLEUS_SLACK_INT8 = 0.03
# Beam path, bf16.  The score the kernels' search gives each image's chosen
# caption (sum log-prob / length, accumulated along the ancestry map) must be
# within BEAM_SCORE_TOL of the plain path's score of the same tokens,
# teacher-forced: a token's log-prob moves by at most its logit's drift plus
# the logsumexp's, twice the drift above (~3e-2), and a caption's score is a
# mean of those; wrong ancestry or a wrong top-k/logsumexp scores tokens
# under another history and moves it by whole log-prob gaps.  The kernels'
# captions are not held to the plain path's captions image by image: the
# two searches part at near-ties (at the first token for some images) and
# then end on different beams, whose scores may lie a tenth or more apart
# either way (beam_path reports the spread).  Parting at random, neither
# search is better on average, so the mean shortfall over images, plain
# best minus the kernels' caption, both plain-scored, must stay <=
# BEAM_MEAN_TOL: about a quarter of the 384 images part, with shortfalls of
# ~0.1 either way, so the mean's own spread is ~0.003, and a systematic loss
# of a tenth of a log-prob on the parted images moves it by ~0.025.
BEAM_SCORE_TOL = 0.05
BEAM_MEAN_TOL = 0.02
# Beam path, float32 at full width on BEAM_F32_IMAGES images: the kernels
# and the twins differ by summation order only (~1e-6), far below the gaps
# between candidates at these seeds, so every caption must be the plain
# path's (BEAM_F32_PARTED may part; every run has shown none).
BEAM_F32_IMAGES, BEAM_F32_PARTED = 32, 0
# In-kernel sampler (csrc/logits_sample.cu) against its twin fed the same
# Philox words.  float32: the logits differ by summation order only (~1e-6),
# far below the gaps that decide a Gumbel-max draw or an acceptance, so
# tokens and rounds must be identical.  bf16: a flipped bf16 rounding of an
# LN output moves a logit by ~1e-4, which flips a draw whose two best
# perturbed values lie that close, or an acceptance whose mass lies that
# close to top_p: rare, so >= 99 % of tokens identical, and every drawn token
# inside the twin's nucleus up to NUCLEUS_SLACK.  The logsumexp takes the
# "out" tolerance of the logits.  Temperatures and top_p mix per row; top_p
# 0.5 sends (1 - 0.5)^3 = 1/8 of its rows to a second round.
SAMPLE_TEMPS, SAMPLE_TOPPS = (0.0, 0.7, 1.0, 1.5), (0.5, 0.9, 1.0)
SAMPLE_K, SAMPLE_ROUNDS = 3, 6
SAMPLE_BF16_AGREE = 0.99
# The draws' distribution at fixed logits: SAMPLE_TV_DRAWS rows of one
# logit vector, at a temperature whose top-0.9 nucleus holds 2-32 tokens; the
# TV distance of N exact draws over k outcomes concentrates near
# sqrt(k / (2 pi N)) <= 0.035, so 0.06 (as scripts/kernel_sample_ab.py).
SAMPLE_TV_DRAWS, SAMPLE_TV_TOL = 4096, 0.06
# Vector work of the sampler's bound, per (row, column): a Philox call (10
# rounds of ~10 integer operations) and per candidate two logs and ~5
# operations for each set of draws; ~5 for the scaled logit and its running
# statistics; a compare and an add per candidate for each verification of a
# row; at the float32 rate outside the tensor cores.
PHILOX_OPS, DRAW_OPS, LOGIT_OPS, VERIFY_OPS = 100, 7, 5, 2

# The card's peaks (NVIDIA's H100 SXM data sheet, dense): HBM bytes/s and
# operations/s by the element type of the products.  float32 products of the
# projections, the prefill, the vocabulary walk and flash attention run on
# the tensor cores as a three-term TF32 split, three TF32 products each:
# their bound takes the TF32 peak over three ("tf32x3", 165 TFLOP/s), which
# lies above float32's 67 TFLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12,
              "tf32x3": 495e12 / 3}
VECTOR_OPS_S = 67e12  # float32 outside the tensor cores

# The int8 modes against their twins.  The row quantizer with a LayerNorm:
# the two sides' LN statistics differ in summation order, which can flip the
# rounding of an LN output to the compute dtype, moving one quantized value
# by one step (INT8_STEP) or, where the flipped value is the row's largest,
# the row's scale by that rounding step: one bf16 ulp (2^-8 relative) or a
# few float32 ulps.
INT8_STEP = 1
ROWQUANT_SCALE_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-6}

# Flash attention on the paths: (name, B, H, T, hd, causal, padding mask) —
# the GPT-2 blocks in training (15 prefix + 50 caption positions), the
# transformer mapper (10 + 15 tokens, 768 / 8 heads; at GPT-2 medium, large
# and XL 1024, 1280 and 1600 / 8: hd 128, 160 and 200, the last zero-padded
# to the 208 build), the GPT-2 prefill of the int8 decode (forward_cached),
# a prefix of 40 tokens, past the prefill kernel's 32, which every decode
# prefills through forward_cached (causal, Tq = Tk = 40), the CLIP text
# tower of caption extraction (causal, 77 positions, b 256), and the three
# vision towers at their batches (CLIP B/32: 49 patches + CLS; ViT-B/16:
# 196 + CLS; DINOv3 L/16: 196 + CLS + 4 registers).
FLASH_SHAPES = (
    ("gpt2_train", B, 12, 65, 64, True, True),
    ("mapper", B, 8, 25, 96, False, False),
    ("mapper_gpt2_medium", B, 8, 25, 128, False, False),
    ("mapper_gpt2_large", B, 8, 25, 160, False, False),
    ("mapper_gpt2_xl", B, 8, 25, 200, False, False),
    ("gpt2_prefill", B, 12, 15, 64, True, False),
    ("gpt2_long_prefix", B, 12, 40, 64, True, False),
    ("clip_text_tower", 256, 8, 77, 64, True, False),
    ("clip_tower", 256, 12, 50, 64, False, False),
    ("vit_tower", 128, 12, 197, 64, False, False),
    ("dino_tower", 64, 16, 201, 64, False, False),
)
# Flash kernel against its twin, |kernel - plain| <= atol + rtol * |plain|.
# bf16: the kernel rounds p to bf16 before P V (the twin keeps it float32),
# an error of at most 2^-9 relative per term, and both round the output to
# bf16, which can differ by one ulp (2^-8 relative): 1e-2 / 1e-2.  float32:
# summation order and online against plain softmax only, so 1e-5 / 1e-5.
FLASH_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
# the same kernels at tensor parallelism's local heads: a tp-2 rank's 6 of
# GPT-2 124M's 12 heads in the train step and the prefill (flash), and the
# (B, D / tp) cache of a tp-2 and a tp-4 rank (decode attention)
FLASH_TP_SHAPES = (
    ("gpt2_train_tp2", B, 6, 65, 64, True, True),
    ("gpt2_prefill_tp2", B, 6, 15, 64, True, False),
)
ATTN_TP_SHAPES = ((B, 384, 6), (B, 192, 3))
# and at sequence parallelism's (``parallel/sequence.py``, all-gather form):
# an sp-2 rank's 33 queries of the train step's 66 rows (65 padded to a
# multiple of 2) against the gathered 66 keys, causal, with the key mask, at
# its q_offset: rank 0 at 0 (the keys past its last query all in its
# future), rank 1 at 33 — (name, B, H, Tq, Tk, hd, q_offset)
FLASH_SP_SHAPES = (
    ("gpt2_train_sp2_rank0", B, 12, 33, 66, 64, 0),
    ("gpt2_train_sp2_rank1", B, 12, 33, 66, 64, 33),
)
# The shape a dtype's kernel row reports: bf16 the training step's, which
# launches it most; float32 the mapper's, which the float32 greedy path runs.
FLASH_MAIN = {torch.bfloat16: "gpt2_train", torch.float32: "mapper"}
# The flash kernel's contract beyond the paths' shapes, held to its twin
# under FLASH_TOL, correctness only: (name, B, H, Tq, Tk, hd, causal, key
# mask, q_offset) — a causal tail of 15 queries after 50 positions (Tq < Tk),
# the head of such a sequence (q_offset 0, Tk > Tq: every key past the last
# query in its future), T 1,024 (16 key tiles through the ring, 8 query
# tiles a head) bidirectional with a key mask and causal, and hd 96 at T 197.
FLASH_CONTRACT = (
    ("causal_q_offset", 32, 12, 15, 65, 64, True, False, 50),
    ("causal_head_tk_gt_tq", 32, 12, 15, 65, 64, True, True, 0),
    ("long_masked", 4, 12, 1024, 1024, 64, False, True, 0),
    ("long_causal", 4, 12, 1024, 1024, 64, True, False, 0),
    ("hd96_t197", 32, 8, 197, 197, 96, False, False, 0),
)
# The float32 rows of the kernel table: (source, the TPU kernel it replaces,
# the float32 path whose launches the row reports, what one "ms" covers).
STEP_KERNEL = "gpt2_image_captioning_tpu/ops/decode_step.py"
F32_ROWS = {
    "flash_attention": ("flash_attention.cu", "gpt2_image_captioning_tpu/ops/attention.py:40",
                        "greedy_f32", "call (1 CUDA launch) at the mapper's (128, 8, 25, 96)"),
    "fused_linear": ("fused_linear.cu", f"{STEP_KERNEL}:112", "greedy_f32",
                     "layer: 4 calls (qkv, attn_proj, mlp_fc, mlp_proj; 6 CUDA launches), B 128"),
    "logits_argmax": ("logits_argmax.cu", f"{STEP_KERNEL}:112", "greedy_f32",
                      "call (3 CUDA launches: LN_f split to TF32 pairs, the TF32 walk, the "
                      "merge), B 128"),
    "logits": ("logits.cu", f"{STEP_KERNEL}:617", "sampled_f32",
               "call (2 CUDA launches: LN_f split to TF32 pairs, the TF32 walk), B 128"),
    "logits_topk": ("logits_topk.cu", f"{STEP_KERNEL}:569", "beam_f32",
                    "call (3 CUDA launches: LN_f split to TF32 pairs, the TF32 walk, the "
                    "merge), B 512, k 4"),
    "logits_sample": ("logits_sample.cu", f"{STEP_KERNEL}:641", "in_kernel_f32",
                      "call (2 + 2 x 6 CUDA launches: LN_f split to TF32 pairs, the TF32 walk, "
                      "per round a verification and a draw), B 512, temperature 1.0, top_p 0.9"),
    "prefill": ("prefill.cu", "gpt2_image_captioning_tpu/ops/prefill_step.py:87", "greedy_f32",
                "call (84 CUDA launches: 7 a layer), GPT-2 124M, B 128 x 15 tokens"),
    "patch_embed": ("patch_embed.cu", "gpt2_image_captioning_tpu/ops/patch_embed.py:36",
                    "tower_clip_f32", "call (1 CUDA launch), CLIP B/32, b 256, 224 px"),
}
# Training, bf16, kernel path against use_kernels=False on the same weights
# and batch.  The two paths differ only in attention: the kernel rounds
# unnormalised p to bf16 and divides in float32, the plain path rounds the
# normalised probabilities to bf16; each is within a bf16 ulp of the exact
# value, and the difference passes through 20 layers in each direction.
# Loss: ~0.4 % noise per element averages over 6,400 caption positions, so
# |d loss| <= 1e-2 on a loss of ~10.8 (0.1 %).  Mapper gradients:
# ||g_kernel - g_plain|| / ||g_plain|| <= 5e-2, several bf16 ulps compounded
# over the backward, yet far below the O(1) error of a wrong gradient.
# float32 at the tiny config: the loss to 1e-5 relative and each gradient
# leaf to 1e-4 of its largest element (summation order only).
TRAIN_TOL = {"loss_bf16": 1e-2, "grad_bf16": 5e-2, "loss_f32": 1e-5, "grad_f32": 1e-4}
# Flash backward (the torch recompute of FlashAttention) fed by the kernel's
# forward against the twin's: the outputs, and so the incoming gradient of
# the test loss, differ by a bf16 ulp, so 1e-2 relative in norm.
FLASH_BWD_TOL = 1e-2

# The prefill kernel (csrc/prefill.cu) against its twin, GPT-2 124M: a
# request (B 128 images x 15 prefix tokens) and an admission of 8 images.
# bf16: Q, K, V, the attention output and the MLP's hidden layer round to
# bf16 in both, and a summation-order difference flips one such rounding by
# an ulp (2^-8 relative), which the later layers carry; measured on an
# H100: 2.9e-3 on the float32 residual stream (|max| 2.7), one ulp on cache
# rows (1.6e-2 at values in [2, 4)), 6.6e-3 on the first-token logits.
# float32: summation order only (measured <= 4e-6).
PREFILL_BATCHES = (B, 8)
PREFILL_TOL = {
    torch.bfloat16: {"x32": (1e-2, 1e-2), "cache": (1e-2, 1e-2), "logits": (2e-2, 1e-2)},
    torch.float32: {"x32": (1e-4, 1e-4), "cache": (1e-4, 1e-4), "logits": (1e-4, 1e-4)},
}
# The towers at full width on synthetic uint8 pixels already at 224 x 224:
# (name, batch, patch, width, bias) — CLIP ViT-B/32 at b 256, ViT-B/16 at
# b 128, DINOv3 ViT-L/16 at b 64; flash attention at T 50, 197 and 201; in
# bf16, then in float32 (the tower functions' default policy).
TOWERS = (("clip", 256, 32, 768, False), ("vit", 128, 16, 768, True),
          ("dino", 64, 16, 1024, True))
CLIP_LAYERS = 12  # CLIP ViT-B/32's, the tower of image serving
# The patch-embed kernel (csrc/patch_embed.cu) against its twin: both round
# the same normalised values to the operand type (the same float32 steps),
# so only the product's summation order differs (measured: bf16 1.4e-5,
# float32 6.2e-6 at outputs of |max| 7; float32 runs as the three-term TF32
# split, its accumulator chains at most ops/patch_embed.py::PE_TF32_CHAIN
# k8 steps long).
PATCH_TOL = (1e-4, 1e-4)
# Its contract beyond the towers' shapes, correctness only: (name, images,
# side, patch, D, bias) — the tiny towers' patch 8 at 32 px (24-byte patch
# rows) and a CLIP L/14-like patch 14 at 224 px (42-byte rows), both on the
# kernel's byte-load route, and M and D that are not multiples of the tile
# (48 rows of D 200 at patch 16, 48-byte rows; 49 rows of D 48 at patch 32,
# 96-byte rows), both on its 16-byte vector route.  patch_embed.cu's
# dispatch alone decides the route.
PATCH_CONTRACT = (("clip", 3, 32, 8, 768, True), ("clip", 5, 224, 14, 1024, False),
                  ("vit", 3, 64, 16, 200, True), ("clip", 1, 224, 32, 48, False))
# Tower features, bf16, kernels against use_kernels=False on the same
# weights and pixels: the flash kernel rounds unnormalised p to bf16 where
# the plain attention rounds the probabilities, over 12-24 layers; measured
# on an H100 at most 1.8e-3 on unit vectors (components up to 0.19), cosine
# >= 0.99993.  Held to 1e-2 and 0.999: a wrong patch layout or mask moves
# features by O(0.1) and the cosine far below.
TOWER_TOL, TOWER_COS = 1e-2, 0.999
# Image serving: CaptionService on CLIP B/32 + GPT-2 124M, 4 device batches
# of 128 synthetic images each, greedy and sampled at the façade's defaults.
IMAGE_BATCHES = 4
# Extraction: three loader batches of 64 (the last with 40 valid images).
EXTRACT_BATCHES, EXTRACT_TAIL = 3, 40

RESULTS: list[dict] = []
T0 = time.perf_counter()


def emit(record: dict) -> None:
    record = {**record, "elapsed_s": time.perf_counter() - T0}
    RESULTS.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close(got: torch.Tensor, want: torch.Tensor, tol: tuple[float, float]) -> float:
    """Max |got - want|; raises unless within atol + rtol * |want| everywhere."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float(diff.max())
    check(bool((diff <= bound).all()), f"max |diff| {worst} exceeds atol {atol} + rtol {rtol}")
    return worst


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Microseconds of the host's enqueue of one call: ``iters`` calls back to
    back on the host clock, without waiting for the device (the queue holds
    far more launches than that)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def device_split(fn, kernels: tuple[str, ...], trace_name: str, iters: int = 20,
                 attempts: int = 3) -> dict | str:
    """Mean device time of one call from a ``traced`` window over ``iters``
    calls: over every device event in the window (kernels, copies, memsets)
    as "total", and over the kernels whose name holds each of ``kernels``.
    Unlike ``time_ms`` it leaves out the host's enqueue.  A window in which
    CUPTI lost the device record of any launch, or that holds none of a
    named kernel, is traced again, up to ``attempts`` windows; "not
    measured" if none was whole."""
    fn()
    for _ in range(attempts):
        _, events, dropped = traced(lambda: [fn() for _ in range(iters)], trace_name)
        spans = {k: [e["dur"] for e in events if e["cat"] == "kernel" and k in e["name"]]
                 for k in kernels}
        if events and not dropped and all(spans.values()):
            return {"total": sum(e["dur"] for e in events) / iters / 1e3,
                    **{k: sum(v) / iters / 1e3 for k, v in spans.items()}}
    return "not measured"


def device_ms(fn, kernel: str | None, trace_name: str, iters: int = 20,
              attempts: int = 3) -> float | str:
    """:func:`device_split`'s time of the kernels whose name holds
    ``kernel``, or of every device event for None — the library routes,
    which launch several."""
    got = device_split(fn, () if kernel is None else (kernel,), trace_name, iters, attempts)
    return got if isinstance(got, str) else got["total" if kernel is None else kernel]


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """Least time in ms for work that must move ``nbytes`` and do ``ops``
    operations of ``dtype`` products, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_type(dtype):
    """The product type whose peak bounds the tile kernels and flash
    attention: float32 runs as the three-term TF32 split."""
    return "tf32x3" if dtype == torch.float32 else dtype


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def attention_contract(dtype, g) -> dict:
    """``csrc/decode_attention.cu`` against its twin at ATTN_CONTRACT_SHAPES
    x ATTN_CONTRACT_IDX in every mode and cache: the outputs within TOL, the
    caches (and the int8 scales) equal to the twin's after the append."""
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    worst, cases = 0.0, 0
    for b, d, h in ATTN_CONTRACT_SHAPES:
        for idx in ATTN_CONTRACT_IDX:
            for mode in ("plain", "origin", "start"):
                kw = {}
                if mode == "origin":
                    kw = {"origin": beam_origin(T, b, g), "gather_start": P_LEN}
                elif mode == "start":
                    st = torch.randint(0, idx + 1, (b,), generator=g, device="cuda")
                    st[:3] = torch.tensor([idx, 0, min(17, idx)], device="cuda")[: min(b, 3)]
                    kw = {"start": st.to(torch.int32)}
                for quant in (False, True):
                    q, kn, vn = (torch.randn(b, d, generator=g, device="cuda").to(dtype)
                                 for _ in range(3))
                    if quant:
                        kc, vc, ks, vs = int8_caches(T, b, dtype, g, d)
                        scales = {"k_scale": ks, "v_scale": vs}
                    else:
                        kc, vc = (torch.randn(T, b, d, generator=g, device="cuda").to(dtype)
                                  for _ in range(2))
                        kc[idx:], vc[idx:] = 1e4, -1e4  # rows >= idx must never be attended
                        scales = {}
                    state = [kc, vc, *scales.values()]
                    twin = [t.clone() for t in state]
                    tw_scales = dict(zip(scales, twin[2:]))
                    want = DA._decode_attention_plain(q, kn, vn, twin[0], twin[1], idx, h,
                                                      **kw, **tw_scales)
                    got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, h, **kw, **scales)
                    torch.cuda.synchronize()
                    worst = max(worst, close(got, want, TOL[dtype]["out"]))
                    check(all(torch.equal(a, c) for a, c in zip(state, twin)),
                          f"caches differ after the append: B {b}, D {d}, H {h}, idx {idx}, "
                          f"{mode}, int8 {quant}")
                    cases += 1
    return {"cases": cases, "max_abs_err": worst,
            "shapes": [list(s) for s in ATTN_CONTRACT_SHAPES], "idx": list(ATTN_CONTRACT_IDX)}


def check_attention(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    contract = attention_contract(dtype, g)
    worst = 0.0
    for idx in ATTN_IDX:
        q, kn, vn = (torch.randn(B, D, generator=g, device="cuda").to(dtype) for _ in range(3))
        kc = torch.randn(T, B, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(T, B, D, generator=g, device="cuda").to(dtype)
        kc[idx:], vc[idx:] = 1e4, -1e4  # rows >= idx must never be attended
        kp, vp = kc.clone(), vc.clone()
        want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H)
        got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, TOL[dtype]["out"]))
        check(torch.equal(kc, kp) and torch.equal(vc, vp), f"cache rows differ at idx {idx}")
    idx = max(ATTN_IDX)
    def kernel():
        return DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H))
    # the library call: SDPA of the query over cache rows [0, idx] (the append excluded)
    hd, el = D // H, q.element_size()
    q4 = q.view(B, H, 1, hd)
    k4, v4 = (c[: idx + 1].view(idx + 1, B, H, hd).permute(1, 2, 0, 3) for c in (kc, vc))
    def library():
        return F.scaled_dot_product_attention(q4, k4, v4)

    library_ms = time_ms(library)
    tag = str(dtype).replace("torch.", "")
    dev = device_ms(kernel, "decode_attention_kernel", f"kernel_decode_attention_{tag}.json")
    library_dev = device_ms(library, None, f"library_decode_attention_{tag}.json")
    # cache rows read, q / k_new / v_new read, the output and the appended rows written
    nbytes = el * B * D * (2 * idx + 3 + 1 + 2)
    bound_ms, bound_by = bound(nbytes, 4 * B * D * (idx + 1), dtype)
    local = attention_local_heads(dtype, g)
    return {"kernel": "decode_attention", "max_abs_err": max(worst, local["max_abs_err"]),
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library": "scaled_dot_product_attention over the cache",
            "at": f"B {B}, D {D}, H {H}, T {T}, idx {idx}", "contract": contract,
            "tp_local_heads": local}


def attention_local_heads(dtype, g) -> dict:
    """Decode attention against its twin at a tp rank's cache widths
    (ATTN_TP_SHAPES) at every ATTN_IDX: the outputs within TOL, the caches
    equal after the append; ms of one call at idx 64 beside its twin's."""
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    worst, timed = 0.0, {}
    for b, d, h in ATTN_TP_SHAPES:
        for idx in ATTN_IDX:
            q, kn, vn = (torch.randn(b, d, generator=g, device="cuda").to(dtype)
                         for _ in range(3))
            kc, vc = (torch.randn(T, b, d, generator=g, device="cuda").to(dtype)
                      for _ in range(2))
            kc[idx:], vc[idx:] = 1e4, -1e4  # rows >= idx must never be attended
            kp, vp = kc.clone(), vc.clone()
            want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, h)
            got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, h)
            torch.cuda.synchronize()
            worst = max(worst, close(got, want, TOL[dtype]["out"]))
            check(torch.equal(kc, kp) and torch.equal(vc, vp),
                  f"cache rows differ at B {b}, D {d}, idx {idx}")
        timed[f"D {d}, H {h}"] = {
            "ms": time_ms(lambda: DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, h)),
            "plain_ms": time_ms(lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, h))}
    return {"shapes": [list(s) for s in ATTN_TP_SHAPES], "idx": list(ATTN_IDX),
            "max_abs_err": worst, "tolerance": TOL[dtype]["out"], "at_idx_64": timed}


def beam_origin(tpad: int, rows: int, g) -> torch.Tensor:
    """A random ancestry map inside each group of BEAM_K rows, as beam
    search builds one: (T, rows) int32."""
    base = (torch.arange(rows, device="cuda") // BEAM_K * BEAM_K)[None, :]
    pick = torch.randint(0, BEAM_K, (tpad, rows), generator=g, device="cuda")
    return (base + pick).clamp(max=rows - 1).to(torch.int32).contiguous()


def check_attention_origin(dtype, g) -> dict:
    """``csrc/decode_attention.cu`` in beam mode: 512 rows, a random in-group
    ancestry map read from position 15 (the image prefix) on."""
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    b = B_BEAM
    origin = beam_origin(T, b, g)
    worst = 0.0
    for idx in ORIGIN_IDX:
        q, kn, vn = (torch.randn(b, D, generator=g, device="cuda").to(dtype) for _ in range(3))
        kc = torch.randn(T, b, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(T, b, D, generator=g, device="cuda").to(dtype)
        kc[idx:], vc[idx:] = 1e4, -1e4  # rows >= idx must never be attended
        kp, vp = kc.clone(), vc.clone()
        want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, origin, P_LEN)
        got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, origin, P_LEN)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, TOL[dtype]["out"]))
        check(torch.equal(kc, kp) and torch.equal(vc, vp), f"cache rows differ at idx {idx}")
    idx = 40
    q, kn, vn = (torch.randn(b, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    def kernel():
        return DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, origin, P_LEN)

    ms = time_ms(kernel)
    plain_ms = time_ms(
        lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, origin, P_LEN))
    # the library's way: gather the rows the map names, then SDPA over them
    src = torch.arange(b, device="cuda").expand(idx + 1, b).clone()
    src[P_LEN:idx] = origin[P_LEN:idx].long()
    gidx = src[:, :, None].expand(idx + 1, b, D)
    hd, el = D // H, q.element_size()

    def library():
        k4, v4 = (c[: idx + 1].gather(1, gidx).view(idx + 1, b, H, hd).permute(1, 2, 0, 3)
                  for c in (kc, vc))
        return F.scaled_dot_product_attention(q.view(b, H, 1, hd), k4, v4)

    library_ms = time_ms(library)
    tag = str(dtype).replace("torch.", "")
    dev = device_ms(kernel, "decode_attention_kernel",
                    f"kernel_decode_attention_origin_{tag}.json")
    library_dev = device_ms(library, None, f"library_decode_attention_origin_{tag}.json")
    # the cache rows that must be read, K and V each: every row's own below
    # gather_start, and from there each distinct (position, source row) the
    # map names, once (beams of one image share ancestors); q / k_new / v_new
    # read, the output and the appended rows written, and the map's entries
    # for the gathered positions
    rows_read = b * P_LEN + sum(int(torch.unique(origin[t]).numel()) for t in range(P_LEN, idx))
    nbytes = el * D * (2 * rows_read + b * (3 + 1 + 2)) + 4 * (idx - P_LEN) * b
    bound_ms, bound_by = bound(nbytes, 4 * b * D * (idx + 1), dtype)
    return {"kernel": "decode_attention", "mode": "origin", "max_abs_err": worst, "ms": ms,
            "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "cache_rows_read": rows_read, "cache_rows_named": idx * b,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library": "gather of the cache by origin + SDPA",
            "at": f"B {b}, D {D}, H {H}, T {T}, idx {idx}, gather_start {P_LEN}"}


def check_attention_start(dtype, g) -> dict:
    """``csrc/decode_attention.cu`` with per-row windows, as continuous
    serving runs it: 512 rows at idx 64, random starts in [0, idx] — some
    not chunk-aligned, some equal to idx (dead rows) — with garbage below
    each row's start."""
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    b, idx = B_SERVE, 64
    start = torch.randint(0, idx + 1, (b,), generator=g, device="cuda").to(torch.int32)
    start[:8] = torch.tensor([0, 1, 15, 16, 17, 33, idx, idx], dtype=torch.int32, device="cuda")
    q, kn, vn = (torch.randn(b, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    kc = torch.randn(T, b, D, generator=g, device="cuda").to(dtype)
    vc = torch.randn(T, b, D, generator=g, device="cuda").to(dtype)
    dead = (torch.arange(T, device="cuda")[:, None] < start[None, :].long()) | (
        torch.arange(T, device="cuda")[:, None] >= idx)
    kc[dead], vc[dead] = 1e4, -1e4  # outside [start_r, idx): never attended
    kp, vp = kc.clone(), vc.clone()
    want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, start=start)
    got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, start=start)
    torch.cuda.synchronize()
    worst = close(got, want, TOL[dtype]["out"])
    check(torch.equal(kc, kp) and torch.equal(vc, vp), "cache rows differ")
    def kernel():
        return DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, start=start)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, start=start))
    # the library call: SDPA over cache rows [0, idx] with each row's window as a mask
    hd, el = D // H, q.element_size()
    pos = torch.arange(idx + 1, device="cuda")
    mask = (pos[None, :] >= start[:, None].long())[:, None, None, :]
    q4 = q.view(b, H, 1, hd)
    k4, v4 = (c[: idx + 1].view(idx + 1, b, H, hd).permute(1, 2, 0, 3) for c in (kc, vc))
    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    library_ms = time_ms(library)
    tag = str(dtype).replace("torch.", "")
    dev = device_ms(kernel, "decode_attention_kernel",
                    f"kernel_decode_attention_start_{tag}.json")
    library_dev = device_ms(library, None, f"library_decode_attention_start_{tag}.json")
    # each row's window read (K and V), q / k_new / v_new / start read, the
    # output and the appended rows written
    window = int((idx - start.long()).sum())
    nbytes = el * D * (2 * window + b * (3 + 1 + 2)) + 4 * b
    bound_ms, bound_by = bound(nbytes, 4 * D * (window + b), dtype)
    return {"kernel": "decode_attention", "mode": "start", "max_abs_err": worst, "ms": ms,
            "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "window_rows": window, "dead_rows": int((start == idx).sum()),
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library": "scaled_dot_product_attention, window mask",
            "at": f"B {b}, D {D}, H {H}, T {T}, idx {idx}, random starts"}


def sampler_bound(b: int, wte, temp, rnd) -> tuple[float, str, dict]:
    """Least time of the draw over B rows that resolved in rounds ``rnd``
    (B,): the larger of wte's bytes (read once) and the rows' (temp, top_p,
    x) read and (token, round, lse) written at the memory rate, one product
    of the B rows at the tensor-core rate, and the vector work at its rate:
    the logits' statistics for every row, one set of k draws per (sampled
    row, column), fresh sets only for the rows a round leaves unresolved,
    and the check of each candidate in every round a row reaches.  The
    kernel keeps no logits, so each round walks wte again: that second walk
    is a cost of its design, not of the work, and is not counted."""
    sampled = int((temp > 0).sum())
    verify = sum(int((rnd >= r).sum()) for r in range(1, SAMPLE_ROUNDS + 1))
    fresh = sum(int((rnd > r).sum()) for r in range(1, SAMPLE_ROUNDS + 1))
    nbytes = V * D * wte.element_size() + b * (4 * D + 8 + 12) + 8 * D
    products = 2 * D * V * b
    draw = PHILOX_OPS + SAMPLE_K * DRAW_OPS
    vector = V * (b * LOGIT_OPS + (sampled + fresh) * draw + verify * SAMPLE_K * VERIFY_OPS)
    times = {"bytes": nbytes / HBM_BYTES_S * 1e3,
             "operations": max(products / PEAK_OPS_S[split_type(wte.dtype)],
                               vector / VECTOR_OPS_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by, {"bytes": nbytes, "product_flop": products, "vector_ops": vector,
                           "draw_rows": sampled + fresh, "verify_rows": verify}


def nucleus_excess(lq: torch.Tensor, tokens: torch.Tensor, top_p: torch.Tensor) -> float:
    """Largest (probability mass strictly above a drawn token's scaled logit)
    minus its row's top_p; lq (B, V) float32 scaled logits."""
    prob = torch.softmax(lq.double(), dim=-1)
    chosen = lq.gather(1, tokens.long()[:, None])
    above = torch.where(lq > chosen, prob, 0.0).sum(dim=-1)
    return float((above - top_p.double()).max())


def check_sampler(dtype, g) -> dict:
    """``csrc/logits_sample.cu`` against ``sample_step_plain`` fed the same
    Philox words, at B 128 and 512 with temperatures and top_p mixed per
    row, and with top_p < 0 and 3 rounds (every round runs, then the
    fallback); then 4,096 draws at fixed logits against the exact
    renormalised nucleus."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import sampling as S

    cases, lse_err, worst_excess = {}, 0.0, -1.0
    for b in (B, B_SERVE):
        x32, lnf, wte = vocab_inputs(b, dtype, g)
        rows = torch.arange(b, device="cuda")
        temp = torch.tensor(SAMPLE_TEMPS, device="cuda")[rows % len(SAMPLE_TEMPS)].contiguous()
        top_p = torch.tensor(SAMPLE_TOPPS, device="cuda")[(rows // 4) % len(SAMPLE_TOPPS)]
        lq = DS.logits_plain(x32, lnf, wte) / torch.where(temp > 0, temp, 1.0)[:, None]
        for case, tp, rounds in (("mixed", top_p.contiguous(), SAMPLE_ROUNDS),
                                 ("forced", torch.full_like(top_p, -1.0), 3)):
            seed = 1000 + b + rounds
            tok, rnd, lse = DS.logits_sample_cuda(x32, lnf, wte, temp, tp, seed, SAMPLE_K, rounds)
            wtok, wrnd, wlse = S.sample_step_plain(x32, lnf, wte, temp, tp, seed, SAMPLE_K, rounds)
            torch.cuda.synchronize()
            same_tok = float((tok == wtok).float().mean())
            same_rnd = float((rnd == wrnd).float().mean())
            lse_err = max(lse_err, close(lse, wlse, TOL[dtype]["out"]))
            if dtype == torch.float32:
                check(same_tok == 1.0 and same_rnd == 1.0,
                      f"sampler {case} B {b}: tokens {same_tok}, rounds {same_rnd} identical")
            else:
                check(same_tok >= SAMPLE_BF16_AGREE, f"sampler {case} B {b}: {same_tok} identical")
            greedy = temp == 0
            check(bool((rnd[greedy] == 0).all()), "a temperature-0 row did not resolve in round 0")
            if case == "forced":
                check(bool((rnd[~greedy] == rounds + 1).all()), "top_p < 0: a row did not fall back")
            else:
                excess = nucleus_excess(lq[~greedy], tok[~greedy], tp[~greedy])
                worst_excess = max(worst_excess, excess)
                check(excess <= NUCLEUS_SLACK, f"a drawn token lies {excess} outside its nucleus")
            cases[f"{case}_B{b}"] = {"tokens_identical": same_tok, "rounds_identical": same_rnd,
                                     "rounds_histogram": torch.bincount(rnd).tolist()}

    # the draws' distribution at fixed logits: SAMPLE_TV_DRAWS copies of one
    # row, at the highest temperature (from 1, by factors of 0.8) whose
    # nucleus holds at most 32 tokens
    x32, lnf, wte = vocab_inputs(1, dtype, g)
    lg = DS.logits_plain(x32, lnf, wte)[0].double()
    order = torch.argsort(lg, descending=True)

    def mass_above(t):
        prob = torch.softmax(lg / t, dim=0)
        above = torch.empty_like(prob)
        above[order] = torch.cumsum(prob[order], 0) - prob[order]
        return prob, above

    t = 1.0
    while int((mass_above(t)[1] <= TOP_P).sum()) > 32:
        t *= 0.8
    prob, above = mass_above(t)
    n = SAMPLE_TV_DRAWS
    tok, rnd, _ = DS.logits_sample_cuda(
        x32.expand(n, D).contiguous(), lnf, wte, torch.full((n,), t, device="cuda"),
        torch.full((n,), TOP_P, device="cuda"), 77, SAMPLE_K, SAMPLE_ROUNDS)
    nucleus = above <= TOP_P
    want = torch.where(nucleus, prob, 0.0)
    want /= want.sum()
    got = torch.bincount(tok.long(), minlength=V).double() / n
    tv = 0.5 * float((got - want).abs().sum())
    outside = float((above[tok.long()] > TOP_P + NUCLEUS_SLACK).double().mean())
    check(outside == 0.0, f"{outside} of the fixed-logit draws lie outside the nucleus")
    check(tv <= SAMPLE_TV_TOL, f"fixed-logit draws: TV {tv} > {SAMPLE_TV_TOL}")

    # time at the continuous path's width and draw: temperature 1.0, top_p 0.9
    x32, lnf, wte = vocab_inputs(B_SERVE, dtype, g)
    temp = torch.full((B_SERVE,), 1.0, device="cuda")
    top_p = torch.full((B_SERVE,), TOP_P, device="cuda")
    ms = time_ms(lambda: DS.logits_sample_cuda(x32, lnf, wte, temp, top_p, 5, SAMPLE_K,
                                                SAMPLE_ROUNDS))
    plain_ms = time_ms(lambda: S.sample_step_plain(x32, lnf, wte, temp, top_p, 5, SAMPLE_K,
                                                   SAMPLE_ROUNDS), iters=3, warmup=1)
    _, wrnd, _ = S.sample_step_plain(x32, lnf, wte, temp, top_p, 5, SAMPLE_K, SAMPLE_ROUNDS)
    bound_ms, bound_by, work = sampler_bound(B_SERVE, wte, temp, wrnd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eager_ms = time_ms(lambda: S.sample_rows(library_logits(x32, lnf, wte), temp, top_p, gen))
    name = f"logits_sample_{str(dtype).replace('torch.', '')}"
    x128, t128, p128 = x32[:B].contiguous(), temp[:B].contiguous(), top_p[:B].contiguous()
    devices = {
        "device_ms": vocab_device(lambda: DS.logits_sample_cuda(
            x32, lnf, wte, temp, top_p, 5, SAMPLE_K, SAMPLE_ROUNDS), name),
        "device_ms_b128": vocab_device(lambda: DS.logits_sample_cuda(
            x128, lnf, wte, t128, p128, 5, SAMPLE_K, SAMPLE_ROUNDS), f"{name}_b128"),
        "ms_b128": time_ms(lambda: DS.logits_sample_cuda(x128, lnf, wte, t128, p128, 5, SAMPLE_K,
                                                         SAMPLE_ROUNDS))}
    return {"kernel": "logits_sample", "max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work, "library_ms": None,
            "library_device_ms": None, **devices,
            "eager_tail_ms": eager_ms, "eager_tail": "layer_norm + mm + ops.sampling.sample_rows",
            "at": f"B {B_SERVE}, D {D}, V {V}, k {SAMPLE_K}, rounds {SAMPLE_ROUNDS}, "
                  f"temperature 1.0, top_p {TOP_P}",
            "cases": cases, "worst_nucleus_excess": worst_excess,
            "fixed_logits": {"draws": n, "temperature": t, "nucleus": int(nucleus.sum()),
                             "tv": tv, "tolerance": SAMPLE_TV_TOL,
                             "rounds_histogram": torch.bincount(rnd).tolist()}}


def check_dot_f32(g) -> dict:
    """The bf16 plain twins on the card multiply through ``ops/nn.py::dot_f32``'s
    CUDA branch (cuBLAS with a float32 output), while the CPU tests hold the
    upcast branch to the JAX package.  Both give exact bf16 products summed in
    float32, so they may differ only by summation order: ~1e-6 relative."""
    from gpt2_image_captioning_tpu_torch.ops import nn

    a = torch.randn(B, D, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
    w = (0.02 * torch.randn(D, 3 * D, generator=g, device="cuda")).to(torch.bfloat16)
    w.requires_grad_()
    got = nn.dot_f32(a, w)
    want = torch.matmul(a.float(), w.float())
    err = close(got.detach(), want.detach(), TOL[torch.float32]["f32"])
    # its gradient: the incoming float32 gradient rounded to bf16, the
    # products summed in float32, the result rounded to bf16 — against the
    # same arithmetic upcast; bf16 outputs, so one ulp apart at most
    gy = torch.randn(B, 3 * D, generator=g, device="cuda")
    da, dw = torch.autograd.grad(got, (a, w), gy)
    g16 = gy.to(torch.bfloat16).float()
    a32, w32 = a.detach().float(), w.detach().float()
    grad_err = max(close(da, (g16 @ w32.t()).to(torch.bfloat16), TOL[torch.bfloat16]["out"]),
                   close(dw, (a32.t() @ g16).to(torch.bfloat16), TOL[torch.bfloat16]["out"]))
    return {"phase": "dot_f32_branches", "at": f"({B}, {D}) @ ({D}, {3 * D}) bf16",
            "max_abs_err": err, "grad_max_abs_err": grad_err}


def vocab_inputs(b: int, dtype, g):
    """The vocabulary kernels' inputs as the step gives them: the float32
    residual stream, LN_f's (2, D) scale and bias, and wte (V, D)."""
    x32 = 3.0 * torch.randn(b, D, generator=g, device="cuda")
    lnf = torch.stack([1 + 0.1 * torch.randn(D, generator=g, device="cuda"),
                       0.1 * torch.randn(D, generator=g, device="cuda")]).contiguous()
    wte = (0.02 * torch.randn(V, D, generator=g, device="cuda")).to(dtype)
    return x32, lnf, wte


def library_logits(x32, lnf, wte):
    """One PyTorch LayerNorm and one product with a float32 result: the
    library's way to the step's logits (timed only here)."""
    xf = F.layer_norm(x32, (D,), lnf[0], lnf[1], 1e-5).to(wte.dtype)
    if wte.dtype == torch.bfloat16:
        return torch.mm(xf, wte.t(), out_dtype=torch.float32)
    return torch.mm(xf, wte.t())


def vocab_bytes(b: int, wte, out_bytes: int) -> int:
    """wte, the residual rows and LN_f read, ``out_bytes`` written."""
    return V * D * wte.element_size() + 4 * b * D + 8 * D + out_bytes


def vocab_device(run, name: str) -> float | str:
    """Device ms of one call of a wrapper (a vocabulary kernel's, the
    prefill's) or of its library route, from a ``traced`` window: every
    device event of the call (pass 0, the walk or walks, the merge; a memset
    where the wrapper makes one)."""
    return device_ms(run, None, f"{name}_trace.json")


def check_logits(dtype, g) -> dict:
    """``csrc/logits.cu`` (emit_logits) at the sampled path's B 128, and its
    device time at B 128 and 512 beside the library's.  The kernel and the
    twin both round LN_f's output to the compute dtype; their float32
    statistics differ in summation order, which can flip a bf16 rounding of
    that output, moving a logit by |w| x one bf16 ulp of the LN output
    (< 1e-2): the "out" tolerance.  Two calls give equal bits."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x512, lnf, wte = vocab_inputs(B_BEAM, dtype, g)
    x32 = x512[:B].contiguous()
    want = DS.logits_plain(x32, lnf, wte)
    got = DS.logits_cuda(x32, lnf, wte)
    torch.cuda.synchronize()
    check(got.shape == (B, V) and got.dtype == torch.float32, f"logits shape {got.shape}")
    check(torch.equal(got, DS.logits_cuda(x32, lnf, wte)), "logits: two calls differ")
    err = close(got, want, TOL[dtype]["out"])
    ms = time_ms(lambda: DS.logits_cuda(x32, lnf, wte))
    plain_ms = time_ms(lambda: DS.logits_plain(x32, lnf, wte))
    library_ms = time_ms(lambda: library_logits(x32, lnf, wte))
    nbytes = vocab_bytes(B, wte, 4 * B * V)
    bound_ms, bound_by = bound(nbytes, 2 * B * D * V, split_type(dtype))
    name = f"logits_{str(dtype).replace('torch.', '')}"
    devices = {"device_ms": vocab_device(lambda: DS.logits_cuda(x32, lnf, wte), name),
               "library_device_ms": vocab_device(lambda: library_logits(x32, lnf, wte),
                                                 f"{name}_library"),
               "device_ms_b512": vocab_device(lambda: DS.logits_cuda(x512, lnf, wte),
                                              f"{name}_b512"),
               "library_device_ms_b512": vocab_device(lambda: library_logits(x512, lnf, wte),
                                                      f"{name}_library_b512")}
    return {"kernel": "logits", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, **devices,
            "library_ms": library_ms, "library": "layer_norm + mm with a float32 result",
            "at": f"B {B}, D {D}, V {V}", "repeat": "equal bits"}


def check_vocab_ring() -> dict:
    """The vocabulary walk's ring as the kernels size it (stages, dynamic
    shared memory with and without the store's staging) against its Python
    mirror, ``ops/decode_step.py::vocab_ring``, for both block heights and
    every operand size."""
    from gpt2_image_captioning_tpu_torch.ops import _build
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    lib = _build.library()
    rings = {}
    for rows in (64, 128):
        for el in (1, 2, 4):
            for store in (False, True):
                c = (lib.gic_vocab_stages(rows, el), lib.gic_vocab_smem(rows, el, int(store)))
                check(c == DS.vocab_ring(rows, el, store),
                      f"vocab ring at {rows} rows, {el}-byte operands, store {store}: "
                      f"{c} != {DS.vocab_ring(rows, el, store)}")
                rings[f"{rows}x{el}{'_store' if store else ''}"] = list(c)
    return {"phase": "vocab_ring", "rings": rings}


# The float32 walk kernels' instantiations: (C entry, its variants' names).
# The top-k's and the sampler's trade registers from their service
# warpgroups to their consumers (csrc/vocab_walk.cuh), so their numRegs is
# the count on entry, 128, and the consumers run on 200.
WALK_F32_KERNELS = {
    "argmax_walk_kernel<float>": ("gic_logits_argmax_f32_attrs", ("",)),
    "store_walk_kernel<float>": ("gic_logits_f32_attrs", ("",)),
    "topk_walk_kernel<float, KS>": ("gic_logits_topk_f32_attrs", ("KS 4", "KS 8", "KS 16")),
    "sample_walk_kernel<float, Mode>": ("gic_logits_sample_f32_attrs",
                                        ("kInit", "kVerify", "kDraw")),
}


def walk_registers() -> dict:
    """Each float32 walk kernel's registers and local (spill) bytes a thread,
    as ``cudaFuncGetAttributes`` gives them: reported, not a gate.  A tree
    whose library lacks an entry (an earlier commit's, run with this
    script) reports it missing."""
    import ctypes

    from gpt2_image_captioning_tpu_torch.ops import _build

    lib, out = _build.library(), {}
    for kernel, (entry, variants) in WALK_F32_KERNELS.items():
        fn = getattr(lib, entry, None)
        if fn is None:
            out[kernel] = "not in this tree"
            continue
        for i, variant in enumerate(variants):
            res = (ctypes.c_int * 2)()
            _build.check(fn(i, ctypes.addressof(res)), entry)
            out[f"{kernel} {variant}".strip()] = {"num_regs": res[0], "local_bytes": res[1]}
    return {"phase": "walk_registers", "kernels": out}


def check_logits_topk(dtype, g) -> dict:
    """``csrc/logits_topk.cu`` at the beam path's 512 rows, k 4.  Values and
    the logsumexp to the logits' tolerance; ids equal wherever the twin's
    top-(k+1) values are apart by more than that tolerance, and every chosen
    id's twin logit within it of the twin's value at its rank; forced ties
    (row 0's top logit copied to lower ids) come out lowest id first."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops.sampling import topk_small

    k = BEAM_K
    x32, lnf, wte = vocab_inputs(B_BEAM, dtype, g)
    want_v, want_i, want_l = DS.logits_topk_plain(x32, lnf, wte, k)
    got_v, got_i, got_l = DS.logits_topk_cuda(x32, lnf, wte, k)
    torch.cuda.synchronize()
    tol = TOL[dtype]["out"]
    err = max(close(got_v, want_v, tol), close(got_l, want_l, tol))
    logits = DS.logits_plain(x32, lnf, wte)
    top, _ = topk_small(logits, k + 1)
    clear = ((top[:, :-1] - top[:, 1:]) > TOL[dtype]["gap"]).all(dim=1)
    check(bool((got_i == want_i)[clear].all()), "top-k ids differ on a row with clear gaps")
    chosen = logits.gather(1, got_i.long())
    check(bool(((want_v - chosen) <= TOL[dtype]["gap"]).all()),
          "a chosen id's logit is below the twin's value at its rank")
    check(all(len(set(r)) == k for r in got_i.tolist()), "repeated ids in a row's top-k")
    win = int(want_i[0, 0])
    check(win > 1, "row 0's winner is id 0 or 1; change the seed")
    w2 = wte.clone()
    w2[0] = wte[win]
    w2[win - 1] = wte[win]
    _, tie_i, _ = DS.logits_topk_cuda(x32, lnf, w2, k)
    _, tie_plain, _ = DS.logits_topk_plain(x32, lnf, w2, k)
    check(tie_i[0, :3].tolist() == [0, win - 1, win], f"forced ties gave {tie_i[0].tolist()}")
    ms = time_ms(lambda: DS.logits_topk_cuda(x32, lnf, wte, k))
    plain_ms = time_ms(lambda: DS.logits_topk_plain(x32, lnf, wte, k))

    def library():
        lg = library_logits(x32, lnf, wte)
        return torch.topk(lg, k), torch.logsumexp(lg, dim=-1)

    library_ms = time_ms(library)
    nbytes = vocab_bytes(B_BEAM, wte, 8 * B_BEAM * k + 4 * B_BEAM)
    bound_ms, bound_by = bound(nbytes, 2 * B_BEAM * D * V, split_type(dtype))
    name = f"logits_topk_{str(dtype).replace('torch.', '')}"
    x128 = x32[:B].contiguous()
    devices = {"device_ms": vocab_device(lambda: DS.logits_topk_cuda(x32, lnf, wte, k), name),
               "library_device_ms": vocab_device(library, f"{name}_library"),
               "device_ms_b128": vocab_device(lambda: DS.logits_topk_cuda(x128, lnf, wte, k),
                                              f"{name}_b128"),
               "ms_b128": time_ms(lambda: DS.logits_topk_cuda(x128, lnf, wte, k))}
    return {"kernel": "logits_topk", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, **devices,
            "library_ms": library_ms, "library": "layer_norm + mm + topk + logsumexp",
            "at": f"B {B_BEAM}, D {D}, V {V}, k {k}", "rows_with_clear_gaps": int(clear.sum()),
            "forced_ties": {"kernel": tie_i[0].tolist(), "plain": tie_plain[0].tolist()}}


def tie_row(tokens: torch.Tensor, b: int, v: int) -> int:
    """A row whose winner lets all four forced ties of :func:`argmax_ties`
    land apart: not in the walk's first range at B rows nor in its range's
    first 128-column tile, above id 1."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    plan = DS.vocab_plan(b, v)
    for row, win in enumerate(tokens.tolist()):
        tile = win // DS.VOCAB_BN
        r = max(r for r in range(plan.ranges) if DS.VocabPlan.span(plan.tiles, plan.ranges, r)[0]
                <= tile)
        if r >= 1 and tile > DS.VocabPlan.span(plan.tiles, plan.ranges, r)[0] and win > 1:
            return row
    raise AssertionError("no row's winner admits the four forced ties; change the seed")


def argmax_ties(run, plain, tokens: torch.Tensor, b: int, v: int, copy) -> dict:
    """Forced ties of the argmax: a chosen row's winning id in the kernel's
    ``tokens`` copied (``copy(low, win)`` gives the weights with id ``low``'s
    row set to ``win``'s) to id 0,
    to the id just below the winner, to the last id of the walk's range before
    the winner's (another block, at a boundary of the plan at B rows), and to
    the same column one 128-column tile below (the winner's block, another
    tile).  The kernel must give each tie to the lower id."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    row = tie_row(tokens, b, v)
    win = int(tokens[row])
    plan = DS.vocab_plan(b, v)
    tile = win // DS.VOCAB_BN
    r = max(r for r in range(plan.ranges)
            if DS.VocabPlan.span(plan.tiles, plan.ranges, r)[0] <= tile)
    lows = {"id_0": 0, "just_below": win - 1,
            "other_block": DS.VocabPlan.span(plan.tiles, plan.ranges, r)[0] * DS.VOCAB_BN - 1,
            "other_tile": win - DS.VOCAB_BN}
    ties = {"row": row, "winner": win}
    for what, low in lows.items():
        weights = copy(low, win)
        tok, again = run(*weights), run(*weights)
        check(torch.equal(tok, again), f"argmax tie {what}: two calls differ")
        check(int(tok[row]) == low,
              f"argmax tie {what}: ids {low} and {win} tied, the kernel picked {int(tok[row])}")
        ties[what] = {"low": low, "kernel": int(tok[row]), "plain": int(plain(*weights)[row])}
    return ties


def check_logits_argmax(dtype, g) -> dict:
    """``csrc/logits_argmax.cu`` at the greedy path's B 128: the token equal to
    the twin's on every row whose top two logits lie more than the gap
    tolerance apart, and within it of the row's max on every row; two calls
    give equal bits; the forced ties of :func:`argmax_ties`; the device time
    at B 128 and 512 beside the library's (layer_norm + mm + argmax) and the
    bare product's."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x512, lnf, wte = vocab_inputs(B_BEAM, dtype, g)
    x32 = x512[:B].contiguous()
    logits = DS.logits_plain(x32, lnf, wte)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    got = DS.logits_argmax_cuda(x32, lnf, wte)
    torch.cuda.synchronize()
    check(torch.equal(got, DS.logits_argmax_cuda(x32, lnf, wte)), "argmax: two calls differ")
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL[dtype]["gap"]
    check(bool((got == want)[clear].all()), "argmax differs on a row with a clear top-2 gap")
    deficit = top2[:, 0] - logits.gather(1, got.long()[:, None])[:, 0]
    err = float(deficit.max())
    check(err <= TOL[dtype]["gap"], f"a chosen token's logit is {err} below the row max")

    def copy(low, win):
        w2 = wte.clone()
        w2[low] = wte[win]
        return (w2,)

    ties = argmax_ties(lambda w2: DS.logits_argmax_cuda(x32, lnf, w2),
                       lambda w2: DS.logits_argmax_plain(x32, lnf, w2), got, B, V, copy)
    ms = time_ms(lambda: DS.logits_argmax_cuda(x32, lnf, wte))
    plain_ms = time_ms(lambda: DS.logits_argmax_plain(x32, lnf, wte))
    # no single library call: layer_norm + mm + argmax, and cuBLAS's bare
    # (B, D) x (D, V) product alone, for scale
    xf, wt = x32.to(dtype), wte.t()
    cublas_ms = time_ms(lambda: torch.mm(xf, wt))
    nbytes = vocab_bytes(B, wte, 4 * B)  # the tokens written
    bound_ms, bound_by = bound(nbytes, 2 * B * D * V, split_type(dtype))
    name = f"logits_argmax_{str(dtype).replace('torch.', '')}"

    def library(x):
        return library_logits(x, lnf, wte).argmax(-1)

    devices = {"device_ms": vocab_device(lambda: DS.logits_argmax_cuda(x32, lnf, wte), name),
               "library_device_ms": vocab_device(lambda: library(x32), f"{name}_library"),
               "mm_device_ms": vocab_device(lambda: torch.mm(xf, wt), f"{name}_mm"),
               "device_ms_b512": vocab_device(lambda: DS.logits_argmax_cuda(x512, lnf, wte),
                                              f"{name}_b512"),
               "library_device_ms_b512": vocab_device(lambda: library(x512),
                                                      f"{name}_library_b512")}
    return {"kernel": "logits_argmax", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
            "library": "none (device times: layer_norm + mm + argmax)", "cublas_mm_ms": cublas_ms,
            **devices, "at": f"B {B}, D {D}, V {V}", "rows_with_clear_gap": int(clear.sum()),
            "ties": ties, "repeat": "equal bits"}


# ---------------------------------------------------------------------------
# The int8 modes (W8A8 weights, int8 KV cache) against their twins
# ---------------------------------------------------------------------------

def check_rowquant(dtype, g) -> dict:
    """``csrc/rowquant.cu`` at B 128 in its step roles: LN -> D (qkv, fc,
    LN_f), D (the attention output), 4D (gelu(h)).  Without the LN the kernel
    and the twin quantize the same values the same way: identical int8 and
    scales.  With it, their LN statistics differ in summation order, which
    can flip the rounding of an LN output to the compute dtype (one bf16 ulp,
    2^-8, or ~1e-7 in float32) and so move a quantized value by one step or
    a row's scale by that ulp: INT8_STEP and ROWQUANT_SCALE_RTOL."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    roles, worst, ms_ln = {}, 0.0, None
    for name, k, ln in (("ln_d", D, True), ("d", D, False), ("4d", 4 * D, False)):
        if ln:
            x = 3.0 * torch.randn(B, k, generator=g, device="cuda")
            lnp = (1 + 0.1 * torch.randn(k, generator=g, device="cuda"),
                   0.1 * torch.randn(k, generator=g, device="cuda"))
        else:
            x, lnp = torch.randn(B, k, generator=g, device="cuda").to(dtype), None
        got_q, got_s = Q.rowquant_cuda(x, lnp, compute_dtype=dtype)
        want_q, want_s = Q.rowquant_plain(x, lnp, compute_dtype=dtype)
        torch.cuda.synchronize()
        step = int((got_q.int() - want_q.int()).abs().max())
        rel = float(((got_s - want_s).abs() / want_s).max())
        if ln:
            check(step <= INT8_STEP and rel <= ROWQUANT_SCALE_RTOL[dtype],
                  f"rowquant {name}: int8 values {step} apart, scales {rel} apart")
        else:
            check(step == 0 and rel == 0.0, f"rowquant {name}: int8 values {step} apart, scales "
                                            f"{rel} apart (identical inputs)")
        worst = max(worst, rel)
        ms = time_ms(lambda: Q.rowquant_cuda(x, lnp, compute_dtype=dtype))
        plain_ms = time_ms(lambda: Q.rowquant_plain(x, lnp, compute_dtype=dtype))
        nbytes = B * k * (x.element_size() + 1) + 4 * B + (8 * k if ln else 0)
        bound_ms, bound_by = bound(nbytes, 0, dtype)
        roles[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": nbytes, "max_int8_step": step, "scale_rel_err": rel,
                       "int8_identical": float((got_q == want_q).float().mean()),
                       "device_ms": device_ms(lambda: Q.rowquant_cuda(x, lnp, compute_dtype=dtype),
                                              "rowquant_kernel",
                                              f"kernel_rowquant_{name}_{dtype_tag(dtype)}.json")}
    main = roles["ln_d"]
    return {"kernel": "rowquant", "max_abs_err": worst, "error_is": "max relative scale error",
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")},
            "library_ms": None, "library": "none: no one PyTorch call quantizes rows",
            "at": f"B {B}: LN + quantize of D {D} rows (the row's figures); roles below",
            "roles": roles}


def dtype_tag(dtype) -> str:
    return str(dtype).replace("torch.", "")


# rows that test the product's own quantization: a row of zeros (scale
# 1e-12), and rows whose largest |v| sits in the first K element, the middle
# one and the last one, so in the first, a middle and the last K-slice
FOLD_EDGE_ROWS = 4


def fold_inputs(b: int, k: int, n: int, epi: str, dtype, g):
    """:func:`linear_inputs` of an int8 role without a LayerNorm, with the
    :data:`FOLD_EDGE_ROWS` rows set."""
    x, w, bias, res, kw = linear_inputs(b, k, n, False, epi, dtype, True, g)
    x[0] = 0
    for row, col in ((1, 0), (2, k // 2), (3, k - 1)):
        x[row, col] = 40.0 * (-1) ** row  # N(0, 1) rows stay below 6
    return x, w, bias, res, kw


def check_fold(dtype, g) -> dict:
    """The int8 products whose rows carry no LayerNorm — the attention
    output -> proj and gelu(h) -> cproj — quantize their rows inside the
    product (``fused_linear`` with int8 weights and ``ln=None``): each row's
    scale from the max |v| over the whole of K (the cluster's K-slices
    exchange their maxima), then ``rint(v / s)``.  Held to
    ``rowquant_plain`` + ``int8_matmul`` + the bias + the residual, equal
    bits (the integer sums are exact and the float steps are the twin's, in
    its order), at B 128 and 512, with :data:`FOLD_EDGE_ROWS`; two calls
    give equal bits.  Device ms of the call (a tree whose wrapper runs the
    row quantizer first shows both launches) and of its product kernel."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    roles = {}
    for name, k, n, ln, epi in LINEAR_ROLES:
        if ln:
            continue
        for b in (B, B_BEAM):
            x, w, bias, res, kw = fold_inputs(b, k, n, epi, dtype, g)
            xq, sx = Q.rowquant_plain(x)
            want = res + (Q.int8_matmul(xq, sx, w, kw["w_scale"]) + bias)
            outs = [DS.fused_linear_cuda(x, w, bias, residual=res.clone(), **kw) for _ in range(2)]
            torch.cuda.synchronize()
            diff = float((outs[0] - want).abs().max())
            check(torch.equal(outs[0], want), f"folded quantization {name} b {b} "
                  f"{dtype_tag(dtype)}: {diff} from rowquant_plain + int8_matmul (equal bits "
                  f"expected)")
            check(torch.equal(outs[0], outs[1]), f"folded quantization {name} b {b}: a repeat "
                                                 f"gave other bits")
            r = res.clone()

            def call():
                return DS.fused_linear_cuda(x, w, bias, residual=r, **kw)

            dev = device_split(call, ("linear_wgmma_kernel",),
                               f"kernel_fold_{name}_b{b}_{dtype_tag(dtype)}.json")
            nbytes = b * k * x.element_size() + n * k + 8 * n + 8 * b * n
            bound_ms, bound_by = bound(nbytes, 2 * b * k * n, torch.int8)
            roles[f"{name}_b{b}"] = {
                "max_abs_err": diff, "ms": time_ms(call), "bound_ms": bound_ms,
                "bound_by": bound_by, "device_ms": dev if isinstance(dev, str) else dev["total"],
                "product_device_ms": dev if isinstance(dev, str) else dev["linear_wgmma_kernel"],
                "plan": linear_plan_of(b, k, n, True, x.element_size())}
    return {"kernel": "fused_linear", "mode": "int8_folded_quantization", "roles": roles,
            "max_abs_err": max(r["max_abs_err"] for r in roles.values()),
            "compared_to": "rowquant_plain + int8_matmul + bias + residual, equal bits",
            "repeat": "equal bits", "edge_rows": "zeros; max |v| in the first, a middle and the "
                                                 "last K element"}


def flip_allowance(x, lnp, dtype, wq, sw, want) -> tuple[torch.Tensor, int]:
    """How far an int8 product's output may lie from the twin's, per row,
    when the rows carry a LayerNorm: the two sides' LN statistics differ in
    summation order, so an LN output can round to the compute dtype
    differently and quantize one step apart (check_rowquant), which moves
    each output of its row by up to sx * max |w|; a row's scale one rounding
    apart moves its outputs by that ratio.  Read from the quantizer kernel
    and its twin on the same rows: ((M, N) allowance, flipped elements)."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    q_k, s_k = Q.rowquant_cuda(x, lnp, compute_dtype=dtype)
    q_p, s_p = Q.rowquant_plain(x, lnp, compute_dtype=dtype)
    flips = (q_k != q_p).sum(dim=1, keepdim=True)
    w_max = float((wq.abs().float() * sw[:, None]).max())
    allowance = flips * s_p * w_max + (s_k / s_p - 1).abs() * want.float().abs()
    return allowance, int(flips.sum())


def close_int8(got, want, tol, allowance) -> float:
    """:func:`close` with a per-element ``allowance`` added to the bound."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    worst = float(diff.max())
    check(bool((diff <= atol + rtol * want.float().abs() + allowance).all()),
          f"max |diff| {worst} exceeds atol {atol} + rtol {rtol} + the flip allowance")
    return worst


def int8_weights(n: int, k: int, g) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K) int8 weights and their (N,) scales, from N(0, 0.02) float32
    weights quantized per output column as the pack does."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    wq, sw = Q.colquant((0.02 * torch.randn(n, k, generator=g, device="cuda")).t())
    return wq.t().contiguous(), sw.contiguous()


def library_int8(xq, sx, wq_t, sw):
    """``torch._int_mm`` of int8 rows by int8 weights (given transposed, (K,
    N) column-major), dequantized as the kernels do: the library's int8
    product (timed only here)."""
    return torch._int_mm(xq, wq_t).float() * sx * sw


def linear_roles(d: int) -> tuple:
    """The four projections of a GPT-2 layer of width d: (name, K, N,
    LayerNorm prologue, epilogue)."""
    return (("qkv", d, 3 * d, True, "cast"), ("attn_proj", d, d, False, "residual"),
            ("mlp_fc", d, 4 * d, True, "gelu"), ("mlp_proj", 4 * d, d, False, "residual"))


LINEAR_ROLES = linear_roles(D)
# fused_linear's bf16 and int8 route (csrc/fused_linear.cu) beyond the
# paths' shapes, held to its twin under TOL (int8: close_int8), correctness
# only: every role at D 768 and the wide sizes' 1024, 1280 and 1600 (GPT-2
# XL's K 1600 and 6400 are no multiples of 64 boxes' worth of slices; large's
# N 3,840 and 5,120), M on each side of the kernel's 64-row warpgroups and
# 128-row tiles.
LINEAR_CONTRACT_M = (1, 3, 64, 127, 128, 129, 512)
LINEAR_CONTRACT_D = (768, 1024, 1280, 1600)
# The float32 route's header bound (csrc/fused_linear.cu, as the vocabulary
# walk's): before the epilogue an output lies within TF32_SPLIT_BOUND x
# sum_k |x_k w_k| of the exact sum (the split) plus TF32_STEP_BOUND of the
# running sum, itself <= that mass, for each product instruction (3 a k8
# step) and each K-slice the cluster adds; the epilogue multiplies that by
# at most gelu_new's largest slope (1.13) and adds its own roundings (the
# bias, gelu_new, the residual add: 2^-22 of the values, generously).  Held
# against float64 on the card; tests/test_torch_tf32_split.py emulates it.
TF32_SPLIT_BOUND, TF32_STEP_BOUND, TF32_ROUNDING = 2.0 ** -20, 2.0 ** -23, 2.0 ** -22
GELU_MAX_SLOPE = 1.13
TF32_LINEAR = "linear_wgmma_kernel<float, float"  # the TF32 instantiations, by trace name


def linear_inputs(b: int, k: int, n: int, ln: bool, epi: str, dtype, quant: bool, g):
    """One role's inputs as the step gives them: (x, w, bias, residual or
    None, keyword arguments of the wrapper), int8 weights and their scales
    with ``quant``."""
    if quant:
        w, sw = int8_weights(n, k, g)
        kw = dict(w_scale=sw, compute_dtype=dtype)
    else:
        w, kw = (0.02 * torch.randn(n, k, generator=g, device="cuda")).to(dtype), {}
    bias = 0.02 * torch.randn(n, generator=g, device="cuda")
    lnp = None
    if ln:
        x = 3.0 * torch.randn(b, k, generator=g, device="cuda")
        lnp = (1 + 0.1 * torch.randn(k, generator=g, device="cuda"),
               0.1 * torch.randn(k, generator=g, device="cuda"))
    else:
        x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
    res = torch.randn(b, n, generator=g, device="cuda") if epi == "residual" else None
    return x, w, bias, res, dict(epilogue=epi, ln=lnp, **kw)


def tf32_bound_ratio(x, w, bias, res, kw, got) -> float:
    """The float32 route's output against float64 on the card, as a share of
    its header bound (TF32_SPLIT_BOUND and above): fails above 1."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import nn

    m, k = x.shape
    ln, epi = kw["ln"], kw["epilogue"]
    rows = x if ln is None else nn.layer_norm_rows(ln[0], ln[1], x, 1e-5)  # the pre-pass's rows
    r64, w64 = rows.double(), w.double()
    mass = r64.abs() @ w64.abs().t()
    steps = 3 * -(-k // 8) + DS.linear_plan(m, k, w.shape[0], 4).splits
    y = r64 @ w64.t() + bias.double()
    bound = (TF32_SPLIT_BOUND + TF32_STEP_BOUND * steps) * mass
    if epi == "gelu":
        c = 0.7978845608028654
        want = 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))
        bound = GELU_MAX_SLOPE * bound
    else:
        want = y if epi == "cast" else res.double() + y
    bound = bound + TF32_ROUNDING * (y.abs() + want.abs())
    ratio = float(((got.double() - want).abs() / bound).max())
    check(ratio <= 1.0, f"fused_linear float32 ({epi}, ({m}, {k}) x {w.shape[0]}): "
                        f"{ratio} of its header bound from float64")
    return ratio


def linear_error(x, w, bias, res, kw, dtype) -> tuple[float, int]:
    """The kernel against its twin on one role's inputs: (max |diff|, int8
    quantizations one step apart).  bf16 and float32 under TOL, float32 also
    within its header bound of float64 (:func:`tf32_bound_ratio`); int8
    under TOL plus, with a LayerNorm, :func:`flip_allowance`."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    r_plain, r_kernel = (None, None) if res is None else (res.clone(), res.clone())
    want = DS.fused_linear_plain(x, w, bias, residual=r_plain, **kw)
    got = DS.fused_linear_cuda(x, w, bias, residual=r_kernel, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"fused_linear gave {got.shape} "
          f"{got.dtype}, the twin {want.shape} {want.dtype}")
    tol = TOL[dtype]["f32" if kw["epilogue"] == "residual" else "out"]
    if "w_scale" not in kw:
        if dtype == torch.float32:
            LINEAR_BOUND_RATIOS.append(tf32_bound_ratio(x, w, bias, res, kw, got))
        return close(got, want, tol), 0
    allowance, flips = (flip_allowance(x, kw["ln"], dtype, w, kw["w_scale"], want)
                        if kw["ln"] is not None else (0.0, 0))
    return close_int8(got, want, tol, allowance), flips


# the float32 calls' shares of their header bound, as linear_error meets them
LINEAR_BOUND_RATIOS: list[float] = []


def linear_contract(dtype, quant: bool, g) -> dict:
    """fused_linear against its twin at LINEAR_CONTRACT_D x
    LINEAR_CONTRACT_M in every role (float32 also within its header
    bound)."""
    worst, cases = 0.0, 0
    LINEAR_BOUND_RATIOS.clear()
    for d in LINEAR_CONTRACT_D:
        for _, k, n, ln, epi in linear_roles(d):
            for m in LINEAR_CONTRACT_M:
                err, _ = linear_error(*linear_inputs(m, k, n, ln, epi, dtype, quant, g), dtype)
                worst = max(worst, err)
                cases += 1
    rec = {"cases": cases, "max_abs_err": worst, "D": list(LINEAR_CONTRACT_D),
           "M": list(LINEAR_CONTRACT_M)}
    if LINEAR_BOUND_RATIOS:
        rec["max_share_of_header_bound"] = max(LINEAR_BOUND_RATIOS)
    return rec


def linear_repeat(x, w, bias, res, kw) -> None:
    """The same call twice on the same inputs gives the same bits: the K
    split's partial tiles are added in a fixed order."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    outs = [DS.fused_linear_cuda(x, w, bias, residual=None if res is None else res.clone(), **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(outs[0], outs[1]), f"fused_linear gave other bits on a repeat: "
          f"{kw['epilogue']}, ({x.shape[0]}, {w.shape[1]}) x {w.shape[0]}")


def linear_plan_of(m: int, k: int, n: int, el: int, row_bytes: int | None = None
                   ) -> dict | None:
    """The kernel's split of a role with ``el``-byte operands (None on a
    tree without one; a tree whose plan takes no ``row_bytes`` plans the
    quantized rows)."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    plan = getattr(DS, "linear_plan", None)
    if plan is None:
        return None
    try:
        return plan(m, k, n, el, row_bytes)._asdict()
    except TypeError:
        return plan(m, k, n, el)._asdict()


def linear_role(name, b, k, n, ln, epi, dtype, quant: bool, device: bool, g) -> dict:
    """One role at batch b: the kernel against its twin, its repeat, the
    events ms of the kernel, the twin and the library call, their device ms
    (``device``; int8 split into the row quantizer's launch and the
    product's), the bound.  The library: cuBLAS's bare product plus bias on
    rows already in the compute dtype (bf16, float32), or ``torch._int_mm`` +
    dequantize + bias on rows already quantized (int8): no one library call
    fuses the prologue and the epilogue."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    x, w, bias, res, kw = linear_inputs(b, k, n, ln, epi, dtype, quant, g)
    err, flips = linear_error(x, w, bias, res, kw, dtype)
    linear_repeat(x, w, bias, res, kw)
    r_kernel, r_plain = (None, None) if res is None else (res.clone(), res.clone())

    def kernel():
        return DS.fused_linear_cuda(x, w, bias, residual=r_kernel, **kw)

    if quant:
        xq, sx = Q.rowquant_plain(x, kw["ln"], compute_dtype=dtype)
        wq_t, sw = w.t(), kw["w_scale"]

        def library():
            return library_int8(xq, sx, wq_t, sw) + bias
    else:
        xc, wt, bc = x.to(dtype), w.t(), bias.to(dtype)

        def library():
            return torch.addmm(bc, xc, wt)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: DS.fused_linear_plain(x, w, bias, residual=r_plain, **kw))
    library_ms = time_ms(library)
    el = torch.tensor([], dtype=dtype).element_size()
    # x, W, its scales (int8), bias (and LN params) read; the output written,
    # or the float32 residual stream read and written
    nbytes = (b * k * x.element_size() + n * k * w.element_size() + (8 if quant else 4) * n
              + (8 * k if ln else 0) + (8 * b * n if epi == "residual" else el * b * n))
    bound_ms, bound_by = bound(nbytes, 2 * b * k * n, torch.int8 if quant else split_type(dtype))
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": 2 * b * k * n,
           "plan": linear_plan_of(b, k, n, w.element_size(),
                                  None if ln or not quant else x.element_size())}
    if quant:
        rec["int8_flips"] = flips
    if device:
        tag = f"{name}_b{b}_{'int8' if quant else str(dtype).replace('torch.', '')}"
        # the row quantizer's own launch: the LN roles' (the others quantize
        # inside the product)
        pre = quant and ln
        # float32: the product must be the TF32 instantiation, by its trace name
        # (on a tree that has it: this script can time an earlier tree's kernels)
        f32 = dtype == torch.float32 and not quant and tf32_route()
        dev = device_split(kernel, ("rowquant_kernel",) * pre + (TF32_LINEAR,) * f32,
                           f"kernel_linear_{tag}.json")
        check(not f32 or not isinstance(dev, str),
              f"fused_linear float32 {name} b {b}: no {TF32_LINEAR}> launch in its trace")
        rec["device_ms"] = dev if isinstance(dev, str) else dev["total"]
        if quant and not isinstance(dev, str):
            rec["rowquant_device_ms"] = dev["rowquant_kernel"] if pre else 0.0
            rec["product_device_ms"] = dev["total"] - rec["rowquant_device_ms"]
        rec["library_device_ms"] = device_ms(library, None, f"library_linear_{tag}.json")
        if quant:  # the bare integer product, without the dequantize and the bias
            rec["int_mm_device_ms"] = device_ms(lambda: torch._int_mm(xq, wq_t), None,
                                                f"library_int_mm_{tag}.json")
        rec["host_us"] = host_us(kernel)
    return rec


def linear_layer(dtype, quant: bool, b: int, device: bool, g) -> dict:
    """The four roles of a layer at batch b, each and summed."""
    roles = {name: linear_role(name, b, k, n, ln, epi, dtype, quant, device, g)
             for name, k, n, ln, epi in LINEAR_ROLES}
    keys = ["ms", "plain_ms", "library_ms", "bytes", "ops"]
    keys += ["device_ms", "library_device_ms", "host_us"]
    keys += ["rowquant_device_ms", "product_device_ms", "int_mm_device_ms"] * quant
    total = {}
    for key in keys if device else keys[:5]:
        vals = [r.get(key) for r in roles.values()]
        total[key] = sum(vals) if all(isinstance(v, (int, float)) for v in vals) else "not measured"
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"],
                                                 torch.int8 if quant else split_type(dtype))
    total["max_abs_err"] = max(r["max_abs_err"] for r in roles.values())
    return {**total, "roles": roles}


def check_linear(dtype, g) -> dict:
    """``csrc/fused_linear.cu`` with float weights in the four roles of a
    layer, on the TMA / wgmma / cluster route (float32 on wgmma TF32, the
    three-term split): its device time from a trace beside the events time,
    at B 128 and at the 512 rows of beam-4 and continuous serving; each role
    repeated for equal bits; the contract sweep; float32 also within its
    header bound of float64 in every call, and by kernel name the TF32
    instantiation in every trace."""
    LINEAR_BOUND_RATIOS.clear()
    main = linear_layer(dtype, False, B, True, g)
    rec = {"kernel": "fused_linear", **{k: v for k, v in main.items() if k != "roles"},
           "library": "addmm x 4 (bare product + bias on rows in the compute dtype)",
           "at": f"B {B}: the four projections of one layer, summed (6 CUDA launches)",
           "roles": main["roles"], "b512": linear_layer(dtype, False, B_BEAM, True, g)}
    shares = list(LINEAR_BOUND_RATIOS)
    rec["contract"] = linear_contract(dtype, False, g)
    rec["repeat"] = "every role at B 128 and 512: equal bits"
    if dtype == torch.float32:
        rec["max_share_of_header_bound"] = max(shares)
        rec["registers"] = linear_registers()
    return rec


def tf32_route() -> bool:
    """Whether this tree's library has the float32 projections on wgmma TF32."""
    from gpt2_image_captioning_tpu_torch.ops import _build

    return hasattr(_build.library(), "gic_linear_f32_attrs")


def linear_registers() -> dict:
    """The float32 product kernel's registers and local (spill) bytes a
    thread at each width, as ``cudaFuncGetAttributes`` gives them: reported,
    not a gate ("not in this tree" for a tree without the TF32 route)."""
    import ctypes

    from gpt2_image_captioning_tpu_torch.ops import _build

    if not tf32_route():
        return {"linear_wgmma_kernel<float, float, BN>": "not in this tree"}
    fn, out = _build.library().gic_linear_f32_attrs, {}
    for i, bn in enumerate((32, 64, 128)):
        res = (ctypes.c_int * 2)()
        _build.check(fn(i, ctypes.addressof(res)), "gic_linear_f32_attrs")
        out[f"linear_wgmma_kernel<float, float, {bn}>"] = {"num_regs": res[0],
                                                           "local_bytes": res[1]}
    return out


def check_linear_int8(dtype, g) -> dict:
    """``csrc/fused_linear.cu`` with int8 weights (one call: the row
    quantizer, then the int8 product on the TMA / wgmma / cluster route) in
    the four roles of a layer, at B 128 and 512, with device times (the
    quantizer's launch and the product's apart) where the compute dtype is
    bf16, the repeat and the contract sweep.  Without the LN both sides
    quantize identical rows and sum exact integer products, so they differ
    by the float epilogue's rounding only: the tolerances of the float
    kernel.  With the LN, plus the allowance of :func:`flip_allowance` for
    the rows' quantizations that came out one step apart."""
    device = dtype == torch.bfloat16
    main = linear_layer(dtype, True, B, device, g)
    rec = {"kernel": "fused_linear", "mode": "int8",
           **{k: v for k, v in main.items() if k != "roles"},
           "library": "torch._int_mm + dequantize + bias on pre-quantized rows, x 4",
           "at": f"B {B}: the four projections of one layer, summed (6 CUDA launches: the "
                 f"LN roles' row quantizer and product, the others' product alone)",
           "roles": main["roles"], "b512": linear_layer(dtype, True, B_BEAM, device, g),
           "contract": linear_contract(dtype, True, g),
           "repeat": "every role at B 128 and 512: equal bits"}
    return rec


def int8_vocab_inputs(b: int, dtype, g):
    """The int8 vocabulary kernels' inputs: the float32 residual stream, LN_f,
    an int8 wte (V, D) with its (V,) scales, and the keywords that select the
    int8 mode."""
    x32, lnf, _ = vocab_inputs(b, torch.float32, g)
    wq, sw = int8_weights(V, D, g)
    return x32, lnf, wq, {"wte_scale": sw, "compute_dtype": dtype}


def library_vocab_int8(x32, lnf, wq_pad_t, sw_pad, dtype):
    """The library's way to the int8 logits: LayerNorm, the rows quantized in
    torch ops, ``torch._int_mm`` over wte padded to V 50,264 (its N must be a
    multiple of 8), dequantized, the padding cut."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    xq, sx = Q.absmax_quant(F.layer_norm(x32, (D,), lnf[0], lnf[1], 1e-5).to(dtype))
    return library_int8(xq, sx, wq_pad_t, sw_pad)[:, :V]


def check_vocab_int8(dtype, g, kinds=("logits_argmax", "logits", "logits_topk",
                                       "logits_sample")) -> list[dict]:
    """The four vocabulary kernels with an int8 wte, each against its twin at
    its path's width: argmax and the stored logits at B 128, top-k at B 512
    (k 4), the sampler at B 512 (temperature 1.0, top_p 0.9).  The int8
    products are exact on both sides: the float kernels' tolerances, plus
    :func:`flip_allowance` for the rows whose LN_f output quantized one step
    apart; the argmax, top-k ids and draws must agree on every row that has
    no such flip, where the float kernels' rules hold."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import sampling as S

    out = []
    tol = TOL[dtype]
    twins = {"logits_argmax": DS.logits_argmax_plain, "logits": DS.logits_plain,
             "logits_topk": DS.logits_topk_plain, "logits_sample": S.sample_step_plain}
    widths = {"logits_argmax": B, "logits": B, "logits_topk": B_BEAM, "logits_sample": B_SERVE}
    for kind in kinds:
        b = widths[kind]
        x32, lnf, wq, kw = int8_vocab_inputs(b, dtype, g)
        sw = kw["wte_scale"]
        pad = (-V) % 8
        lib_logits = functools.partial(library_vocab_int8, x32, lnf, F.pad(wq, (0, 0, 0, pad)).t(),
                                       F.pad(sw, (0, pad)), dtype)
        temp = torch.full((b,), 1.0, device="cuda")
        top_p = torch.full((b,), TOP_P, device="cuda")
        extra = {"logits_topk": (BEAM_K,),
                 "logits_sample": (temp, top_p, 5, SAMPLE_K, SAMPLE_ROUNDS)}.get(kind, ())
        run = functools.partial(getattr(DS, f"{kind}_cuda"), x32, lnf, wq, *extra, **kw)
        plain = functools.partial(twins[kind], x32, lnf, wq, *extra, **kw)
        logits = DS.logits_plain(x32, lnf, wq, **kw)
        allowance, flips = flip_allowance(x32, (lnf[0], lnf[1]), dtype, wq, sw, logits)
        row_slack = allowance.max(dim=1).values  # (B,): what a row's flips may move a logit by
        got, want = run(), plain()
        rec = {"kernel": kind, "mode": "int8", "int8_flips": flips}
        if kind in ("logits_argmax", "logits"):
            check(torch.equal(got, run()), f"int8 {kind}: two calls differ")
        if kind == "logits_argmax":
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol["gap"] + 2 * row_slack
            check(bool((got == want)[clear].all()),
                  "int8 argmax differs on a row with a clear top-2 gap")
            deficit = top2[:, 0] - logits.gather(1, got.long()[:, None])[:, 0]
            err = float(deficit.max())
            check(bool((deficit <= tol["gap"] + 2 * row_slack).all()),
                  f"int8 argmax: a chosen token's logit is {err} below the max")

            def copy(low, win):
                w2, s2 = wq.clone(), sw.clone()
                w2[low], s2[low] = wq[win], sw[win]
                return w2, s2

            rec["ties"] = argmax_ties(
                lambda w2, s2: DS.logits_argmax_cuda(x32, lnf, w2, wte_scale=s2,
                                                     compute_dtype=dtype),
                lambda w2, s2: DS.logits_argmax_plain(x32, lnf, w2, wte_scale=s2,
                                                      compute_dtype=dtype), got, b, V, copy)
            library, out_bytes = (lambda: lib_logits().argmax(-1)), 4 * b
        elif kind == "logits":
            err = close_int8(got, want, tol["out"], allowance)
            library, out_bytes = lib_logits, 4 * b * V
        elif kind == "logits_topk":
            (gv, gi, gl), (wv, wi, wl) = got, want
            slack = row_slack[:, None]
            err = max(close_int8(gv, wv, tol["out"], slack), close_int8(gl, wl, tol["out"], slack))
            top, _ = S.topk_small(logits, BEAM_K + 1)
            clear = ((top[:, :-1] - top[:, 1:]) > tol["gap"] + 2 * slack).all(dim=1)
            check(bool((gi == wi)[clear].all()), "int8 top-k ids differ on a row with clear gaps")

            def library():
                lg = lib_logits()
                return torch.topk(lg, BEAM_K), torch.logsumexp(lg, dim=-1)

            out_bytes = 8 * b * BEAM_K + 4 * b
        else:
            (tok, _, lse), (wtok, wrnd, wlse) = got, want
            err = close_int8(lse, wlse, tol["out"], row_slack[:, None])
            same = float((tok == wtok).float().mean())
            check(same >= SAMPLE_BF16_AGREE, f"int8 sampler: {same} of the tokens identical")
            if dtype == torch.float32:
                check(bool((tok == wtok)[row_slack == 0].all()),
                      "int8 sampler: a float32 row without a flipped quantization drew another "
                      "token")
            excess = nucleus_excess(logits, tok, top_p)
            check(excess <= NUCLEUS_SLACK, f"int8 sampler: a drawn token lies {excess} outside")
            rec.update(tokens_identical=same, worst_nucleus_excess=excess)
            library, out_bytes = None, 12 * b
        torch.cuda.synchronize()
        ms = time_ms(run)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        nbytes = V * D + 4 * V + 4 * b * D + 8 * D + out_bytes  # wte int8 and its scales
        bound_ms, bound_by = bound(nbytes, 2 * b * D * V, torch.int8)
        if kind == "logits_sample":
            bound_ms, bound_by, rec["work"] = sampler_bound(b, wq, temp, wrnd)
        if kind in ("logits_topk", "logits_sample"):  # the redesigned walks, at b and B 128
            name = f"{kind}_int8_{str(dtype).replace('torch.', '')}"
            cut = (x32[:B].contiguous(), lnf, wq) + tuple(
                e[:B].contiguous() if torch.is_tensor(e) else e for e in extra)
            run128 = functools.partial(getattr(DS, f"{kind}_cuda"), *cut, **kw)
            rec.update(device_ms=vocab_device(run, name),
                       device_ms_b128=vocab_device(run128, f"{name}_b128"),
                       ms_b128=time_ms(run128))
            if library:
                rec["library_device_ms"] = vocab_device(library, f"{name}_library")
        else:  # the argmax and the store, redesigned on the walk: at B 128 and 512
            name = f"{kind}_int8_{str(dtype).replace('torch.', '')}"
            x512 = 3.0 * torch.randn(B_BEAM, D, generator=g, device="cuda")
            run512 = functools.partial(getattr(DS, f"{kind}_cuda"), x512, lnf, wq, **kw)
            rec.update(device_ms=vocab_device(run, name),
                       library_device_ms=vocab_device(library, f"{name}_library"),
                       device_ms_b512=vocab_device(run512, f"{name}_b512"))
        rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes,
                   library_ms=time_ms(library) if library else None,
                   library=("layer_norm + row quantization + torch._int_mm (V padded to "
                            f"{V + pad}) + dequantize" if library else "none"),
                   at=f"B {b}, D {D}, V {V}, int8 wte, {str(dtype).replace('torch.', '')} rows")
        out.append(rec)
    return out


# The four vocabulary kernels' contract beyond the paths' shapes (bf16, int8
# and float32): rows on each boundary of the walk's row tiles (64 rows a
# warpgroup, 128 a block), V at GPT-2's 50,257, at eight 128-column tiles
# plus one (the last tile one column wide) and below one tile; the argmax
# and the stored logits at each, k 1, 4 and 16 for the top-k and 1-4 for
# the sampler (mixed temperatures and top_p, and every third row count
# forced through every round to the fallback); each call made twice, for
# equal bits.  The paths' tolerances and rules hold: TOL, the clear-gap id
# rule, the nucleus, float32 tokens exact, SAMPLE_BF16_AGREE over all the
# cases' rows, flip_allowance for int8.
VOCAB_CONTRACT_B = (1, 3, 63, 64, 65, 127, 129, 255, 512)
VOCAB_CONTRACT_V = (V, 8 * 128 + 1, 100)
TOPK_CONTRACT_K = (1, 4, 16)


def vocab_contract(dtype, g, quant: bool = False) -> dict:
    """The four vocabulary wrappers against their twins at every case of the
    contract above: ``logits_argmax_cuda`` (ids on the rows with a clear
    top-2 gap, every row's token within the gap rule of its max),
    ``logits_cuda`` (every logit within TOL, shape (B, V)),
    ``logits_topk_cuda`` and ``logits_sample_cuda``."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import sampling as S

    tol = TOL[dtype]
    most = max(VOCAB_CONTRACT_B)
    if quant:
        x_all, lnf, w_all, kw = int8_vocab_inputs(most, dtype, g)
    else:
        (x_all, lnf, w_all), kw = vocab_inputs(most, dtype, g), {}
    same = total = cases = topk_cases = store_cases = 0
    worst = 0.0
    for v in VOCAB_CONTRACT_V:
        wte = w_all[:v]
        kwv = {**kw, "wte_scale": kw["wte_scale"][:v]} if quant else {}
        for i, b in enumerate(VOCAB_CONTRACT_B):
            x32 = x_all[:b]
            at = f"B {b} V {v}"
            logits = DS.logits_plain(x32, lnf, wte, **kwv)
            allowance = torch.zeros_like(logits)
            if quant:
                allowance, _ = flip_allowance(x32, (lnf[0], lnf[1]), dtype, wte,
                                              kwv["wte_scale"], logits)
            slack = allowance.max(dim=1).values
            tok = DS.logits_argmax_cuda(x32, lnf, wte, **kwv)
            check(torch.equal(tok, DS.logits_argmax_cuda(x32, lnf, wte, **kwv)),
                  f"argmax {at}: two calls differ")
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol["gap"] + 2 * slack
            check(bool((tok.long() == logits.argmax(-1))[clear].all()),
                  f"argmax {at}: ids differ on a row with a clear top-2 gap")
            deficit = top2[:, 0] - logits.gather(1, tok.long()[:, None])[:, 0]
            check(bool((deficit <= tol["gap"] + 2 * slack).all()),
                  f"argmax {at}: a chosen token's logit lies below the row max")
            stored = DS.logits_cuda(x32, lnf, wte, **kwv)
            check(torch.equal(stored, DS.logits_cuda(x32, lnf, wte, **kwv)),
                  f"logits {at}: two calls differ")
            check(stored.shape == (b, v), f"logits {at}: shape {tuple(stored.shape)}")
            worst = max(worst, close_int8(stored, logits, tol["out"], allowance))
            store_cases += 1
            for k in TOPK_CONTRACT_K:
                got = DS.logits_topk_cuda(x32, lnf, wte, k, **kwv)
                again = DS.logits_topk_cuda(x32, lnf, wte, k, **kwv)
                check(all(torch.equal(a, c) for a, c in zip(got, again)),
                      f"top-k {at} k {k}: two calls differ")
                wv, wi, wl = DS.logits_topk_plain(x32, lnf, wte, k, **kwv)
                worst = max(worst, close_int8(got[0], wv, tol["out"], slack[:, None]),
                            close_int8(got[2], wl, tol["out"], slack[:, None]))
                top, _ = S.topk_small(logits, k + 1)
                clear = ((top[:, :-1] - top[:, 1:]) > tol["gap"] + 2 * slack[:, None]).all(dim=1)
                check(bool((got[1] == wi)[clear].all()), f"top-k {at} k {k}: ids differ on a "
                      "row with clear gaps")
                check(all(len(set(r)) == k for r in got[1].tolist()),
                      f"top-k {at} k {k}: repeated ids in a row")
                topk_cases += 1
            ks, forced = 1 + cases % 4, i % 3 == 2
            rows = torch.arange(b, device="cuda")
            temp = torch.tensor(SAMPLE_TEMPS, device="cuda")[rows % len(SAMPLE_TEMPS)]
            top_p = (torch.full((b,), -1.0, device="cuda") if forced else
                     torch.tensor(SAMPLE_TOPPS, device="cuda")[(rows // 4) % len(SAMPLE_TOPPS)])
            rounds, seed = (3 if forced else SAMPLE_ROUNDS), 7000 + 13 * b + v
            args = (x32, lnf, wte, temp, top_p, seed, ks, rounds)
            tok, rnd, lse = DS.logits_sample_cuda(*args, **kwv)
            again = DS.logits_sample_cuda(*args, **kwv)
            check(all(torch.equal(a, c) for a, c in zip((tok, rnd, lse), again)),
                  f"sampler {at} k {ks}: two calls differ")
            wtok, wrnd, wlse = S.sample_step_plain(*args, **kwv)
            worst = max(worst, close_int8(lse, wlse, tol["out"], slack[:, None]))
            greedy = temp == 0
            check(bool((rnd[greedy] == 0).all()), f"sampler {at}: a temperature-0 row did not "
                  "resolve in round 0")
            deficit = logits.max(dim=1).values - logits.gather(1, tok.long()[:, None])[:, 0]
            check(bool((deficit[greedy] <= tol["gap"] + 2 * slack[greedy]).all()),
                  f"sampler {at}: a temperature-0 row's token is not the argmax")
            if forced:
                check(bool((rnd[~greedy] == rounds + 1).all()),
                      f"sampler {at}: top_p < 0 and a row did not fall back")
            else:  # accepted rows; a row out of rounds takes an unchecked candidate
                took = ~greedy & (rnd <= rounds)
                check(bool((rnd[~greedy] >= 1).all()), f"sampler {at}: a sampled row in round 0")
                if bool(took.any()):
                    lq = logits / torch.where(temp > 0, temp, 1.0)[:, None]
                    excess = nucleus_excess(lq[took], tok[took], top_p[took])
                    check(excess <= NUCLEUS_SLACK, f"sampler {at}: a token lies {excess} outside")
            if dtype == torch.float32 and not quant:
                check(torch.equal(tok, wtok) and torch.equal(rnd, wrnd),
                      f"float32 sampler {at}: tokens or rounds differ from the twin's")
            same += int((tok == wtok).sum())
            total += b
            cases += 1
    agree = same / total
    check(agree >= SAMPLE_BF16_AGREE, f"sampler contract: {agree} of the tokens identical")
    return {"phase": "vocab_contract", "dtype": str(dtype).replace("torch.", ""),
            "mode": "int8" if quant else "float", "topk_cases": topk_cases,
            "sampler_cases": cases, "argmax_cases": store_cases, "logits_cases": store_cases,
            "max_abs_err": worst, "sampler_tokens_identical": agree,
            "rows": list(VOCAB_CONTRACT_B), "vocab": list(VOCAB_CONTRACT_V),
            "topk_k": list(TOPK_CONTRACT_K), "repeats_equal": True}


# ``--only vocab``: the four vocabulary kernels' checks alone, float and int8
# weights, with their contract sweeps
VOCAB_CHECKS = (check_logits_argmax, check_logits, check_logits_topk, check_sampler,
                check_vocab_int8, vocab_contract, functools.partial(vocab_contract, quant=True))


def int8_caches(t: int, b: int, dtype, g, d: int = D):
    """int8 caches (T, B, D) with (T, B) float32 scales, quantized from random
    caches in ``dtype`` as generate does after prefill."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    kq, vq, ks, vs = Q.quantize_cache(torch.randn(t, b, d, generator=g, device="cuda").to(dtype),
                                      torch.randn(t, b, d, generator=g, device="cuda").to(dtype))
    return kq, vq, ks.contiguous(), vs.contiguous()


def check_attention_int8(dtype, g) -> dict:
    """``csrc/decode_attention.cu`` with the int8 cache at B 128 (greedy),
    at every idx of ATTN_IDX, then once in beam mode (B 512, idx 40) and
    once with start windows (B 512, idx 64), against the twin: the same
    quantizing append (identical int8 rows and scales at idx; no other row
    touched) and the walk dequantized in the compute dtype; the outputs to
    the float kernel's tolerance (summation order only)."""
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    worst = 0.0
    cases = [(B, idx, {}) for idx in ATTN_IDX]
    cases.append((B_BEAM, 40, {"origin": beam_origin(T, B_BEAM, g), "gather_start": P_LEN}))
    start = torch.randint(0, 65, (B_SERVE,), generator=g, device="cuda").to(torch.int32)
    cases.append((B_SERVE, 64, {"start": start}))
    for b, idx, mode in cases:
        q, kn, vn = (torch.randn(b, D, generator=g, device="cuda").to(dtype) for _ in range(3))
        kc, vc, ks, vs = int8_caches(T, b, dtype, g)
        kp, vp, ksp, vsp = kc.clone(), vc.clone(), ks.clone(), vs.clone()
        want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, k_scale=ksp, v_scale=vsp,
                                          **mode)
        got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, k_scale=ks, v_scale=vs, **mode)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, TOL[dtype]["out"]))
        check(all(torch.equal(a, c) for a, c in ((kc, kp), (vc, vp), (ks, ksp), (vs, vsp))),
              f"int8 cache rows or scales differ at idx {idx} ({list(mode)})")
    b, idx = B, max(ATTN_IDX)
    q, kn, vn = (torch.randn(b, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    kc, vc, ks, vs = int8_caches(T, b, dtype, g)
    kp, vp, ksp, vsp = kc.clone(), vc.clone(), ks.clone(), vs.clone()
    def kernel():
        return DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H, k_scale=ks, v_scale=vs)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H, k_scale=ksp,
                                                          v_scale=vsp))
    # the library call: SDPA over the dequantized cache rows [0, idx]
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    hd, el = D // H, q.element_size()
    q4 = q.view(b, H, 1, hd)

    def dequantized():
        return (Q.dequant(c[: idx + 1], s[: idx + 1], dtype).view(idx + 1, b, H, hd)
                .permute(1, 2, 0, 3) for c, s in ((kc, ks), (vc, vs)))

    k4, v4 = dequantized()
    def library():
        return F.scaled_dot_product_attention(q4, k4, v4)

    library_ms = time_ms(library)
    dequant_library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, *dequantized()))
    tag = str(dtype).replace("torch.", "")
    dev = device_ms(kernel, "decode_attention_kernel",
                    f"kernel_decode_attention_int8_{tag}.json")
    library_dev = device_ms(library, None, f"library_decode_attention_int8_{tag}.json")
    # int8 cache rows and their scales read, q / k_new / v_new read, the
    # output written, the int8 rows and scales appended
    nbytes = 2 * idx * b * (D + 4) + el * b * D * 4 + 2 * b * (D + 4)
    bound_ms, bound_by = bound(nbytes, 4 * b * D * (idx + 1), dtype)
    return {"kernel": "decode_attention", "mode": "int8_kv", "max_abs_err": worst, "ms": ms,
            "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library": "scaled_dot_product_attention over the cache "
            "dequantized beforehand", "dequantize_and_sdpa_ms": dequant_library_ms,
            "at": f"B {b}, D {D}, H {H}, T {T}, idx {idx}, int8 cache (1 CUDA launch, the "
                  "quantizing append included)"}


def flash_inputs(b, h, t, hd, masked, dtype, g):
    """q, k, v as the path has them — permuted views of one (B, T, 3 H hd)
    projection — and, with ``masked``, the padding mask of 15 prefix tokens
    and a caption of 9-21 tokens (8-20 + EOS)."""
    from gpt2_image_captioning_tpu_torch.ops import nn

    x = torch.randn(b, t, 3 * h * hd, generator=g, device="cuda").to(dtype)
    q, k, v = (nn.split_heads(p, h) for p in torch.split(x, h * hd, dim=-1))
    mask = None
    if masked:
        lens = 15 + torch.randint(9, 22, (b,), generator=g, device="cuda")
        mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def flash_contract_inputs(b, h, tq, tk, hd, masked, dtype, g):
    """q (B, H, Tq, hd), k and v (B, H, Tk, hd), and with ``masked`` a key
    mask keeping each batch row's first Tk/2 to Tk keys."""
    q = torch.randn(b, h, tq, hd, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(b, h, tk, hd, generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = None
    if masked:
        lens = torch.randint(tk // 2, tk + 1, (b,), generator=g, device="cuda")
        mask = (torch.arange(tk, device="cuda")[None] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def flash_sp_inputs(b, h, tq, tk, hd, dtype, g):
    """q as an sp rank has it — a permuted view of its (B, Tq, 3 H hd)
    projection — and k, v as views of the gathered (B, Tk, H hd) keys and
    values, with the train step's padding mask over the Tk keys."""
    from gpt2_image_captioning_tpu_torch.ops import nn

    x = torch.randn(b, tq, 3 * h * hd, generator=g, device="cuda").to(dtype)
    q = nn.split_heads(x[..., : h * hd], h)
    k, v = (nn.split_heads(torch.randn(b, tk, h * hd, generator=g, device="cuda").to(dtype), h)
            for _ in range(2))
    lens = 15 + torch.randint(9, 22, (b,), generator=g, device="cuda")
    return q, k, v, (torch.arange(tk, device="cuda")[None] < lens[:, None]).to(torch.int32)


def check_flash_sp(dtype, g) -> dict:
    """The flash kernel at FLASH_SP_SHAPES against its twin, timed beside its
    bound and SDPA on the same boolean mask."""
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    shapes = {}
    for name, b, h, tq, tk, hd, q_offset in FLASH_SP_SHAPES:
        q, k, v, mask = flash_sp_inputs(b, h, tq, tk, hd, dtype, g)
        want = A._flash_attention_plain(q, k, v, mask, True, q_offset)
        got = A.flash_attention_cuda(q, k, v, mask, True, q_offset)
        torch.cuda.synchronize()
        err = close(got, want, FLASH_TOL[dtype])
        valid = A._valid(q, k, mask, True, q_offset)
        # q, the output, k and v and the mask once; 4 hd operations per
        # (query, key) pair causality leaves: query i sees q_offset + i + 1 keys
        pairs = sum(min(q_offset + i + 1, tk) for i in range(tq))
        nbytes = 2 * b * h * (tq + tk) * hd * q.element_size() + 4 * b * tk
        bound_ms, bound_by = bound(nbytes, 4 * hd * pairs * b * h, split_type(dtype))
        times = flash_times(lambda: A.flash_attention_cuda(q, k, v, mask, True, q_offset),
                            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid),
                            dtype, name)
        shapes[name] = {
            "at": [b, h, tq, tk, hd], "causal": True, "key_mask": True, "q_offset": q_offset,
            "max_abs_err": err, **times,
            "plain_ms": time_ms(lambda: A._flash_attention_plain(q, k, v, mask, True, q_offset)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "plan": A.flash_plan(tq)._asdict()}
    return shapes


def flash_times(call, library_call, dtype, name: str) -> dict:
    """A flash shape's times: the kernel's and SDPA's by CUDA events (ms,
    library_ms) and from a traced window (device_ms, library_device_ms)."""
    tag = f"flash_{dtype_tag(dtype)}_{name}"
    return {"ms": time_ms(call), "library_ms": time_ms(library_call),
            "device_ms": device_ms(call, "flash_attention_kernel", f"{tag}_trace.json"),
            "library_device_ms": device_ms(library_call, None, f"{tag}_sdpa_trace.json")}


def check_flash(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    shapes = {}
    for name, b, h, t, hd, causal, masked in FLASH_SHAPES + FLASH_TP_SHAPES:
        q, k, v, mask = flash_inputs(b, h, t, hd, masked, dtype, g)
        want = A._flash_attention_plain(q, k, v, mask, causal)
        got = A.flash_attention_cuda(q, k, v, mask, causal)
        torch.cuda.synchronize()
        err = close(got, want, FLASH_TOL[dtype])
        plain_ms = time_ms(lambda: A._flash_attention_plain(q, k, v, mask, causal))
        if masked:
            valid = A._valid(q, k, mask, causal, 0)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid)  # noqa: E731
        else:
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        times = flash_times(lambda: A.flash_attention_cuda(q, k, v, mask, causal), library,
                            dtype, name)
        # q, k, v read and the output written once (and the mask); 4 hd
        # operations per (query, key) pair the masks leave to compute
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes = 4 * b * h * t * hd * q.element_size() + (4 * b * t if masked else 0)
        bound_ms, bound_by = bound(nbytes, 4 * hd * pairs * b * h, split_type(dtype))
        shapes[name] = {"at": [b, h, t, hd], "causal": causal, "padding_mask": masked,
                        "max_abs_err": err, **times,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes,
                        "plan": A.flash_plan(t)._asdict()}
    for name, b, h, tq, tk, hd, causal, masked, q_offset in FLASH_CONTRACT:
        q, k, v, mask = flash_contract_inputs(b, h, tq, tk, hd, masked, dtype, g)
        want = A._flash_attention_plain(q, k, v, mask, causal, q_offset)
        got = A.flash_attention_cuda(q, k, v, mask, causal, q_offset)
        torch.cuda.synchronize()
        shapes[name] = {"at": [b, h, tq, tk, hd], "causal": causal, "q_offset": q_offset,
                        "key_mask": masked, "max_abs_err": close(got, want, FLASH_TOL[dtype]),
                        "plan": A.flash_plan(tq)._asdict()}
    shapes.update(check_flash_sp(dtype, g))
    shapes["fully_masked_row"] = check_flash_masked_row(dtype, g)
    main = shapes[FLASH_MAIN[dtype]]
    return {"kernel": "flash_attention", "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "device_ms", "library_device_ms")},
            "at": FLASH_MAIN[dtype], "library": "scaled_dot_product_attention, same boolean mask",
            "tolerance": FLASH_TOL[dtype], "shapes": shapes}


def flash_registers() -> dict:
    """Each flash instantiation (bf16 and float32 at every built head dim):
    its layout as the C side has it (``gic_flash_layout``) against the
    Python mirror (``ops/attention.py::flash_layout``, which must agree), the
    blocks an SM holds, and its registers and local (spill) bytes a thread,
    as ``cudaFuncGetAttributes`` gives them; none may spill."""
    import ctypes

    from gpt2_image_captioning_tpu_torch.ops import _build
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    lib, out = _build.library(), {}
    fn = getattr(lib, "gic_flash_layout", None)
    if fn is None:
        return {"phase": "flash_registers", "kernels": "not in this tree"}
    for dtype in (torch.bfloat16, torch.float32):
        for hd in A.HEAD_DIMS:
            res = (ctypes.c_int * 8)()
            _build.check(fn(_build.DTYPE_CODE[dtype], hd, ctypes.addressof(res)),
                         "gic_flash_layout")
            c_side = {"smem_bytes": res[0], "kv_tile": res[1], "stages": res[2],
                      "q_buffers": res[3], "threads": res[4]}
            mirror = A.flash_layout(dtype, hd)._asdict()
            check(c_side == mirror, f"flash layout {dtype} hd {hd}: C {c_side} != {mirror}")
            out[f"{dtype_tag(dtype)} hd {hd}"] = {**c_side, "blocks_per_sm": res[5],
                                                  "num_regs": res[6], "local_bytes": res[7]}
    spills = {k: v["local_bytes"] for k, v in out.items() if v["local_bytes"]}
    check(not spills, f"flash instantiations with local (spill) bytes: {spills}")
    return {"phase": "flash_registers", "kernels": out}


def check_flash_masked_row(dtype, g) -> dict:
    """A batch row whose keys are all masked, at the shape of the CPU test
    (B 2, H 2, T 12) with the kernel's head dim 64: the JAX package gives the
    uniform softmax there, the mean of v over the keys; so must the kernel."""
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    q, k, v = (torch.randn(2, 2, 12, 64, generator=g, device="cuda").to(dtype) for _ in range(3))
    mask = torch.ones(2, 12, dtype=torch.int32, device="cuda")
    mask[0] = 0
    got = A.flash_attention_cuda(q, k, v, mask)
    want = A._flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = close(got, want, FLASH_TOL[dtype])
    mean_v = v.float().mean(dim=2, keepdim=True).expand(2, 2, 12, 64)
    err = max(err, close(got[0], mean_v[0], FLASH_TOL[dtype]))
    return {"at": [2, 2, 12, 64], "masked_batch_row": 0, "max_abs_err": err}


def check_flash_backward(g) -> dict:
    """Gradients of one scalar loss through ``FlashAttention`` with the
    kernel's forward against the twin's, at the GPT-2 training shape, bf16."""
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    _, b, h, t, hd, causal, masked = FLASH_SHAPES[0]
    q, k, v, mask = flash_inputs(b, h, t, hd, masked, torch.bfloat16, g)
    w = torch.randn(b, h, t, hd, generator=g, device="cuda")
    grads = []
    for use in (True, False):
        qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = A.flash_attention(*qkv, causal=causal, key_mask=mask, use_kernel=use).float()
        ((out * w).sum() + 0.5 * (out * out).sum()).backward()
        grads.append([x.grad.float() for x in qkv])
    rel = max(float((a - b_).norm() / b_.norm()) for a, b_ in zip(*grads))
    worst = max(float((a - b_).abs().max()) for a, b_ in zip(*grads))
    check(rel <= FLASH_BWD_TOL, f"flash backward: relative gradient error {rel} > {FLASH_BWD_TOL}")
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        A.flash_attention(*qkv, causal=causal, key_mask=mask).sum().backward()

    return {"phase": "flash_backward", "at": [b, h, t, hd], "dtype": "bfloat16",
            "max_rel_norm_err": rel, "max_abs_err": worst, "tolerance": FLASH_BWD_TOL,
            "fwd_bwd_ms": time_ms(fwd_bwd, iters=10)}


@functools.cache
def gpt2_124m_params() -> dict:
    """GPT-2 124M at its init distributions from a seed, float32 on the CPU."""
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G

    return G.init(torch.Generator().manual_seed(0), G.GPT2Config.gpt2_124m())


PREFILL_ROLES = ("qkv", "attn_proj", "mlp_fc", "mlp_proj")  # a layer's products, in order


def prefill_split(run, name: str, attempts: int = 3) -> dict | str:
    """Device ms of one prefill call by part, from a ``traced`` call: the
    LayerNorms (``ln_rows_kernel``; a first-version tree's own LN kernel),
    the attention, and each of a layer's four products summed over the
    layers (the product launches of a call come in :data:`PREFILL_ROLES`'
    order each layer); "not measured" if no window was whole."""
    run()
    for _ in range(attempts):
        _, events, dropped = traced(run, f"prefill_split_{name}.json")
        kernels = sorted((e for e in events if e["cat"] == "kernel"), key=lambda e: e["ts"])
        products = [e for e in kernels if "linear" in e["name"]]
        if dropped or not products or len(products) % len(PREFILL_ROLES):
            continue

        def ms(events):
            return sum(e["dur"] for e in events) / 1e3

        parts = {"total": ms(events),
                 "layernorm": ms(e for e in kernels if "layernorm" in e["name"]
                                 or "ln_rows_kernel" in e["name"]),
                 "attention": ms(e for e in kernels if "prefill_attention_kernel" in e["name"])}
        for i, role in enumerate(PREFILL_ROLES):
            parts[role] = ms(products[i::len(PREFILL_ROLES)])
        parts["product_kernels"] = sorted({e["name"].split("(")[0] for e in products})
        return parts
    return "not measured"


def gelu_share(m: int, g) -> dict:
    """The MLP fc product at the prefill's ``m`` rows in bf16 (K 768, N
    3,072) with its gelu_new epilogue (float64, rounded once) and with the
    plain cast: device ms of the product kernel each, and their difference,
    what gelu_new costs."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x = torch.randn(m, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(4 * D, D, generator=g, device="cuda")).to(torch.bfloat16)
    bias = 0.02 * torch.randn(4 * D, generator=g, device="cuda")
    out = {}
    for epi in ("cast", "gelu"):
        out[epi] = device_ms(lambda: DS.fused_linear_cuda(x, w, bias, epilogue=epi),
                             "linear_wgmma_kernel", f"gelu_share_{epi}_m{m}.json")
    if not any(isinstance(v, str) for v in out.values()):
        out["gelu_new"] = out["gelu"] - out["cast"]
    return {"rows": m, **out}


def check_prefill(dtype, g) -> dict:
    """The prefill kernel against its twin at a request (B 128) and an
    admission (8 images) of 15 prefix tokens: the residual stream, every
    layer's K/V cache rows and the first-token logits; beside its time the
    twin's and the eager prefill's (``forward_cached`` with the flash kernel,
    the port's prefill before the kernel: no one library call computes it)."""
    from gpt2_image_captioning_tpu_torch import BF16, F32
    from gpt2_image_captioning_tpu_torch.core.tree import tree_map
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import prefill_step as PS

    cfg = G.GPT2Config.gpt2_124m()
    gp = tree_map(lambda t: t.to("cuda", dtype), gpt2_124m_params())
    packed = DS.pack_decode_weights(gp, dtype)
    pol = BF16 if dtype == torch.bfloat16 else F32
    tol, el, n_layer = PREFILL_TOL[dtype], gp["wte"].element_size(), cfg.n_layer
    shapes = {}
    for b in PREFILL_BATCHES:
        prefix = 0.5 * torch.randn(b, P_LEN, D, generator=g, device="cuda")
        x0 = (prefix + gp["wpe"][:P_LEN].float()).to(dtype)
        ck, cp = (G.init_cache(cfg, b, P_LEN, dtype=dtype, device="cuda") for _ in range(2))
        got = PS.prefill_cuda(packed, x0, ck["k"], ck["v"], n_head=H)
        want = PS.prefill_plain(packed, x0, cp["k"], cp["v"], n_head=H)
        lk = PS.prefill_into_cache(packed, gp, cfg, prefix, G.init_cache(
            cfg, b, P_LEN, dtype=dtype, device="cuda"), pol, use_kernel=True)[0]
        lp = PS.prefill_into_cache(packed, gp, cfg, prefix, G.init_cache(
            cfg, b, P_LEN, dtype=dtype, device="cuda"), pol, use_kernel=False)[0]
        torch.cuda.synchronize()
        errs = {"x32": close(got, want, tol["x32"]),
                "cache": max(close(ck[n][:, :P_LEN], cp[n][:, :P_LEN], tol["cache"])
                             for n in ("k", "v")),
                "logits": close(lk, lp, tol["logits"])}
        ms = time_ms(lambda: PS.prefill_cuda(packed, x0, ck["k"], ck["v"], n_head=H))
        plain_ms = time_ms(lambda: PS.prefill_plain(packed, x0, cp["k"], cp["v"], n_head=H),
                           iters=5)
        ce = G.init_cache(cfg, b, P_LEN, dtype=dtype, device="cuda")

        def eager():
            ce["index"] = 0
            G.forward_cached(gp, cfg, prefix, ce, pol)

        eager_ms = time_ms(eager, iters=5)
        # two calls on the same inputs give the same bits: the products'
        # K-slices are added in a fixed order, the attention has no atomics
        again = [G.init_cache(cfg, b, P_LEN, dtype=dtype, device="cuda") for _ in range(2)]
        twice = [PS.prefill_cuda(packed, x0, c["k"], c["v"], n_head=H) for c in again]
        torch.cuda.synchronize()
        check(torch.equal(twice[0], twice[1]) and all(torch.equal(again[0][n], again[1][n])
                                                      for n in ("k", "v")),
              f"prefill b {b} {dtype_tag(dtype)}: a repeat gave other bits")

        def run():
            return PS.prefill_cuda(packed, x0, ck["k"], ck["v"], n_head=H)

        device = vocab_device(run, f"prefill_{dtype_tag(dtype)}_b{b}")
        parts = prefill_split(run, f"{dtype_tag(dtype)}_b{b}")
        if dtype == torch.float32 and not isinstance(parts, str):  # the TF32 products, by name
            check(all(TF32_LINEAR in n for n in parts["product_kernels"]),
                  f"prefill b {b} float32: products {parts['product_kernels']}")
        # the weights, biases and LN parameters read once; x0 read, the float32
        # stream and every layer's K/V rows written; four products and the
        # causal attention (4 hd per (query, key) pair) a layer
        rows = b * P_LEN
        nbytes = (n_layer * (12 * D * D * el + 4 * 13 * D) + rows * D * (el + 4)
                  + 2 * n_layer * rows * D * el)
        ops = n_layer * (2 * rows * 12 * D * D + 4 * (D // H) * H * b * P_LEN * (P_LEN + 1) // 2)
        bound_ms, bound_by = bound(nbytes, ops, split_type(dtype))
        shapes[f"b{b}"] = {"images": b, "prefix": P_LEN, "max_abs_err": max(errs.values()),
                           "errors": errs, "ms": ms, "device_ms": device, "plain_ms": plain_ms,
                           "device_ms_by_part": parts, "repeat": "equal bits",
                           "eager_ms": eager_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                           "ops": ops}
    # beyond MAX_PREFIX the kernel route refuses on the card: no other prefill runs
    long = torch.zeros(1, PS.MAX_PREFIX + 1, D, device="cuda")
    try:
        PS.prefill_into_cache(packed, gp, cfg, long, G.init_cache(
            cfg, 1, PS.MAX_PREFIX + 1, dtype=dtype, device="cuda"), pol, use_kernel=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"prefill: a {PS.MAX_PREFIX + 1}-token prefix was not refused")
    main = shapes[f"b{B}"]
    if dtype == torch.bfloat16:
        main["mlp_fc_gelu_share"] = gelu_share(B * P_LEN, g)
    return {"kernel": "prefill", "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "eager_ms": main["eager_ms"],
            "eager": "gpt2.forward_cached with the flash kernel (the port's earlier prefill)",
            "tolerance": tol, "at": f"GPT-2 124M, B {B} x {P_LEN} tokens", "shapes": shapes,
            "refuses_prefix": PS.MAX_PREFIX + 1}


def patch_embed_bound(b: int, side: int, p: int, d: int, dtype) -> dict:
    """The least work of a patch embedding of ``b`` uint8 images of ``side``
    px at patch ``p`` into width ``d``: bytes (the pixels, W in the operand
    type, mean / inv_std, the bias, the float32 output: each once) and
    operations (2 M K D, at the peak of the products' type: float32 runs as
    the three-term TF32 split), and the larger of the two times."""
    m, k = b * (side // p) ** 2, 3 * p * p
    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * side * side * 3 + k * d * el + 4 * m * d + 8 * k + 4 * d
    ops = 2 * m * k * d
    ms, by = bound(nbytes, ops, split_type(dtype))
    return {"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by}


def patch_registers() -> dict:
    """Each patch-embed route (bf16 and float32, 16-byte and byte loads): its
    layout as the C side has it (``gic_patch_layout``) against the Python
    mirror (``ops/patch_embed.py::patch_layout``, which must agree), its
    shared memory within the block's 227 KB, and its registers and local
    (spill) bytes a thread, as ``cudaFuncGetAttributes`` gives them; the
    float32 routes may not spill."""
    import ctypes

    from gpt2_image_captioning_tpu_torch.ops import _build
    from gpt2_image_captioning_tpu_torch.ops import attention as A
    from gpt2_image_captioning_tpu_torch.ops import patch_embed as PE

    lib, out = _build.library(), {}
    fn = getattr(lib, "gic_patch_layout", None)
    if fn is None:
        return {"phase": "patch_registers", "kernels": "not in this tree"}
    for dtype in (torch.bfloat16, torch.float32):
        for aligned in (1, 0):
            res = (ctypes.c_int * 10)()
            _build.check(fn(_build.DTYPE_CODE[dtype], aligned, ctypes.addressof(res)),
                         "gic_patch_layout")
            c_side = {"rows": res[1], "cols": res[2], "k_stage": res[3], "stages": res[4],
                      "threads": res[5], "chain": res[6], "smem_bytes": res[0]}
            mirror = PE.patch_layout(dtype)._asdict()
            name = f"{dtype_tag(dtype)} {'16-byte' if aligned else 'byte'} loads"
            check(c_side == mirror, f"patch layout {name}: C {c_side} != {mirror}")
            check(res[0] + res[7] <= A.SMEM_LIMIT, f"patch layout {name}: shared memory "
                  f"{res[0]} + {res[7]} > {A.SMEM_LIMIT}")
            out[name] = {**c_side, "static_smem_bytes": res[7], "num_regs": res[8],
                         "local_bytes": res[9]}
    spills = {k: v["local_bytes"] for k, v in out.items()
              if k.startswith("float32") and v["local_bytes"]}
    check(not spills, f"float32 patch-embed routes with local (spill) bytes: {spills}")
    return {"phase": "patch_registers", "kernels": out}


def check_patch_embed(dtype, g) -> dict:
    """The patch-embed kernel against its twin at the three towers' shapes,
    with its time beside the bound (:func:`patch_embed_bound`) and the
    library route (unfold, normalise, ``torch.mm``)."""
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS
    from gpt2_image_captioning_tpu_torch.ops import patch_embed as PE

    def inputs(name, b, side, p, d, with_bias):
        px = torch.randint(0, 256, (b, side, side, 3), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
        w = (0.02 * torch.randn(3 * p * p, d, generator=g, device="cuda")).to(dtype)
        bias = 0.1 * torch.randn(d, generator=g, device="cuda") if with_bias else None
        mean, inv = PE.normalization_vectors(SPECS[name], p, "cuda")
        return px, w, mean, inv, p, bias

    def checked(args):
        got = PE.patch_embed_cuda(*args)
        want = PE.patch_embed_plain(*args)
        torch.cuda.synchronize()
        return close(got, want, PATCH_TOL)

    contract = {f"{name} b {b}, {side} px, patch {p}, D {d}": {
        "max_abs_err": checked(inputs(name, b, side, p, d, with_bias))}
        for name, b, side, p, d, with_bias in PATCH_CONTRACT}
    tag = str(dtype).replace("torch.", "")
    shapes = {}
    for name, b, p, d, with_bias in TOWERS:
        args = inputs(name, b, 224, p, d, with_bias)
        px, w, mean, inv, _, bias = args
        err = checked(args)
        ms = time_ms(lambda: PE.patch_embed_cuda(*args))
        plain_ms = time_ms(lambda: PE.patch_embed_plain(*args))
        kw = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}

        def library():
            x = ((PE._unfold_u8(px, p).float() * (1.0 / 255.0) - mean) * inv).to(dtype)
            return torch.mm(x, w, **kw)

        library_ms = time_ms(library)
        dev = device_ms(lambda: PE.patch_embed_cuda(*args), "patch_embed_kernel",
                        f"kernel_patch_embed_{name}_{tag}.json")
        library_dev = device_ms(library, None, f"library_patch_embed_{name}_{tag}.json")
        work = patch_embed_bound(b, 224, p, d, dtype)
        shapes[name] = {"images": b, "patch": p, "M": b * (224 // p) ** 2, "K": 3 * p * p,
                        "D": d, "bias": with_bias, "max_abs_err": err, "ms": ms,
                        "device_ms": dev, "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_device_ms": library_dev, **work}
    main = shapes["clip"]
    return {"kernel": "patch_embed", "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms", "library_device_ms")},
            "library": "unfold + normalise + torch.mm (float32 out)", "tolerance": PATCH_TOL,
            "at": "CLIP B/32, b 256", "shapes": shapes, "contract": contract}


def trace_summary(events: list[dict]) -> dict:
    """A traced window's device time: from its first device event to the end
    of its last, the busy union of all of them, the idle share, and the
    kernels that take the most of it."""
    if not events:
        return {"idle_share": "not measured"}
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = busy_us(events, lo, hi)
    by_name: dict[str, float] = {}
    for e in events:
        if e["cat"] == "kernel":
            by_name[e["name"][:100]] = by_name.get(e["name"][:100], 0.0) + e["dur"] * 1e-6
    return {"device_window_s": (hi - lo) * 1e-6, "device_busy_s": busy * 1e-6,
            "idle_share": 1.0 - busy / (hi - lo),
            "kernel_launches": sum(e["cat"] == "kernel" for e in events),
            "top_kernels_s": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}


def tower_params(name: str, dtype=torch.bfloat16):
    """A tower at full width from a seed, in ``dtype`` on the card: (module,
    config, params)."""
    from gpt2_image_captioning_tpu_torch.core.precision import cast_floating
    from gpt2_image_captioning_tpu_torch.models import clip as CL
    from gpt2_image_captioning_tpu_torch.models import dino as DN
    from gpt2_image_captioning_tpu_torch.models import vit as VT

    mod, cfg, init = {"clip": (CL, CL.CLIPVisionConfig.vit_b32(), CL.init_vision),
                      "vit": (VT, VT.ViTConfig.base_patch16_224(), VT.init),
                      "dino": (DN, DN.DINOv3Config.vitl16(), DN.init)}[name]
    params = cast_floating(init(torch.Generator().manual_seed(0), cfg, device="cuda"), dtype)
    return mod, cfg, params


def towers_path() -> tuple[list[dict], dict]:
    """Each tower at full width, bf16 then float32, from synthetic uint8
    pixels through its uint8 entry point (the patch-embed kernel, then the
    tower with the flash kernel): img/s over three batches, launches,
    features against ``use_kernels=False``, and one traced encode's idle
    share."""
    from gpt2_image_captioning_tpu_torch import BF16, F32
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS

    records, launches = [], {}
    for (name, b, _, _, _), policy in [(t, BF16) for t in TOWERS] + [(t, F32) for t in TOWERS]:
        f32 = policy is F32
        tag = f"{name}_f32" if f32 else name
        mod, cfg, params = tower_params(name, torch.float32 if f32 else torch.bfloat16)
        g = torch.Generator(device="cuda").manual_seed(3)
        px = torch.randint(0, 256, (b, 224, 224, 3), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.uint8)

        def run(_=None, use=None):
            with torch.no_grad():
                return mod.encode_image_u8(params, cfg, px, SPECS[name], policy=policy,
                                           use_kernels=use)

        run()  # warm-up
        torch.cuda.synchronize()
        outs, seconds, counts = run_counted(run, range(3))
        want = {k: 0 for k in counts}
        want.update(patch_embed=3, flash_attention=3 * cfg.num_hidden_layers)
        check(counts == want, f"{tag} tower launches {counts} != {want}")
        feats, plain = outs[0].float(), run(use=False).float()
        check(tuple(feats.shape) == (b, plain.shape[1]) and bool(feats.isfinite().all()),
              f"{tag}: bad features {tuple(feats.shape)}")
        diff = float((feats - plain).abs().max())
        cos = float((feats * plain).sum(-1).min())
        norm_err = float((feats.norm(dim=-1) - 1.0).abs().max())
        check(diff <= TOWER_TOL and cos >= TOWER_COS and norm_err <= 1e-3,
              f"{tag} features: max diff {diff} (<= {TOWER_TOL}), min cosine {cos} "
              f"(>= {TOWER_COS}), norm error {norm_err}")
        _, events, _ = traced(run, f"{tag}_encode_trace.json")
        seq = {"clip": 50, "vit": 197, "dino": 201}[name]
        records.append({
            "phase": f"tower_{tag}", "config": type(cfg).__name__,
            "dtype": "float32" if f32 else "bf16",
            "images": b, "batches": 3, "seconds": seconds, "img_per_s": 3 * b / seconds,
            "launches": counts, "flash_seq_len": seq, "features_vs_plain_max_abs": diff,
            "features_vs_plain_min_cos": cos, "tolerance": [TOWER_TOL, TOWER_COS],
            "traced_encode": {**trace_summary(events), "trace": f"{tag}_encode_trace.json.gz"},
            "card": nvidia_smi()})
        launches[f"tower_{tag}"] = counts
        del params, px, outs
        torch.cuda.empty_cache()
    return records, launches


def images_path(model, clip_cfg, clip_params, mode: str) -> tuple[dict, dict]:
    """Images to captions: ``CaptionService(batch_size=128)`` on CLIP B/32 +
    the serving model (bf16 decode), ``IMAGE_BATCHES`` batches of synthetic
    uint8 pixels at 224, greedy or sampled at the façade's defaults; img/s end
    to end, the encode / decode split, launches, and every token held to the
    plain path as the one-shot paths' are (teacher-forced / nucleus)."""
    from gpt2_image_captioning_tpu_torch.serving import CaptionService

    kw = dict(temperature=0.0) if mode == "greedy" else dict(temperature=1.0, top_p=TOP_P)
    svc = CaptionService(model, clip_params, clip_cfg, batch_size=B,
                         max_length=50, decode_precision="bf16", **kw)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8)
               for _ in range(IMAGE_BATCHES)]
    svc.caption_prepped(batches[0][:8])  # warm-up
    # the encode's window from CUDA events recorded on the stream, with no
    # barrier inside the timed run; the embeddings are kept for the checks
    encode, embs, marks = svc._encode, [], []

    def marked_encode(params, u8):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        e = encode(params, u8)
        end.record()
        marks.append((start, end))
        embs.append(e)
        return e

    svc._encode = marked_encode
    torch.cuda.synchronize()
    caps, seconds, launches = run_counted(svc.caption_prepped, batches)
    svc._encode = encode
    enc_s = sum(a.elapsed_time(z) for a, z in marks) / 1e3
    cfg, eos = model.cfg, model.cfg.eos_token_id
    worst, checked, agree, steps = 0.0, 0, 0.0, 0
    for e, c in zip(embs, caps):
        ids = [caption_ids(x) for x in c]
        tokens, _ = served_matrix(ids, [50] * len(ids), eos)
        steps += decode_steps(tokens, eos)
        if mode == "greedy":
            w, n, a = teacher_forced(model, e, tokens)
        else:
            w, n, a = nucleus_mass(model, e, tokens, 1.0)
        worst, checked, agree = max(worst, w), checked + n, agree + a * n
    check_decode_launches(launches, "logits_argmax" if mode == "greedy" else "logits", steps,
                          IMAGE_BATCHES, cfg, images=True)
    if mode == "greedy":
        check(worst <= TF_TOL, f"images_{mode}: a chosen token is {worst} below the plain max")
        checked_rec = {"worst_deficit": worst, "tolerance": TF_TOL}
    else:
        check(worst <= TOP_P + NUCLEUS_SLACK, f"images_{mode}: plain mass {worst} above a draw")
        checked_rec = {"worst_mass_above": worst, "limit": TOP_P + NUCLEUS_SLACK}
    n_img = IMAGE_BATCHES * B
    record = {
        "phase": f"images_{mode}_path", "model": f"CLIP ViT-B/32 + {MODEL_NAME}",
        "dtype": "bf16 tower and decode", "images": n_img, "batch": B, "max_length": 50, **kw,
        "seconds": seconds, "img_per_s": n_img / seconds, "encode_s": enc_s,
        "decode_s": seconds - enc_s, "encode_share": enc_s / seconds,
        "encode_timed_by": "CUDA events around each batch's encode, no barrier",
        "decode_steps": steps, "launches": launches,
        "checked": {**checked_rec, "tokens_checked": checked, "share_plain_argmax": agree / checked},
        "card": nvidia_smi()}
    return record, launches


def tiny_pixel_model():
    """(model, tower params, tower config): a CLIP tower with the flash
    kernel's head dim (128 = 2 x 64, 64-pixel images of 16 patches) feeding
    the tiny captioner, float32, from seeds."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.clip import CLIPVisionConfig, init_vision

    cfg = tiny_config()
    vcfg = CLIPVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, image_size=64, patch_size=16,
                            projection_dim=16)
    vparams = init_vision(torch.Generator().manual_seed(8), vcfg, device="cuda")
    model = C.ImageCaptioningModel(cfg, tokenizer=synthetic_tokenizer(cfg.gpt2.vocab_size),
                                   generator=torch.Generator().manual_seed(7), device="cuda")
    return model, vparams, vcfg


def tiny_pixels() -> dict:
    """Tiny float32 from pixels (:func:`tiny_pixel_model`): ``CaptionService``
    and the continuous service's ``submit_prepped`` give the same captions
    with the kernels as without them."""
    from gpt2_image_captioning_tpu_torch import F32
    from gpt2_image_captioning_tpu_torch.serving import CaptionService, ContinuousCaptionService

    model, vparams, vcfg = tiny_pixel_model()
    prepped = np.random.default_rng(9).integers(0, 256, size=(10, 64, 64, 3), dtype=np.uint8)
    out, counts = {}, {}
    for use in (None, False):
        key = "kernels" if use is None else "plain"
        reset_launches()
        fixed = CaptionService(model, vparams, vcfg, batch_size=4, max_length=12, policy=F32,
                               use_kernels=use).caption_prepped(prepped)
        svc = ContinuousCaptionService(model, vparams, vcfg, slots=3, segment=2, bursts=2,
                                       admit=2, max_length=12, use_kernels=use)
        rids = [svc.submit_prepped(p) for p in prepped]
        svc.drain()
        torch.cuda.synchronize()
        counts[key] = read_launches()
        out[key] = (fixed, [svc.pop_result(r) for r in rids])
    check(out["kernels"] == out["plain"], f"tiny f32 captions from pixels differ: {out}")
    check(out["kernels"][0] == out["kernels"][1],
          f"tiny f32: the continuous service's captions differ from CaptionService's: {out}")
    check(all(counts["kernels"][k] > 0 for k in ("patch_embed", "prefill", "flash_attention"))
          and not any(counts["plain"].values()), f"tiny f32 from pixels: launches {counts}")
    return {"phase": "tiny_f32_exact_pixels", "images": len(prepped), "captions_equal": True,
            "launches_kernels": counts["kernels"]}


def extraction_phase(cfg, clip_params) -> dict:
    """``_run_extraction`` from an in-memory loader of prepped uint8 batches
    (the tail padded and masked) through CLIP B/32's uint8 entry point, the
    ``.pt`` written and read back."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
    from gpt2_image_captioning_tpu_torch.embeddings.extract import _run_extraction
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS
    from gpt2_image_captioning_tpu_torch.models import clip as CL

    bs = 64
    rng = np.random.default_rng(5)
    loader = []
    for i in range(EXTRACT_BATCHES):
        n = EXTRACT_TAIL if i == EXTRACT_BATCHES - 1 else bs
        batch = rng.integers(0, 256, size=(bs, 224, 224, 3), dtype=np.uint8)
        batch[n:] = batch[n - 1]
        loader.append(([f"img_{i * bs + j:05d}.jpg" for j in range(n)], batch,
                       np.arange(bs) < n))
    path = OUT_DIR / "extract_clip.pt"
    reset_launches()
    names, emb = _run_extraction(
        loader, str(path), lambda u8: CL.encode_image_u8(clip_params, cfg, u8, SPECS["clip"],
                                                         policy=BF16), "CLIP", device="cuda")
    counts = read_launches()
    n_img = (EXTRACT_BATCHES - 1) * bs + EXTRACT_TAIL
    check(len(names) == n_img and emb.shape == (n_img, cfg.projection_dim),
          f"extraction: {len(names)} names, embeddings {emb.shape}")
    check(counts["patch_embed"] == EXTRACT_BATCHES, f"extraction launches {counts}")
    back_names, back = load_embeddings(str(path))
    check(back_names == names and np.array_equal(back, emb), "the .pt did not read back")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=-1) - 1.0).max())
    check(norm_err <= 1e-3, f"extraction: norm error {norm_err}")
    return {"phase": "extraction", "images": n_img, "batches": EXTRACT_BATCHES,
            "embeddings": list(emb.shape), "launches": counts, "file": path.name,
            "norm_err": norm_err}


def environment() -> dict:
    """Which of PIL, transformers, triton and numpy import here, and their
    versions (PIL is imported only where an image is decoded)."""
    import importlib

    found = {}
    for name in ("PIL", "transformers", "triton", "numpy"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "unknown")
        except Exception as e:  # recorded, not raised: a package that is absent is the answer
            found[name] = f"not importable ({type(e).__name__})"
    return {"phase": "environment", "packages": found}


# ---------------------------------------------------------------------------
# Phases 4 and 5: generate — greedy, sampled (top-p) and beam search
# ---------------------------------------------------------------------------

def decode_steps(tokens: torch.Tensor, eos: int) -> int:
    """Decode steps generate ran for this output: it stops once every row has
    emitted EOS, or after max_length - 1 steps."""
    b, max_length = tokens.shape
    is_eos = (tokens == eos).cpu().numpy()
    first = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), max_length)
    return int(min(first.max(), max_length - 1))


def check_padding(tokens: torch.Tensor, eos: int, vocab: int) -> int:
    """Every row is EOS after its first EOS; returns the number of rows that
    finished before the last position."""
    t = tokens.cpu().numpy()
    check(t.dtype == np.int32 and ((t >= 0) & (t < vocab)).all(), "token ids out of range")
    finished = 0
    for row in t:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            check(bool((row[hits[0]:] == eos).all()), "a row is not EOS-padded after its EOS")
            finished += int(hits[0] < len(row) - 1)
    return finished


def tiny_config():
    """A tiny float32 model with the flash kernel's two head dims: GPT-2 with
    2 layers of 192 = 3 heads x 64, vocab 293; the transformer mapper with 2
    layers of 2 heads x 96 (16-d embeddings, 3 image + 4 prefix tokens)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig

    gcfg = GPT2Config(vocab_size=293, n_positions=128, n_embd=192, n_layer=2, n_head=3)
    return C.CaptionerConfig(gpt2=gcfg, mapping=TransformerMappingConfig(
        16, 192, prefix_length=4, hidden_length=3, num_layers=2, num_heads=2),
        eos_token_id=292)


def tiny_exact(mode: str) -> dict:
    """Kernels against the plain path on the tiny float32 model, exactly:
    greedy tokens, sampled tokens from one generator seed (``in_kernel``:
    drawn inside the step by the sampler kernel, whose twin takes the same
    Philox words), beams, or continuous serving's captions; the ``*_int8``
    modes decode W8A8 (``decode_quant=True``), ``greedy_int8_kv`` with the
    int8 cache too.  EOS := a token row 0 emits after its first, absent from
    the first column, so some rows stop early and get padded while others
    run on.  The record carries the kernels' launches in the kernel run."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg = tiny_config()
    tr, fz = C.init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
    emb = torch.from_numpy(np.random.default_rng(5).normal(size=(5, 16)).astype(np.float32))
    emb = emb.cuda()
    probe = C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0,
                       use_kernels=False).cpu().numpy()
    firsts = set(probe[:, 0].tolist())
    eos = next((int(t) for t in probe[0, 1:] if int(t) not in firsts), int(probe[0, 1]))
    cfg = dataclasses.replace(cfg, eos_token_id=eos)
    quant = mode.endswith(("_int8", "_int8_kv"))
    if mode.startswith("continuous"):
        return tiny_continuous(tr, fz, cfg, quant)

    def run(use):
        if mode.startswith("beam"):
            return C.beam_generate(tr, fz, cfg, emb, max_length=12, beam_size=BEAM_K,
                                   use_kernels=use, decode_quant=quant)
        kw = dict(temperature=0.0) if mode.startswith("greedy") else dict(
            temperature=1.0, top_p=TOP_P, generator=torch.Generator(device="cuda").manual_seed(3),
            sample_in_kernel=mode == "in_kernel")
        return C.generate(tr, fz, cfg, emb, max_length=12, use_kernels=use, decode_quant=quant,
                          decode_quant_cache=mode == "greedy_int8_kv", **kw)

    want = run(False)
    reset_launches()
    got = run(True)
    torch.cuda.synchronize()
    launches = read_launches()
    check(torch.equal(got, want), f"tiny f32 {mode} tokens differ:\n{got.cpu()}\n{want.cpu()}")
    return {"phase": f"tiny_f32_exact_{mode}", "eos": eos, "tokens_equal": True,
            "launches": launches,
            "rows_finished_early": check_padding(got, eos, cfg.gpt2.vocab_size),
            "decode_steps": decode_steps(got, eos), "batch": 5, "max_length": 12}


def synthetic_tokenizer(vocab: int):
    """A tokenizer for random weights, whose GPT-2 assets the repository lacks:
    token i is the byte string " i" (Ġ is the byte-level symbol of the
    space), the last id is EOS, so a caption decodes to its ids and
    :func:`caption_ids` parses it back exactly."""
    from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer

    return GPT2BPETokenizer({f"\u0120{i}": i for i in range(vocab - 1)}, [])


def caption_ids(caption: str) -> list[int]:
    return [int(w) for w in caption.split()]


def served_ids(svc, embs, caps) -> list[list[int]]:
    """Submit every embedding with its cap, drain, and return each request's
    caption as ids (EOS stripped, as the service returns it)."""
    rids = [svc.submit_embedding(e, max_length=int(c)) for e, c in zip(embs, caps)]
    svc.drain()
    return [caption_ids(svc.pop_result(r)) for r in rids]


def one_shot_ids(tokens: torch.Tensor, caps, eos: int) -> list[list[int]]:
    """One-shot generate's rows cut at each request's cap and first EOS."""
    out = []
    for row, c in zip(tokens.cpu().tolist(), caps):
        row = row[: int(c)]
        out.append(row[: row.index(eos)] if eos in row else row)
    return out


def tiny_continuous(tr, fz, cfg, quant: bool = False) -> dict:
    """Greedy continuous serving on the tiny float32 model, with the kernels
    and without: every caption equals one-shot ``generate``'s, across
    staggered admission (10 requests, 3 slots), compaction at every macro
    (the minimal t_max), per-request caps and pool reuse after a drain.
    ``quant``: W8A8 in float32 — the service built as ``decode_precision=
    "int8"`` builds it, its pack made W8A8, here from the float32 weights
    (the public option packs the bf16 copy, which the full-width int8 phase
    runs)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService

    model = C.ImageCaptioningModel(cfg, tokenizer=synthetic_tokenizer(cfg.gpt2.vocab_size),
                                   device="cuda")
    model.trainable, model.frozen = tr, fz
    embs = np.random.default_rng(6).normal(size=(12, 16)).astype(np.float32)
    caps = [12, 5, 1, 12, 8, 12, 3, 12, 12, 7, 12, 12]
    tokens = C.generate(tr, fz, cfg, torch.from_numpy(embs).cuda(), max_length=12,
                        temperature=0.0, use_kernels=False, decode_quant=quant)
    want = one_shot_ids(tokens, caps, cfg.eos_token_id)
    kernels = C.generate(tr, fz, cfg, torch.from_numpy(embs).cuda(), max_length=12,
                         temperature=0.0, decode_quant=quant)
    check(torch.equal(kernels, tokens), "tiny f32 one-shot generate: kernels differ from plain")
    out = {}
    for use in (None, False):
        svc = ContinuousCaptionService(model, slots=3, segment=2, bursts=2, admit=2,
                                       max_length=12, use_kernels=use)
        if quant:
            svc._packed = C.prepare_decode_weights(tr, fz, cfg, quant=True)
        check(svc.t_max == -(-(cfg.total_prefix_length + 12 + 4) // 8) * 8, "t_max not minimal")
        got = served_ids(svc, embs[:10], caps[:10])
        check(svc.step() == {}, "the drained pool still emitted")
        got += served_ids(svc, embs[10:], caps[10:])  # pool reuse
        torch.cuda.synchronize()
        check(got == want, f"tiny f32 continuous captions (kernels {use is None}) differ from "
                           f"one-shot generate:\n{got}\n{want}")
        out["kernels" if use is None else "plain"] = svc.stats["macros"]
    return {"phase": "tiny_f32_exact_continuous" + ("_int8" if quant else ""),
            "eos": cfg.eos_token_id, "requests": 12, "captions_equal_one_shot": True,
            "macros": out, "slots": 3}


def plain_logits_along(model, emb: torch.Tensor, tokens: torch.Tensor, quant: bool = False,
                       quant_cache: bool = False, precision: str = "bf16"):
    """Feed ``tokens`` (B, L) through the plain path step by step, from the
    bf16 weights (``quant``: their W8A8 pack; ``quant_cache``: the int8 KV
    cache; ``precision="f32"``: the float32 weights): yields (step s, the
    plain float32 logits (B, V) that predict token s, the rows that had not
    emitted EOS before s).

    The bf16 reference is the plain path of ``generate(use_kernels=False)``:
    the plain mapper and the prefill kernel's twin.  The int8 reference
    starts from the kernels' mapper and prefill as the int8 decode runs them
    (flash attention in ``forward_cached``, held to the plain path by the
    bf16 phases) and runs every int8 decode step in the twins.  From the plain prefill, the bf16
    rounding of the prefill's attention moves activations across
    quantization steps, and the int8 steps carry that as a drift of their
    own (worst teacher-forced deficit 0.05-0.07 against 0.01-0.03 from the
    kernels' prefill, PERF.md §6), which is not the decode kernels'."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    cfg = model.cfg
    tr, fz, pol = model.decode_params(precision)
    gpt = C._gpt(tr, fz)
    packed = C.prepare_decode_weights(tr, fz, cfg, pol, quant=quant)
    vocab_kw = {"wte_scale": packed["wtes"], "compute_dtype": pol.compute_dtype} if quant else {}
    eos, eps = cfg.eos_token_id, cfg.gpt2.layer_norm_epsilon
    prefill_kernels = None if quant else False
    prefix = C.build_prefix(tr, cfg, emb, pol, use_kernels=prefill_kernels)
    b, p_len, _ = prefix.shape
    cache = G.init_cache(cfg.gpt2, b, p_len + tokens.shape[1], dtype=pol.compute_dtype,
                         device="cuda")
    logits, cache = C.prefill(gpt, cfg, prefix, cache, pol, packed, prefill_kernels is None)
    k, v, scales = cache["k"], cache["v"], {}
    if quant_cache:
        k, v, ks, vs = DS.quantize_cache(k, v)
        scales = {"k_scale": ks, "v_scale": vs}
    alive = torch.ones(b, dtype=torch.bool, device="cuda")
    idx = cache["index"]
    for s in range(tokens.shape[1]):
        if s > 0:
            x0 = (gpt["wte"][tokens[:, s - 1].long()] + gpt["wpe"][idx]).to(pol.compute_dtype)
            x32 = DS.decode_layers(packed, x0, k, v, idx, n_head=cfg.gpt2.n_head, eps=eps,
                                   use_kernels=False, **scales)
            logits = DS.logits_plain(x32, packed["lnf"], packed["wte"], eps, **vocab_kw)
            idx += 1
        yield s, logits, alive
        alive = alive & (tokens[:, s] != eos)
        if not bool(alive.any()):
            return


def teacher_forced(model, emb: torch.Tensor, tokens: torch.Tensor,
                   **quant) -> tuple[float, int, float]:
    """Greedy: (worst deficit of a chosen token's plain logit below the plain
    max, tokens checked, share of them that are the plain argmax); ``quant``
    (and ``precision``) as in :func:`plain_logits_along`."""
    worst, n, agree = 0.0, 0, 0
    for s, logits, alive in plain_logits_along(model, emb, tokens, **quant):
        chosen = logits.gather(1, tokens[:, s].long()[:, None])[:, 0]
        deficit = (logits.max(dim=-1).values - chosen)[alive]
        worst = max(worst, float(deficit.max()))
        agree += int((deficit == 0).sum())
        n += int(alive.sum())
    return worst, n, agree / n


def nucleus_mass(model, emb: torch.Tensor, tokens: torch.Tensor, temperature: float,
                 **quant) -> tuple[float, int, float]:
    """Sampled: (the largest plain-path probability mass strictly above a
    drawn token's logit, tokens checked, share of them that are the plain
    argmax)."""
    worst, n, top1 = 0.0, 0, 0
    for s, logits, alive in plain_logits_along(model, emb, tokens, **quant):
        lg = logits / temperature
        chosen = lg.gather(1, tokens[:, s].long()[:, None])
        above = torch.where(lg > chosen, torch.softmax(lg, dim=-1), 0.0).sum(dim=-1)[alive]
        worst = max(worst, float(above.max()))
        top1 += int((lg.argmax(dim=-1) == tokens[:, s])[alive].sum())
        n += int(alive.sum())
    return worst, n, top1 / n


def plain_scores(model, emb: torch.Tensor, tokens: torch.Tensor, length_penalty: float,
                 **quant) -> torch.Tensor:
    """Beam: each caption's length-normalised score under the plain path,
    sum log-prob / length ** length_penalty, the length counting tokens up to
    and including EOS (beam_generate's own score)."""
    total = torch.zeros(tokens.shape[0], dtype=torch.float32, device="cuda")
    for s, logits, alive in plain_logits_along(model, emb, tokens, **quant):
        lp = torch.log_softmax(logits, dim=-1).gather(1, tokens[:, s].long()[:, None])[:, 0]
        total += torch.where(alive, lp, 0.0)
    is_eos = tokens == model.cfg.eos_token_id
    length = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, tokens.shape[1])
    return total / length.float() ** length_penalty


def one_step_drift(model, emb: torch.Tensor, quant: bool = False,
                   precision: str = "bf16") -> float:
    """Max |logit| difference of one decode step run by the kernels and by
    the plain twins from the same prefilled cache and input (``quant``: the
    W8A8 pack; ``precision="f32"``: the float32 weights)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    cfg = model.cfg
    tr, fz, pol = model.decode_params(precision)
    gpt = C._gpt(tr, fz)
    packed = C.prepare_decode_weights(tr, fz, cfg, pol, quant=quant)
    vocab_kw = {"wte_scale": packed["wtes"], "compute_dtype": pol.compute_dtype} if quant else {}
    prefix = C.build_prefix(tr, cfg, emb, pol, use_kernels=False)
    cache = G.init_cache(cfg.gpt2, prefix.shape[0], prefix.shape[1] + 50,
                         dtype=pol.compute_dtype, device="cuda")
    logits, cache = G.forward_cached(gpt, cfg.gpt2, prefix, cache, pol, use_kernels=False)
    idx = cache["index"]
    x0 = (gpt["wte"][logits.argmax(-1)] + gpt["wpe"][idx]).to(pol.compute_dtype)
    out = []
    for use in (True, False):
        k, v = cache["k"].clone(), cache["v"].clone()
        x32 = DS.decode_layers(packed, x0, k, v, idx, n_head=cfg.gpt2.n_head,
                               eps=cfg.gpt2.layer_norm_epsilon, use_kernels=use)
        out.append(DS.logits_plain(x32, packed["lnf"], packed["wte"], **vocab_kw))
    return float((out[0] - out[1]).abs().max())


# the decode step's kernels by their CUDA function names (csrc/*.cu): the
# layers' and, by path, the vocabulary's
LAYER_KERNELS = ("linear_wgmma_kernel", TF32_LINEAR, "decode_attention_kernel", "ln_rows_kernel",
                 "rowquant_kernel")
VOCAB_KERNELS = {"greedy": ("argmax_walk_kernel", "argmax_reduce_kernel"),
                 "sampled": ("store_walk_kernel",),
                 "beam": ("topk_walk_kernel", "topk_merge_kernel")}
# continuous serving also runs the admission's mapper (flash attention) and
# prefill (csrc/prefill.cu: its LayerNorms and products are the layers'
# ln_rows_kernel and linear_wgmma_kernel; forward_cached's flash attention
# in int8)
ADMISSION_KERNELS = ("flash_attention_kernel", "prefill_attention_kernel")
VOCAB_KERNELS.update({
    "continuous_greedy": VOCAB_KERNELS["greedy"] + ADMISSION_KERNELS,
    "continuous_sampled": VOCAB_KERNELS["sampled"] + ADMISSION_KERNELS,
    "continuous_in_kernel": ("sample_walk_kernel",) + ADMISSION_KERNELS})
# the int8 paths run the same kernels, instantiated for int8 operands
VOCAB_KERNELS.update({f"{path}_int8": names for path, names in VOCAB_KERNELS.items()})
VOCAB_KERNELS.update(greedy_int8_kv=VOCAB_KERNELS["greedy"], in_kernel_int8=("sample_walk_kernel",),
                     greedy_f32=VOCAB_KERNELS["greedy"], sampled_f32=VOCAB_KERNELS["sampled"],
                     in_kernel_f32=("sample_walk_kernel",), beam_f32=VOCAB_KERNELS["beam"])


def traced(fn, trace_name: str) -> tuple[float, list[dict], int]:
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only, so the host is
    slowed less than with CPU tracing); returns its wall seconds, the trace's
    device events (kernels, copies, memsets) and the number of launches in
    ``fn`` whose device record is missing, the trace itself written gzipped to
    ``chiprun_out/``.  CUPTI can lose the first device records of a window
    while it fetches its first activity buffer, so the window opens with a
    marker kernel (``torch.cuda._sleep``) and a pause before ``fn``; the
    marker is left out of what is returned."""
    from torch.profiler import ProfilerActivity, profile

    trace = OUT_DIR / trace_name
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    text = trace.read_text()
    with gzip.open(f"{trace}.gz", "wt") as f:  # keeps the output directory small
        f.write(text)
    trace.unlink()
    every = json.loads(text)["traceEvents"]
    events = [e for e in every
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    # fn's launches (runtime or driver API): those after the marker's synchronize
    opened = min((e["ts"] for e in every if e.get("name") == "cudaDeviceSynchronize"),
                 default=float("-inf"))
    seen = {e.get("args", {}).get("correlation") for e in events}
    dropped = sum(e.get("args", {}).get("correlation") not in seen for e in every
                  if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["ts"] > opened
                  and any(w in e["name"] for w in ("Launch", "Memcpy", "Memset")))
    events = [e for e in events if "spin_kernel" not in e["name"]]
    return wall, events, dropped


def busy_us(events: list[dict], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi) covered by at least one device event."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                   if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_request(run, path: str, steps: int) -> dict:
    """Trace one request and read the decode loop from that one trace: its
    window on the device runs from the first launch of the decode step's
    kernels to the end of the last, and its busy time is the union of every
    kernel, copy and memset in the window (the port's kernels and the torch
    ops between them: the sampling tail, the beam bookkeeping).  On a path
    that does not count its admissions, the request's prefill (whose bf16
    LayerNorms and products are the step's kernels) stays out: the window
    opens two launches of the port (the first step's LN1 and QKV) before
    its first decode attention.  ``launches_by_name``: the window's launches
    of each of the path's kernels."""
    trace_name = f"{path}_decode_trace.json"
    wall, events, dropped = traced(run, trace_name)
    names = LAYER_KERNELS + VOCAB_KERNELS[path]

    def is_port(e):
        return e["cat"] == "kernel" and any(k in e["name"] for k in names)

    ours = sorted((e for e in events if is_port(e)), key=lambda e: e["ts"])
    first = next((i for i, e in enumerate(ours) if "decode_attention_kernel" in e["name"]), None)
    if "prefill_attention_kernel" not in names and first is not None:
        ours = ours[max(0, first - 2):]
    record = {"phase": f"{path}_decode_profile", "profiled_request_s": wall,
              "trace": f"{trace_name}.gz",
              "device_events": len(events), "dropped_device_records": dropped}
    if not ours:  # CUPTI gave no device activity: nothing to read
        return {**record, "idle_share": "not measured"}
    lo = min(e["ts"] for e in ours)
    hi = max(e["ts"] + e["dur"] for e in ours)
    in_window = [e for e in events if lo <= e["ts"] < hi]
    window_s, busy_s = (hi - lo) * 1e-6, busy_us(events, lo, hi) * 1e-6
    by_name = {n: sum(e["dur"] for e in ours if n in e["name"]) * 1e-6 for n in names}
    others: dict[str, float] = {}
    for e in in_window:
        if e["cat"] == "kernel" and not is_port(e):
            others[e["name"][:100]] = others.get(e["name"][:100], 0.0) + e["dur"] * 1e-6
    return {**record, "decode_steps": steps, "decode_window_s": window_s,
            "launches_by_name": {n: sum(n in e["name"] for e in ours) for n in names},
            "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / window_s,
            "port_kernels_s": sum(e["dur"] for e in ours) * 1e-6, "port_kernels_s_by_name": by_name,
            "other_kernels_s": sum(others.values()),
            "other_kernel_launches": sum(e["cat"] == "kernel" and not is_port(e)
                                         for e in in_window),
            "top_other_kernels_s": sorted(others.items(), key=lambda kv: -kv[1])[:8],
            "copies_s": sum(e["dur"] for e in in_window if e["cat"] != "kernel") * 1e-6,
            "events_in_window": len(in_window), "card": nvidia_smi()}


def profile_train_step(run_step, trace_name: str = "train_trace.json",
                       phase: str = "train_profile") -> dict:
    """Trace one train step: its device window (first to last device event),
    busy time (their union), idle share, kernel launches, and device time by
    kind — the flash kernel, matrix products (cuBLAS/CUTLASS kernels), the
    other kernels (elementwise, reductions, softmax), copies — and the
    kernels that take the most of it."""
    wall, events, dropped = traced(run_step, trace_name)
    record = {"phase": phase, "profiled_step_s": wall, "trace": f"{trace_name}.gz",
              "device_events": len(events), "dropped_device_records": dropped}
    if not events:
        return {**record, "idle_share": "not measured"}
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = busy_us(events, lo, hi)

    def kind(e):
        name = e["name"].lower()
        if e["cat"] != "kernel":
            return "copies"
        if "flash_attention_kernel" in name:
            return "flash_attention"
        if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
            return "matmul"
        return "other_kernels"

    by_kind, by_name = {}, {}
    for e in events:
        by_kind[kind(e)] = by_kind.get(kind(e), 0.0) + e["dur"] * 1e-6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {**record, "device_window_s": (hi - lo) * 1e-6, "device_busy_s": busy * 1e-6,
            "idle_share": 1.0 - busy / (hi - lo),
            "kernel_launches": sum(e["cat"] == "kernel" for e in events),
            "device_s_by_kind": by_kind, "top_kernels_s": [[n[:120], t] for n, t in top],
            "card": nvidia_smi()}


def decode_window(run) -> float:
    """Seconds on the device from the start of the first decode step to the end
    of the last, in one request run without the profiler: CUDA events recorded
    around each ``fused_decode_step`` call (two event records per step)."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    step, marks = DS.fused_decode_step, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    DS.fused_decode_step = timed
    try:
        run()
    finally:
        DS.fused_decode_step = step
    torch.cuda.synchronize()
    return marks[0][0].elapsed_time(marks[-1][1]) * 1e-3


def profile_path(run, path: str, steps: int, seconds_per_request: float) -> dict:
    """One traced request's record, with the idle share estimated against an
    unprofiled request's window too (the tracer slows the host, which
    stretches the window but not the kernels)."""
    profiled = profile_request(run, path, steps)
    profiled["unprofiled_request_s"] = seconds_per_request
    if "device_busy_s" in profiled:
        window = decode_window(run)
        profiled["unprofiled_decode_window_s"] = window
        profiled["idle_share_est_unprofiled"] = 1.0 - profiled["device_busy_s"] / window
    return profiled


def wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches (the row
    quantizer's: its launches inside the int8 calls of the others too)."""
    from gpt2_image_captioning_tpu_torch.ops import attention as A
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
    from gpt2_image_captioning_tpu_torch.ops import patch_embed as PE
    from gpt2_image_captioning_tpu_torch.ops import prefill_step as PS
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    return {"decode_attention": DA.decode_attention_cuda, "fused_linear": DS.fused_linear_cuda,
            "logits_argmax": DS.logits_argmax_cuda, "flash_attention": A.flash_attention_cuda,
            "logits": DS.logits_cuda, "logits_topk": DS.logits_topk_cuda,
            "logits_sample": DS.logits_sample_cuda, "rowquant": Q.rowquant_cuda,
            "prefill": PS.prefill_cuda, "patch_embed": PE.patch_embed_cuda}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["decode_attention"].start_launches = 0


def read_launches() -> dict:
    """Each wrapper's launches, and decode attention's start-window launches
    (a subset of its launches) as ``decode_attention_start``."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    counts["decode_attention_start"] = wrappers()["decode_attention"].start_launches
    return counts


def run_counted(fn, reqs) -> tuple[list, float, dict]:
    """``fn`` over the requests with every launch counter set to 0 just
    before and read just after: (outputs, host seconds, launches)."""
    reset_launches()
    t0 = time.perf_counter()
    outs = [fn(r) for r in reqs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return outs, seconds, read_launches()


def rowquant_per_step(n_layer: int, quant: bool) -> int:
    """Row quantizer launches of one decode step: W8A8 quantizes the rows
    that carry a LayerNorm in a launch of their own — LN1 -> qkv, LN2 -> fc
    and LN_f -> the vocabulary; the attention output -> proj and gelu(h) ->
    cproj are quantized inside their product's launch, and the int8 cache's
    new K and V rows inside decode attention's, so they add none."""
    return (2 * n_layer + 1) * quant


def check_decode_launches(launches: dict, vocab_kernel: str, steps: int, requests: int, cfg,
                          quant: bool = False, images: bool = False,
                          long_prefix: bool = False) -> None:
    """Each request ran the mapper's flash attention once a mapper layer and
    the prefill kernel once — with an int8 pack, or a prefix longer than the
    prefill kernel's (``long_prefix``), ``forward_cached``'s flash attention
    once a GPT-2 layer instead — and, fed by ``images``, the
    patch-embed kernel once and the CLIP tower's flash attention once a
    tower layer; each decode step launched the layers' kernels once a layer
    and this path's vocabulary kernel once, and the row quantizer as its
    int8 modes need; the other vocabulary kernels never ran."""
    n_layer = cfg.gpt2.n_layer
    mapper_layers = getattr(cfg.mapping, "num_layers", 0)  # the MLP mapper runs no attention
    eager = quant or long_prefix  # the prefill runs gpt2.forward_cached
    flash_per_request = (mapper_layers + n_layer * eager
                         + images * CLIP_LAYERS)
    want = {"flash_attention": flash_per_request * requests, "decode_attention": n_layer * steps,
            "prefill": (not eager) * requests, "patch_embed": images * requests,
            "fused_linear": 4 * n_layer * steps, "logits_argmax": 0, "logits": 0,
            "logits_topk": 0, "logits_sample": 0, "decode_attention_start": 0,
            "rowquant": rowquant_per_step(n_layer, quant) * steps}
    want[vocab_kernel] = steps
    check(launches == want, f"launches {launches} != {want} ({steps} decode steps)")


def serving_model():
    """GPT-2 124M + the transformer mapper of config.yml, random weights from
    a seed, and three requests of 128 image embeddings."""
    from gpt2_image_captioning_tpu_torch import (
        CaptionerConfig, GPT2Config, ImageCaptioningModel, TransformerMappingConfig,
    )
    cfg = CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                          mapping=TransformerMappingConfig(512, 768, 15, 10))
    model = ImageCaptioningModel(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    return model, [rng.normal(size=(B, 512)).astype(np.float32) for _ in range(3)]


MODEL_NAME = "GPT-2 124M + transformer mapper (512->768, 15+10)"
# A prefix past the prefill kernel's MAX_PREFIX (32): every decode prefills
# it through gpt2.forward_cached, as the JAX package does (flash attention,
# causal at Tq = Tk = 40, once a GPT-2 layer; the mapper's at T 50)
LONG_PREFIX = 40


def long_prefix_path() -> tuple[dict, dict]:
    """One greedy request of B embeddings to GPT-2 124M behind a transformer
    mapper whose prefix is LONG_PREFIX tokens (random weights from a seed),
    bf16 and float32, each with the kernels and with ``use_kernels=False`` in
    this call: the launches counted (no prefill kernel; flash attention 8 +
    12 times), every token teacher-forced against the plain path, and the
    rows equal to the plain path's counted."""
    from gpt2_image_captioning_tpu_torch import (
        CaptionerConfig, GPT2Config, ImageCaptioningModel, TransformerMappingConfig,
    )
    cfg = CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                          mapping=TransformerMappingConfig(512, 768, LONG_PREFIX, 10))
    model = ImageCaptioningModel(cfg, generator=torch.Generator().manual_seed(1), device="cuda")
    emb = np.random.default_rng(2).normal(size=(B, 512)).astype(np.float32)
    record = {"phase": "long_prefix_path", "prefix_tokens": LONG_PREFIX, "batch": B,
              "model": f"GPT-2 124M + transformer mapper (512->768, {LONG_PREFIX}+10)"}
    counts = {}
    for precision in ("bf16", "f32"):
        def run(r, use=None, precision=precision):
            return model.generate(r, max_length=50, temperature=0.0, decode_precision=precision,
                                  use_kernels=use)
        run(emb)
        run(emb, use=False)
        torch.cuda.synchronize()
        outs, seconds, launches = run_counted(run, [emb])
        steps = decode_steps(outs[0], cfg.eos_token_id)
        check_decode_launches(launches, "logits_argmax", steps, 1, cfg, long_prefix=True)
        check_padding(outs[0], cfg.eos_token_id, cfg.gpt2.vocab_size)
        t0 = time.perf_counter()
        plain = run(emb, use=False)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        worst, checked, agree = teacher_forced(model, torch.from_numpy(emb).cuda(), outs[0],
                                               precision=precision)
        tol = TF_TOL_F32 if precision == "f32" else TF_TOL
        check(worst <= tol, f"long prefix ({precision}): a chosen token is {worst} below the "
                            f"plain max (tolerance {tol})")
        counts[f"long_prefix_{precision}"] = launches
        record[precision] = {
            "seconds_kernels": seconds, "seconds_plain": plain_seconds, "decode_steps": steps,
            "launches": launches,
            "rows_identical_to_plain": int((outs[0] == plain).all(dim=1).sum()), "rows": B,
            "teacher_forced": {"worst_deficit": worst, "tolerance": tol, "tokens_checked": checked,
                               "share_plain_argmax": agree}}
    record["card"] = nvidia_smi()
    del model
    torch.cuda.empty_cache()
    return record, counts


def module_decoder(model, precision: str, **kw):
    """Module-level ``generate`` on the façade's weights at ``precision``
    (f32; or int8: the bf16 copy through its W8A8 pack), for the options the
    façade does not take (the int8 cache, the in-kernel draw):
    ``run(embeddings, use_kernels)``."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    quant = precision == "int8"
    tr, fz, pol = model.decode_params("bf16" if quant else precision)
    packed = C.prepare_decode_weights(tr, fz, model.cfg, pol, quant=quant)

    def run(r, use=None):
        return C.generate(tr, fz, model.cfg, torch.as_tensor(r, device="cuda"), max_length=50,
                          policy=pol, packed=packed, decode_quant=quant, use_kernels=use, **kw)

    return run


def greedy_path(model, reqs, precision: str = "bf16",
                quant_cache: bool = False) -> tuple[dict, dict, dict]:
    """Greedy serving, 50 tokens: ``ImageCaptioningModel.generate`` at
    ``precision`` (bf16; f32, the façade's default; or int8: W8A8 from the
    bf16 copy), or with ``quant_cache`` module-level ``generate(decode_quant
    =True, decode_quant_cache=True)`` on the same weights; the kernels, then
    ``use_kernels=False``, in this call.  Every token is teacher-forced
    against the plain path (float32: to TF_TOL_F32); one traced request
    gives the device time a step."""
    cfg = model.cfg
    quant, f32 = precision == "int8", precision == "f32"
    if quant_cache:
        run = module_decoder(model, "int8", temperature=0.0, decode_quant_cache=True)
        path = "greedy_int8_kv"
    else:
        def run(r, use=None):
            return model.generate(r, max_length=50, temperature=0.0, decode_precision=precision,
                                  use_kernels=use)
        path = {"int8": "greedy_int8", "f32": "greedy_f32"}.get(precision, "greedy")
    run(reqs[0])  # warm-up of both routes: weight copies, packing, first launches
    run(reqs[0], use=False)
    torch.cuda.synchronize()
    outs, seconds, launches = run_counted(run, reqs)
    steps = sum(decode_steps(o, cfg.eos_token_id) for o in outs)
    check_decode_launches(launches, "logits_argmax", steps, len(reqs), cfg, quant)
    for o in outs:
        check(tuple(o.shape) == (B, 50) and o.dtype == torch.int32, f"bad output {o.shape}")
        check_padding(o, cfg.eos_token_id, cfg.gpt2.vocab_size)

    t0 = time.perf_counter()
    plain = [run(r, use=False) for r in reqs]
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    same = sum(int((a == b).all(dim=1).sum()) for a, b in zip(outs, plain))

    weights = "f32" if f32 else "bf16"
    drift = one_step_drift(model, torch.from_numpy(reqs[0]).cuda(), quant, precision=weights)
    worst, checked, agree = 0.0, 0, 0.0
    for r, o in zip(reqs, outs):
        w, n, a = teacher_forced(model, torch.from_numpy(r).cuda(), o, quant=quant,
                                 quant_cache=quant_cache, precision=weights)
        worst, checked, agree = max(worst, w), checked + n, agree + a * n
    tol = TF_TOL_F32 if f32 else TF_TOL
    check(worst <= tol, f"teacher-forced ({path}): a chosen token is {worst} below the plain "
                        f"max (tolerance {tol})")
    record = {
        "phase": "main_path" if path == "greedy" else f"{path}_path", "model": MODEL_NAME,
        "dtype": "float32 (the façade's default)" if f32 else
                 "bf16" + (", W8A8" if quant else "") + (", int8 KV cache" if quant_cache else ""),
        "requests": len(reqs), "batch": B, "max_length": 50,
        "decode_steps": steps, "launches": launches,
        "img_per_s_kernels": len(reqs) * B / seconds, "seconds_kernels": seconds,
        "img_per_s_plain": len(reqs) * B / plain_seconds, "seconds_plain": plain_seconds,
        "rows_identical_to_plain": same, "rows": len(reqs) * B,
        "one_step_logit_drift": drift,
        "teacher_forced": {"worst_deficit": worst, "tolerance": tol, "tokens_checked": checked,
                           "share_plain_argmax": agree / checked},
        "card": nvidia_smi(),
    }
    steps0 = decode_steps(outs[0], cfg.eos_token_id)
    profiled = profile_path(lambda: run(reqs[0]), path, steps0, seconds / len(reqs))
    if "device_busy_s" in profiled:
        profiled["device_ms_per_step"] = 1e3 * profiled["device_busy_s"] / steps0
        if f32:  # the layers' products on the TF32 instantiation, by name in the trace
            per_step = profiled["launches_by_name"][TF32_LINEAR] / steps0
            profiled["tf32_product_launches_per_step"] = per_step
            check(per_step > 0, f"{path}: no {TF32_LINEAR}> launch in the decode window")
        # the standalone quantizer's launches, counted by name in the trace
        per_step = profiled["launches_by_name"]["rowquant_kernel"] / steps0
        profiled["rowquant_launches_per_step"] = per_step
        check(per_step <= rowquant_per_step(cfg.gpt2.n_layer, quant),
              f"{path}: {per_step} row quantizer launches a step in the trace")
    return record, launches, profiled


def sampled_path(model, reqs, precision: str = "bf16",
                 in_kernel: bool = False) -> tuple[dict, dict, dict]:
    """Top-p sampling through the façade at its defaults (temperature 1.0,
    top_p 0.9, a generator seeded with 0 per call), 50 tokens, at
    ``precision`` (bf16; f32, the façade's default; or int8); ``in_kernel``
    (f32 or int8): module-level ``generate(sample_in_kernel=True)`` on the
    same weights, the draw inside the step."""
    cfg = model.cfg
    quant, f32 = precision == "int8", precision == "f32"
    suffix = {"int8": "_int8", "f32": "_f32"}.get(precision, "")
    if in_kernel:
        run = module_decoder(model, precision, temperature=1.0, top_p=TOP_P,
                             sample_in_kernel=True)
        path, vocab = "in_kernel" + suffix, "logits_sample"
    else:
        def run(r, use=None):
            return model.generate(r, max_length=50, decode_precision=precision, use_kernels=use)
        path, vocab = "sampled" + suffix, "logits"
    run(reqs[0])  # warm-up
    torch.cuda.synchronize()
    outs, seconds, launches = run_counted(run, reqs)
    steps = sum(decode_steps(o, cfg.eos_token_id) for o in outs)
    check_decode_launches(launches, vocab, steps, len(reqs), cfg, quant)
    for o in outs:
        check(tuple(o.shape) == (B, 50) and o.dtype == torch.int32, f"bad output {o.shape}")
        check_padding(o, cfg.eos_token_id, cfg.gpt2.vocab_size)

    t0 = time.perf_counter()
    plain = [run(r, use=False) for r in reqs]
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0

    worst, checked, top1 = 0.0, 0, 0.0
    for r, o in zip(reqs, outs):
        w, n, t1 = nucleus_mass(model, torch.from_numpy(r).cuda(), o, 1.0, quant=quant,
                                precision="f32" if f32 else "bf16")
        worst, checked, top1 = max(worst, w), checked + n, top1 + t1 * n
    slack = NUCLEUS_SLACK_INT8 if quant else NUCLEUS_SLACK
    check(worst <= TOP_P + slack,
          f"a drawn token has plain mass {worst} above it (top_p {TOP_P} + {slack})")
    record = {
        "phase": f"{path}_path", "model": MODEL_NAME,
        "dtype": "float32 (the façade's default)" if f32 else "bf16" + (", W8A8" if quant else ""),
        "temperature": 1.0, "top_p": TOP_P, "requests": len(reqs), "batch": B, "max_length": 50,
        "decode_steps": steps, "launches": launches,
        "img_per_s_kernels": len(reqs) * B / seconds, "seconds_kernels": seconds,
        "img_per_s_plain": len(reqs) * B / plain_seconds, "seconds_plain": plain_seconds,
        "rows_identical_to_plain": sum(int((a == b).all(dim=1).sum()) for a, b in zip(outs, plain)),
        "rows": len(reqs) * B,
        "nucleus": {"worst_mass_above": worst, "limit": TOP_P + slack,
                    "tokens_checked": checked, "share_plain_argmax": top1 / checked},
        "card": nvidia_smi(),
    }
    steps0 = decode_steps(outs[0], cfg.eos_token_id)
    profiled = profile_path(lambda: run(reqs[0]), path, steps0, seconds / len(reqs))
    if "device_busy_s" in profiled:
        profiled["device_ms_per_step"] = 1e3 * profiled["device_busy_s"] / steps0
    return record, launches, profiled


def beam_f32(model, emb: torch.Tensor, length_penalty: float) -> dict:
    """Beam search in float32 at full width: the kernels' captions against
    the plain path's, of which BEAM_F32_PARTED may part at near-ties."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    tr, fz, pol = model.decode_params("f32")
    packed = C.prepare_decode_weights(tr, fz, model.cfg, pol)

    def run(use):
        return C.beam_generate(tr, fz, model.cfg, emb, max_length=50, beam_size=BEAM_K,
                               length_penalty=length_penalty, policy=pol, packed=packed,
                               use_kernels=use)

    reset_launches()
    got = run(None)
    torch.cuda.synchronize()
    launches = read_launches()
    want = run(False)
    n = emb.shape[0]
    same = int((got == want).all(dim=1).sum())
    check(n - same <= BEAM_F32_PARTED, f"float32 beams: {same} of {n} captions equal the plain path's")
    return {"images": n, "captions_identical": same, "parted_allowed": BEAM_F32_PARTED,
            "launches": launches}


def beam_f32_path(model, reqs, length_penalty: float = 1.0) -> tuple[dict, dict, dict]:
    """Beam search in float32, the façade's default precision: 4 beams on
    each request's 128 images (512 decode rows), 50 tokens, through
    ``beam_generate`` with the kernels; launches checked, img/s, and one
    traced request for the device time a step (``beam_f32`` holds the
    captions to the plain path's)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg = model.cfg
    tr, fz, pol = model.decode_params("f32")
    packed = C.prepare_decode_weights(tr, fz, cfg, pol)
    embs = [torch.from_numpy(r).cuda() for r in reqs]

    def run(emb):
        return C.beam_generate(tr, fz, cfg, emb, max_length=50, beam_size=BEAM_K,
                               length_penalty=length_penalty, policy=pol, packed=packed)

    run(embs[0])  # warm-up
    torch.cuda.synchronize()
    outs, seconds, launches = run_counted(run, embs)
    steps = 49 * len(reqs)  # a fixed 50 selections; the last one's forward is skipped
    check_decode_launches(launches, "logits_topk", steps, len(reqs), cfg)
    for o in outs:
        check(tuple(o.shape) == (B, 50) and o.dtype == torch.int32, f"bad output {o.shape}")
        check_padding(o, cfg.eos_token_id, cfg.gpt2.vocab_size)
    record = {"phase": "beam_f32_path", "model": MODEL_NAME,
              "dtype": "float32 (the façade's default)", "beam_size": BEAM_K,
              "length_penalty": length_penalty, "requests": len(reqs), "images": B,
              "decode_rows": B_BEAM, "max_length": 50, "decode_steps": steps,
              "launches": launches, "img_per_s_kernels": len(reqs) * B / seconds,
              "seconds_kernels": seconds, "card": nvidia_smi()}
    profiled = profile_path(lambda: run(embs[0]), "beam_f32", 49, seconds / len(reqs))
    if "device_busy_s" in profiled:
        profiled["device_ms_per_step"] = 1e3 * profiled["device_busy_s"] / 49
    return record, launches, profiled


def beam_path(model, reqs, length_penalty: float = 1.0,
              quant: bool = False) -> tuple[dict, dict, dict]:
    """Beam search, 4 beams on each request's 128 images (512 decode rows),
    bf16, 50 tokens, through ``beam_generate`` on the façade's bf16 weights
    (``quant``: ``decode_quant=True``, their W8A8 pack)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg = model.cfg
    tr, fz, pol = model.decode_params("bf16")
    packed = C.prepare_decode_weights(tr, fz, cfg, pol, quant=quant)
    embs = [torch.from_numpy(r).cuda() for r in reqs]

    def run(emb, use=None):
        return C.beam_generate(tr, fz, cfg, emb, max_length=50, beam_size=BEAM_K,
                               length_penalty=length_penalty, policy=pol, packed=packed,
                               use_kernels=use, decode_quant=quant)

    run(embs[0])  # warm-up
    torch.cuda.synchronize()
    outs, seconds, launches = run_counted(run, embs)
    steps = 49 * len(reqs)  # a fixed 50 selections; the last one's forward is skipped
    check_decode_launches(launches, "logits_topk", steps, len(reqs), cfg, quant)
    for o in outs:
        check(tuple(o.shape) == (B, 50) and o.dtype == torch.int32, f"bad output {o.shape}")
        check_padding(o, cfg.eos_token_id, cfg.gpt2.vocab_size)

    t0 = time.perf_counter()
    plain = [run(e, use=False) for e in embs]
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0

    score_err, shortfall, same, parted_at = 0.0, [], 0, {}
    for e, o, p in zip(embs, outs, plain):
        beams = C._beam_search(tr, fz, cfg, e, max_length=50, beam_size=BEAM_K, policy=pol,
                               use_kernels=None, packed=packed, decode_quant=quant)
        best, searched = C._best_beam(*beams, length_penalty=length_penalty)
        check(torch.equal(best, o), "the kernels' search is not deterministic")
        sk = plain_scores(model, e, o, length_penalty, quant=quant)
        score_err = max(score_err, float((searched - sk).abs().max()))
        shortfall.append(plain_scores(model, e, p, length_penalty, quant=quant) - sk)
        same += int((o == p).all(dim=1).sum())
        # where the two searches' chosen captions first differ, by position
        differs = o != p
        for pos in differs.int().argmax(dim=1)[differs.any(dim=1)].tolist():
            parted_at[pos] = parted_at.get(pos, 0) + 1
    shortfall = torch.cat(shortfall)
    check(score_err <= BEAM_SCORE_TOL, f"the kernels' search scored a caption {score_err} away "
                                       f"from the plain path's score (tolerance {BEAM_SCORE_TOL})")
    mean_short = float(shortfall.mean())
    check(mean_short <= BEAM_MEAN_TOL, f"the kernels' captions score {mean_short} below the plain "
                                       f"path's on average (tolerance {BEAM_MEAN_TOL})")
    # float32 at full width (the float kernels; tiny_exact holds the int8 ones in float32)
    f32 = None if quant else beam_f32(model, embs[0][:BEAM_F32_IMAGES], length_penalty)
    record = {
        "phase": "beam_int8_path" if quant else "beam_path", "model": MODEL_NAME,
        "dtype": "bf16, W8A8" if quant else "bf16", "beam_size": BEAM_K,
        "length_penalty": length_penalty, "requests": len(reqs), "images": B,
        "decode_rows": B_BEAM, "max_length": 50, "decode_steps": steps, "launches": launches,
        "img_per_s_kernels": len(reqs) * B / seconds, "seconds_kernels": seconds,
        "img_per_s_plain": len(reqs) * B / plain_seconds, "seconds_plain": plain_seconds,
        "captions_identical_to_plain": same, "captions": len(reqs) * B,
        "first_differing_position": dict(sorted(parted_at.items())),
        "search_score_vs_plain": {"max_abs_err": score_err, "tolerance": BEAM_SCORE_TOL},
        "shortfall_vs_plain_best": {"mean": mean_short, "tolerance_mean": BEAM_MEAN_TOL,
                                    "max": float(shortfall.max()), "min": float(shortfall.min()),
                                    "images_over_0.05": int((shortfall > 0.05).sum())},
        "float32": f32, "card": nvidia_smi(),
    }
    profiled = profile_path(lambda: run(embs[0]), "beam_int8" if quant else "beam", 49,
                            seconds / len(reqs))
    return record, launches, profiled


# ---------------------------------------------------------------------------
# Continuous serving at full width
# ---------------------------------------------------------------------------

def counting_macros(fn):
    """Run ``fn()`` with ``macro_step`` recording each call's staged count;
    returns (fn's result, the counts)."""
    from gpt2_image_captioning_tpu_torch.models import continuous as CE

    macro, staged = CE.macro_step, []

    def counted(*args, **kwargs):
        staged.append(args[7])  # n_q
        return macro(*args, **kwargs)

    CE.macro_step = counted
    try:
        return fn(), staged
    finally:
        CE.macro_step = macro


def served_matrix(ids, caps, eos: int):
    """Each request's generated tokens (its caption's ids, then the EOS that
    ended it unless its cap did) as an EOS-padded (N, 50) matrix, and their
    counts."""
    n_gen = [len(r) + (len(r) < int(c)) for r, c in zip(ids, caps)]
    tokens = torch.full((len(ids), CONTINUOUS["max_length"]), eos, dtype=torch.int32)
    for i, r in enumerate(ids):
        tokens[i, : len(r)] = torch.tensor(r, dtype=torch.int32)
    return tokens.cuda(), torch.tensor(n_gen, device="cuda")


def check_served_tokens(model, embs, tokens, n_gen, sampled: bool, quant: bool = False) -> dict:
    """Teacher-forced along each request's generated tokens on the plain
    path (``quant``: W8A8), in blocks of 256 requests: greedy, each token's
    plain logit within TF_TOL (int8: TF_TOL_INT8_SERVED) of the plain max,
    and the tokens above TF_TOL counted; sampled (temperature 1.0), the plain
    mass strictly above each token <= TOP_P + NUCLEUS_SLACK."""
    worst, checked, hits, over = (-1.0 if sampled else 0.0), 0, 0, 0
    for c0 in range(0, len(embs), 256):
        emb = torch.from_numpy(embs[c0 : c0 + 256]).cuda()
        tok, ng = tokens[c0 : c0 + 256], n_gen[c0 : c0 + 256]
        for s, logits, alive in plain_logits_along(model, emb, tok, quant=quant):
            live = alive & (s < ng)
            if not bool(live.any()):
                continue
            chosen = logits.gather(1, tok[:, s].long()[:, None])
            if sampled:
                above = torch.where(logits > chosen, torch.softmax(logits, dim=-1), 0.0).sum(-1)
                worst = max(worst, float(above[live].max()))
            else:
                deficit = (logits.max(dim=-1).values - chosen[:, 0])[live]
                worst = max(worst, float(deficit.max()))
                over += int((deficit > TF_TOL).sum())
            hits += int((logits.argmax(dim=-1) == tok[:, s])[live].sum())
            checked += int(live.sum())
    if sampled:
        check(worst <= TOP_P + NUCLEUS_SLACK, f"a served token has plain mass {worst} above it")
        return {"worst_mass_above": worst, "limit": TOP_P + NUCLEUS_SLACK,
                "tokens_checked": checked, "share_plain_argmax": hits / checked}
    tol = TF_TOL_INT8_SERVED if quant else TF_TOL
    check(worst <= tol, f"a served greedy token is {worst} below the plain max ({over} of "
                        f"{checked} above {TF_TOL}, {hits / checked} the plain argmax)")
    return {"worst_deficit": worst, "tolerance": tol, "tokens_checked": checked,
            f"tokens_over_{TF_TOL}": over, "share_plain_argmax": hits / checked}


def continuous_path(model, mode: str, embs: np.ndarray, caps: np.ndarray,
                    precision: str = "bf16"):
    """``ContinuousCaptionService`` at full width: 512 slots, segment 4, 8
    bursts, 32 admissions, 50 tokens, at ``precision`` (bf16, or int8: W8A8
    from the bf16 copy), all requests submitted up front; ``mode`` greedy,
    sampled on the logits tail or sampled in the kernel (temperature 1.0,
    top_p 0.9)."""
    from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService

    cfg, eos = model.cfg, model.cfg.eos_token_id
    quant = precision == "int8"
    name = f"continuous_{mode}" + ("_int8" if quant else "")
    kw = dict(CONTINUOUS, decode_precision=precision, seed=0, **CONTINUOUS_MODES[mode])
    served_ids(ContinuousCaptionService(model, **kw), embs[:64], np.full(64, 8))  # warm-up
    svc = ContinuousCaptionService(model, **kw)
    check(len(embs) >= svc.recommended_inflight(), "fewer requests than recommended_inflight()")
    reset_launches()
    t0 = time.perf_counter()
    ids, staged = counting_macros(lambda: served_ids(svc, embs, caps))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    per_macro = CONTINUOUS["bursts"] * CONTINUOUS["segment"]
    steps = per_macro * len(staged)
    prefills = CONTINUOUS["bursts"] * sum(n > 0 for n in staged)
    n_layer = cfg.gpt2.n_layer
    vocab = {"greedy": "logits_argmax", "sampled": "logits", "in_kernel": "logits_sample"}[mode]
    want = {"flash_attention": (cfg.mapping.num_layers + n_layer * quant) * prefills,
            "prefill": (not quant) * prefills, "patch_embed": 0,
            "decode_attention": n_layer * steps, "decode_attention_start": n_layer * steps,
            "fused_linear": 4 * n_layer * steps, "logits_argmax": 0, "logits": 0,
            "logits_topk": 0, "logits_sample": 0,
            "rowquant": rowquant_per_step(n_layer, quant) * steps}
    want[vocab] = steps
    check(launches == want, f"{name}: launches {launches} != {want}")
    for r, c in zip(ids, caps):
        check(len(r) <= c and all(0 <= t < eos for t in r), "a served caption breaks its cap")
    tokens, n_gen = served_matrix(ids, caps, eos)
    checked = check_served_tokens(model, embs, tokens, n_gen, sampled=mode != "greedy",
                                  quant=quant)
    stats = svc.stats
    record = {
        "phase": name, "model": MODEL_NAME, "dtype": "bf16" + (", W8A8" if quant else ""),
        **CONTINUOUS,
        **CONTINUOUS_MODES[mode], "requests": len(embs), "caps": [int(caps.min()), int(caps.max())],
        "recommended_inflight": svc.recommended_inflight(), "seconds": seconds,
        "requests_per_s": len(embs) / seconds, "tokens_per_s": int(n_gen.sum()) / seconds,
        "tokens": int(n_gen.sum()), "occupancy": stats["occupancy"],
        "latency_p50_s": stats["latency_p50_s"], "latency_p95_s": stats["latency_p95_s"],
        "macros": stats["macros"], "decode_steps": steps, "admission_prefills": prefills,
        # admission caps the pool: at most admit / segment requests join a
        # step, each staying for its caption's length
        "admission_bound_occupancy": min(1.0, CONTINUOUS["admit"] / CONTINUOUS["segment"]
                                         * float(n_gen.float().mean()) / B_SERVE),
        "host_reads_per_macro": stats["host_reads"] / stats["macros"],
        "output_fetches_per_macro": 1,
        "dispatch_s": stats["dispatch_s"], "sync_s": stats["sync_s"], "host_s": stats["host_s"],
        "launches": launches, "checked": checked, "card": nvidia_smi(),
    }
    if mode == "greedy":  # against one-shot generate on the same embeddings
        one_shot = []
        for c0 in range(0, len(embs), B_SERVE):
            out = model.generate(embs[c0 : c0 + B_SERVE], max_length=50, temperature=0.0,
                                 decode_precision=precision)
            one_shot += one_shot_ids(out, caps[c0 : c0 + B_SERVE], eos)
        record["identical_to_one_shot_generate"] = sum(a == b for a, b in zip(ids, one_shot)) / len(ids)
    # one more run of a pool's worth of requests, traced, for the device's idle share
    traced_svc = ContinuousCaptionService(model, **kw)
    profiled, traced_staged = counting_macros(
        lambda: profile_request(lambda: served_ids(traced_svc, embs[:B_SERVE], caps[:B_SERVE]),
                                name, 0))
    profiled.update(decode_steps=per_macro * len(traced_staged), requests=B_SERVE)
    return record, launches, profiled


# ---------------------------------------------------------------------------
# Phase 6: the train step
# ---------------------------------------------------------------------------

class Captions:
    """An in-memory caption set as ``CocoDataset._materialize`` builds one:
    captions of 8-20 random tokens + EOS, padded to ``length`` with EOS ids,
    -100 labels and mask 0 on the padding; one N(0, 1) image embedding per
    caption."""

    def __init__(self, n: int, length: int, eos: int, embed_dim: int, seed: int):
        rng = np.random.default_rng(seed)
        lens = rng.integers(8, 21, size=n) + 1
        pos = np.arange(length)[None, :]
        tokens = rng.integers(0, eos, size=(n, length)).astype(np.int32)
        tokens[pos >= lens[:, None] - 1] = eos
        self.data = {
            "token_ids": tokens,
            "attention_mask": (pos < lens[:, None]).astype(np.int32),
            "labels": np.where(pos < lens[:, None], tokens, -100).astype(np.int32),
            "image_embedding": rng.normal(size=(n, embed_dim)).astype(np.float32),
        }

    def __len__(self) -> int:
        return len(self.data["token_ids"])

    def gather_batch(self, idx: np.ndarray) -> dict:
        return {k: v[idx] for k, v in self.data.items()}


def loss_and_grads(trainable, frozen, cfg, batch, policy):
    """Mean loss and gradients of one batch with the kernels and with
    ``use_kernels=False``, on the same weights; leaves no gradient behind."""
    from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    params = tree_leaves(trainable)
    out = []
    for use in (None, False):
        loss = C.mean_loss(trainable, frozen, cfg, batch, policy, use_kernels=use)
        loss.backward()
        out.append((float(loss.detach()), [p.grad.float() for p in params]))
        for p in params:
            p.grad = None
    return out


def tiny_f32_training() -> dict:
    """Loss and mapper gradients of the kernel path against the plain path in
    float32 at :func:`tiny_config`."""
    from gpt2_image_captioning_tpu_torch import F32
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.train import optim

    cfg = tiny_config()
    tr, fz = C.init_params(torch.Generator().manual_seed(3), cfg, device="cuda")
    optim.make_optimizer(tr, optim.AdamWConfig())  # the trainable leaves require grad
    batch = Captions(8, 24, cfg.eos_token_id, 16, seed=4).gather_batch(np.arange(8))
    (lk, gk), (lp, gp) = loss_and_grads(tr, fz, cfg, batch, F32)
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp))
    check(loss_err <= TRAIN_TOL["loss_f32"], f"tiny f32 loss: relative error {loss_err}")
    check(grad_err <= TRAIN_TOL["grad_f32"], f"tiny f32 grads: relative error {grad_err}")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "tolerance": [TRAIN_TOL["loss_f32"], TRAIN_TOL["grad_f32"]]}


def train_path() -> tuple[dict, dict, dict]:
    """The train step at full width: GPT-2 124M frozen, the transformer
    mapper trainable, bf16, AdamW lr 1e-4, b 128 captions padded to 50."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    cfg = C.CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                            mapping=TransformerMappingConfig(512, 768, 15, 10))
    tr, fz = C.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    ds = Captions(6 * B + 40, 50, cfg.eos_token_id, 512, seed=1)  # 7 batches, the last padded
    batches = list(Batcher(ds, B, seed=0).epoch(0))
    opt_cfg = optim.AdamWConfig(learning_rate=1e-4, num_training_steps=100)
    optimizer, scheduler = optim.make_optimizer(tr, opt_cfg)
    step = loop.make_train_step(cfg, opt_cfg, BF16, device="cuda")

    (lk, gk), (lp, gp) = loss_and_grads(tr, fz, cfg, batches[0], BF16)
    gk_all, gp_all = torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp])
    grad_err = float((gk_all - gp_all).norm() / gp_all.norm())
    check(abs(lk - lp) <= TRAIN_TOL["loss_bf16"], f"step-1 loss {lk} against plain {lp}")
    check(grad_err <= TRAIN_TOL["grad_bf16"], f"step-1 grads: relative error {grad_err}")

    step(tr, optimizer, scheduler, fz, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = [step(tr, optimizer, scheduler, fz, b) for b in batches[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = len(out)
    losses, norms = [float(l) for l, _ in out], [float(n) for _, n in out]
    per_step = cfg.mapping.num_layers + cfg.gpt2.n_layer
    check(launches["flash_attention"] == per_step * steps,
          f"flash launches {launches['flash_attention']} != {per_step} x {steps} steps")
    check(all(np.isfinite(losses + norms)), f"non-finite loss or norm: {losses} {norms}")

    profiled = profile_train_step(lambda: step(tr, optimizer, scheduler, fz, batches[1]))
    fixed = [float(step(tr, optimizer, scheduler, fz, batches[0])[0]) for _ in range(10)]
    check(fixed[-1] < fixed[0], f"ten steps on one batch did not lower the loss: {fixed}")
    record = {
        "phase": "train", "model": "GPT-2 124M frozen + transformer mapper (512->768, 15+10)",
        "dtype": "bf16 compute, float32 params", "batch": B, "caption_length": 50,
        "positions": 15 + 50, "timed_steps": steps, "seconds": seconds,
        "captions_per_s": B * steps / seconds, "ms_per_step": 1e3 * seconds / steps,
        "losses": losses, "grad_norms": norms, "launches": launches,
        "peak_memory_gb": peak / 1e9,
        "step1": {"loss_kernels": lk, "loss_plain": lp, "grad_rel_err": grad_err,
                  "tolerance": [TRAIN_TOL["loss_bf16"], TRAIN_TOL["grad_bf16"]]},
        "fixed_batch_losses": fixed, "tiny_f32": tiny_f32_training(), "card": nvidia_smi(),
    }
    return record, profiled, launches


# ---------------------------------------------------------------------------
# Phase 7: the epoch loop and COCO evaluation
# ---------------------------------------------------------------------------

# a synthetic COCO split each: (images, captions per image, embeddings file)
EPOCH_SPLITS = {"train": (320, 3, "pt"), "val": (256, 2, "npz")}
EPOCH_RUN = Path(__file__).resolve().parent / "chip_epochs"  # checkpoints; removed at the end
CAPTION_WORDS = (
    "a the man woman dog cat riding standing wave surfboard street red blue bus two on in "
    "with field grass playing park bench tree sky water group of people next to is are and"
).split()
EVAL_MODES = {
    "greedy": dict(temperature=0.0, decode_precision="bf16"),
    "sampled": dict(temperature=1.0, top_p=TOP_P, decode_precision="bf16"),
    "beam": dict(decode="beam", beam_size=BEAM_K, decode_precision="bf16"),
    "greedy_int8": dict(temperature=0.0, decode_precision="int8"),
}


def fabricated_tokenizer():
    """A 50,257-token byte-level BPE table, built as
    ``tests/fabricate_assets.py::fabricate_gpt2_vocab`` builds one: the 256
    byte symbols, the first 50,000 of their pairs as merges, EOS last; it
    encodes any text (the GPT-2 assets are not in the repository)."""
    from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer, bytes_to_unicode

    symbols = [bytes_to_unicode()[i] for i in range(256)]
    merges = [(a, b) for a in symbols for b in symbols][:50000]
    vocab = symbols + ["".join(m) for m in merges] + ["<|endoftext|>"]
    return GPT2BPETokenizer({t: i for i, t in enumerate(vocab)}, merges)


def write_coco(split: str, rng) -> tuple[str, str]:
    """The split of EPOCH_SPLITS under EPOCH_RUN (:func:`write_split`)."""
    n, per_image, ext = EPOCH_SPLITS[split]
    return write_split(split, n, per_image, rng, str(EPOCH_RUN / f"{split}_embeddings.{ext}"),
                       str(EPOCH_RUN / f"captions_{split}.json"))


def write_split(split: str, n: int, per_image: int, rng, emb_path: str,
                ann_path: str) -> tuple[str, str]:
    """Embeddings (512-d, normalised, through the port's ``embeddings_io``)
    and a COCO annotations JSON of random word captions, 5-12 words each."""
    from gpt2_image_captioning_tpu_torch.data.embeddings_io import save_embeddings

    ids = [(1 if split == "train" else 500_000) + i for i in range(n)]
    names = [f"COCO_{split}2014_{i:012d}.jpg" for i in ids]
    emb = rng.normal(size=(n, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    save_embeddings(emb_path, names, emb)
    anns = [{"image_id": i, "id": len(ids) * c + k,
             "caption": " ".join(rng.choice(CAPTION_WORDS, size=int(rng.integers(5, 13))))}
            for k, i in enumerate(ids) for c in range(per_image)]
    with open(ann_path, "w") as f:
        json.dump({"images": [{"id": i, "file_name": f} for i, f in zip(ids, names)],
                   "annotations": anns}, f)
    return emb_path, ann_path


class PartTimer:
    """Replaces functions that ``train()`` calls by wrappers that add each
    call's seconds (the card synchronized) to a part, and, for
    ``counted`` ones, each call's kernel launches to ``launches``."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.launches = {k: 0 for k in read_launches()}
        self._undo = []
        self._open: set[str] = set()  # parts being timed: a nested call is not added twice

    def wrap(self, part: str, module, attr: str, counted: bool = False) -> None:
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            if part in self._open:
                return fn(*a, **k)
            self._open.add(part)
            before = read_launches() if counted else None
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.seconds[part] = self.seconds.get(part, 0.0) + time.perf_counter() - t0
                self._open.discard(part)
                if counted:
                    for key, n in read_launches().items():
                        self.launches[key] += n - before[key]

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def clock_epochs(self, loop) -> None:
        """Time each epoch inside ``train()``: from its first batch's
        request to its epoch-loss log line, which follows the epoch's one
        read of its losses from the card (``epochs``: [start, end] each);
        and the metrics logger's construction (``logger_setup``)."""
        self.epochs: list[list[float]] = []
        epochs, seconds = self.epochs, self.seconds

        class ClockedBatcher(loop.Batcher):
            def epoch(self, epoch_idx=None):
                epochs.append([time.perf_counter()])
                yield from super().epoch(epoch_idx)

        class ClockedLogger(loop.MetricsLogger):
            def __init__(self, *a, **k):  # imports torch's TensorBoard writer where it can
                t0 = time.perf_counter()
                super().__init__(*a, **k)
                seconds["logger_setup"] = (seconds.get("logger_setup", 0.0)
                                           + time.perf_counter() - t0)

            def add_scalar(self, tag, value, step):
                if tag == "loss/train_epoch":
                    epochs[-1].append(time.perf_counter())
                super().add_scalar(tag, value, step)

        for attr, cls in (("Batcher", ClockedBatcher), ("MetricsLogger", ClockedLogger)):
            self._undo.append((loop, attr, getattr(loop, attr)))
            setattr(loop, attr, cls)

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)


def full_config():
    """GPT-2 124M + config.yml's transformer mapper (512 -> 768, 15 + 10)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig

    return C.CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                             mapping=TransformerMappingConfig(512, 768, 15, 10))


def trainable_rel_err(got: dict, want: dict) -> float:
    from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves

    a = torch.cat([t.detach().flatten().float() for t in tree_leaves(got)])
    b = torch.cat([t.detach().flatten().float() for t in tree_leaves(want)])
    return float((a - b).norm() / b.norm())


def train_epochs_phase(step_captions_per_s: float):
    """``train()`` at full width — GPT-2 124M frozen, the transformer mapper,
    bf16, b 128, two epochs of a synthetic COCO split (320 images x 3
    captions), evaluation each epoch in greedy bf16 on 256 val images, the
    checkpoints and artifacts on disk — then the same run stopped after one
    epoch and resumed for the second.  Returns (record, the training steps'
    launches, the evaluations' launches, the trained model, the val set)."""
    from gpt2_image_captioning_tpu_torch import BF16, ImageCaptioningModel
    from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
    from gpt2_image_captioning_tpu_torch.train import loop
    from gpt2_image_captioning_tpu_torch.utils import plotting_available

    shutil.rmtree(EPOCH_RUN, ignore_errors=True)
    EPOCH_RUN.mkdir()
    rng = np.random.default_rng(2)
    tok = fabricated_tokenizer()
    files = {split: write_coco(split, rng) for split in EPOCH_SPLITS}
    t0 = time.perf_counter()
    train_ds = CocoDataset(*files["train"], tokenizer=tok, max_length=50)
    val_ds = CocoDataset(*files["val"], tokenizer=tok, max_length=50)
    tokenize_s = time.perf_counter() - t0
    cfg = full_config()

    def model():
        return ImageCaptioningModel(cfg, tokenizer=tok, generator=torch.Generator().manual_seed(0),
                                    policy=BF16, device="cuda")

    kw = dict(batch_size=B, learning_rate=1e-4, device="cuda")
    straight = EPOCH_RUN / "straight"
    trained = model()
    timer = PartTimer()
    timer.wrap("evaluation", loop, "evaluate_epoch", counted=True)
    timer.wrap("checkpoint", loop.checkpoint, "save_captioner")
    timer.wrap("checkpoint", loop.checkpoint, "save_pytree")
    for attr in ("save_loss_curves", "save_eval_metric_curves", "save_eval_summary"):
        timer.wrap("curves_and_summary", loop, attr)
    timer.clock_epochs(loop)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        hist = loop.train(train_ds, trained, num_epochs=2, save_every_epoch=2,
                          outputs_dir=str(straight), log_dir=str(straight / "logs"),
                          val_dataset=val_ds, val_annotations_path=files["val"][1],
                          eval_batch_size=B, eval_max_length=50, eval_decode_precision="bf16",
                          **kw)
        torch.cuda.synchronize()
    finally:
        timer.restore()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    eval_launches = timer.launches
    train_launches = {k: n - eval_launches[k] for k, n in launches.items()}

    steps = hist["step_timing"]["steps"]
    per_step = cfg.mapping.num_layers + cfg.gpt2.n_layer
    check(steps == 2 * -(-len(train_ds) // B), f"{steps} optimizer steps in two epochs")
    check(train_launches["flash_attention"] == per_step * steps,
          f"training flash launches {train_launches['flash_attention']} != {per_step} x {steps}")
    check(not any(n for k, n in train_launches.items() if k != "flash_attention"),
          f"the training steps launched decode kernels: {train_launches}")
    check(all(np.isfinite(hist["epoch_losses"])), f"non-finite epoch loss: {hist['epoch_losses']}")
    val_ids = list(dict.fromkeys(int(i) for i in val_ds.image_ids))
    eval_requests = 2 * -(-len(val_ids) // B)  # two passes of 128-image batches
    check_decode_launches(eval_launches, "logits_argmax",
                          eval_launches["decode_attention"] // cfg.gpt2.n_layer, eval_requests, cfg)
    best = hist["best_epoch"]
    plots = plotting_available()
    want = ["model_epoch_2.npz", "optimizer_epoch_2.npz", f"best_model_epoch_{best}.npz",
            "logs/metrics.jsonl", "eval_results/val_metrics_summary.json"]
    want += [f"eval_results/epoch_{e}_val_{kind}.json" for e in (1, 2)
             for kind in ("predictions", "metrics")]
    want += ["loss_curve.png", "eval_results/val_metrics_curve.png"] if plots else []
    missing = [f for f in want if not (straight / f).exists()]
    check(not missing, f"train() artifacts missing: {missing}")
    preds = json.loads((straight / "eval_results/epoch_2_val_predictions.json").read_text())
    check([p["image_id"] for p in preds] == val_ids,
          "generate_predictions did not return one caption per unique val image")

    # one epoch, then a resumed second on a fresh model of the same seed
    resumed = EPOCH_RUN / "resumed"
    first = model()
    loop.train(train_ds, first, num_epochs=2, stop_after_epochs=1, save_every_epoch=1,
               outputs_dir=str(resumed), log_dir=str(resumed / "logs"), **kw)
    del first
    second = model()
    hist_r = loop.train(train_ds, second, num_epochs=2, resume=True, save_every_epoch=1,
                        outputs_dir=str(resumed), log_dir=str(resumed / "logs"), **kw)
    loss_err = abs(hist_r["epoch_losses"][0] - hist["epoch_losses"][1])
    param_err = trainable_rel_err(second.trainable, trained.trainable)
    check(len(hist_r["epoch_losses"]) == 1, f"the resumed run ran {hist_r['epoch_losses']}")
    check(loss_err <= TRAIN_TOL["loss_bf16"], f"resumed epoch-2 loss {hist_r['epoch_losses']} "
                                              f"against straight {hist['epoch_losses'][1]}")
    check(param_err <= TRAIN_TOL["loss_bf16"], f"resumed parameters: relative error {param_err}")
    del second
    epoch_s = [end - start for start, end in timer.epochs]
    parts = {"epochs": sum(epoch_s), **timer.seconds}
    parts["setup_and_rest"] = total_s - sum(parts.values())
    parts["tokenize"] = tokenize_s
    record = {
        "phase": "train_epochs",
        "model": "GPT-2 124M frozen + transformer mapper (512->768, 15+10)",
        "dtype": "bf16 compute, float32 params", "batch": B, "epochs": 2,
        "train_images": EPOCH_SPLITS["train"][0], "train_captions": len(train_ds),
        "val_images": len(val_ids), "optimizer_steps": steps, "caption_length": 50,
        "merge_loop": tok.merge_loop, "matplotlib": plots,
        "captions_per_s_epoch": [len(train_ds) / t for t in epoch_s], "epoch_seconds": epoch_s,
        "captions_per_s_make_train_step": step_captions_per_s,
        "train_seconds": total_s, "seconds_by_part": parts,
        "epoch_losses": hist["epoch_losses"], "val_metrics": hist["val_metrics"],
        "best_epoch": best, "step_timing": hist["step_timing"],
        "launches_training": train_launches, "launches_evaluation": eval_launches,
        "resume": {"epoch2_loss": hist_r["epoch_losses"][0], "loss_abs_err": loss_err,
                   "param_rel_err": param_err, "tolerance": TRAIN_TOL["loss_bf16"]},
        "card": nvidia_smi(),
    }
    return record, train_launches, eval_launches, trained, val_ds


def evaluation_phase(model, val_ds) -> tuple[dict, dict]:
    """``generate_predictions`` on the trained model over the 256 val images
    in 128-image batches, in greedy, sampled (the logits tail), beam-4 and
    greedy int8: one caption per unique image, the first batch's captions
    equal to the façade's own ``generate`` / ``beam_generate`` on the same
    embeddings, launches checked.  Returns (record, launches by mode)."""
    from gpt2_image_captioning_tpu_torch.evaluation import generation
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg, tok = model.cfg, model.tokenizer
    val_ids = list(dict.fromkeys(int(i) for i in val_ds.image_ids))
    first = next(val_ds.unique_image_batches(B))
    emb = torch.from_numpy(first["image_embedding"]).cuda()
    batches = -(-len(val_ids) // B)
    out, counts = {"phase": "evaluation", "model": MODEL_NAME, "images": len(val_ids),
                   "batch": B, "max_length": 50}, {}
    for mode, kw in EVAL_MODES.items():
        kw = dict(batch_size=B, max_length=50, verbose=False, device="cuda", **kw)
        generation.generate_predictions(model, val_ds, **kw)  # warm-up: packs, workspaces
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        preds = generation.generate_predictions(model, val_ds, **kw)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check([p["image_id"] for p in preds] == val_ids,
              f"eval {mode}: not one caption per unique val image")
        quant = kw["decode_precision"] == "int8"
        if mode == "beam":
            tr, fz, pol, packed, _ = model.decode_pack("bf16")
            ids = C.beam_generate(tr, fz, cfg, emb, max_length=50, beam_size=BEAM_K, policy=pol,
                                  packed=packed)
            steps = 49 * batches
            check_decode_launches(launches, "logits_topk", steps, batches, cfg)
        else:
            gen = None
            if kw["temperature"] != 0.0:
                gen = torch.Generator(device="cuda").manual_seed(generation.batch_seed(0, 0))
            ids = model.generate(emb, max_length=50, temperature=kw["temperature"],
                                 top_p=kw.get("top_p", 0.9), generator=gen,
                                 decode_precision=kw["decode_precision"])
            steps = launches["decode_attention"] // cfg.gpt2.n_layer
            check_decode_launches(launches, "logits" if mode == "sampled" else "logits_argmax",
                                  steps, batches, cfg, quant)
        want = tok.batch_decode(ids.cpu().numpy(), skip_special_tokens=True)
        check([p["caption"] for p in preds[:B]] == want,
              f"eval {mode}: the first batch's captions differ from the façade's")
        counts[f"eval_{mode}"] = launches
        out[mode] = {"img_per_s": len(preds) / seconds, "seconds": seconds, "decode_steps": steps,
                     "first_batch_equal_to_facade": True, "launches": launches,
                     "distinct_captions": len({p["caption"] for p in preds})}
    out["card"] = nvidia_smi()
    return out, counts


# ---------------------------------------------------------------------------
# Phase 8: the wide GPT-2 sizes
# ---------------------------------------------------------------------------

# GPT-2 medium, large and XL at full width, cut to the 12 layers of 124M (the
# kernels see the same shapes at any depth; the random init of 24-48 layers
# on the host took 32 s of the script), random weights from a seed, fed by
# config.yml's transformer mapper at the model's width (512 -> D, 15 + 10
# tokens, 8 heads: the flash kernel at hd 128, 160 and 200).  SIZE_BATCH
# embeddings, SIZE_STEPS tokens, greedy in bf16 and float32 and sampled on
# the logits tail in bf16,
# every token held to the plain path by the bounds of the 124M paths; then a
# tiny-vocabulary float32 model of each width and 2 layers, exact tokens.
SIZES = ("gpt2_medium", "gpt2_large", "gpt2_xl")
SIZE_BATCH, SIZE_STEPS = 16, 20
SIZE_DEPTH_CUTS: dict[str, int] = {name: 12 for name in SIZES}
SIZE_TINY_VOCAB = 211


def size_config(name: str, n_layer: int | None = None, vocab: int | None = None):
    """GPT-2 ``name`` with config.yml's transformer mapper at its width (512
    -> D, 15 + 10 tokens, 8 heads of D / 8: 128, 160 and 200)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig

    gcfg = getattr(GPT2Config, name)()
    if n_layer is not None:
        gcfg = dataclasses.replace(gcfg, n_layer=n_layer)
    if vocab is not None:
        gcfg = dataclasses.replace(gcfg, vocab_size=vocab, n_positions=128)
    return C.CaptionerConfig(gpt2=gcfg, mapping=TransformerMappingConfig(512, gcfg.n_embd, 15, 10),
                             eos_token_id=gcfg.vocab_size - 1)


def size_tiny_exact(name: str) -> dict:
    """A float32 model of the size's width and heads with 2 layers and a
    vocabulary of SIZE_TINY_VOCAB: greedy tokens with the kernels equal to
    the plain path's (EOS picked as in :func:`tiny_exact`)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg = size_config(name, n_layer=2, vocab=SIZE_TINY_VOCAB)
    tr, fz = C.init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
    emb = torch.from_numpy(np.random.default_rng(5).normal(size=(5, 512)).astype(np.float32))
    emb = emb.cuda()
    probe = C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0,
                       use_kernels=False).cpu().numpy()
    firsts = set(probe[:, 0].tolist())
    eos = next((int(t) for t in probe[0, 1:] if int(t) not in firsts), int(probe[0, 1]))
    cfg = dataclasses.replace(cfg, eos_token_id=eos)
    want = C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0, use_kernels=False)
    reset_launches()
    got = C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0)
    torch.cuda.synchronize()
    launches = read_launches()
    check(torch.equal(got, want), f"{name} tiny f32 tokens differ:\n{got.cpu()}\n{want.cpu()}")
    check(launches["prefill"] == 1 and launches["logits_argmax"] > 0,
          f"{name} tiny f32: launches {launches}")
    return {"layers": 2, "vocab": SIZE_TINY_VOCAB, "batch": 5, "max_length": 12, "eos": eos,
            "tokens_equal": True, "decode_steps": decode_steps(got, eos), "launches": launches}


def size_phase(name: str) -> tuple[dict, dict]:
    """One size: (record, launches by path)."""
    from gpt2_image_captioning_tpu_torch import ImageCaptioningModel

    cfg = size_config(name, SIZE_DEPTH_CUTS.get(name))
    g = cfg.gpt2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    model = ImageCaptioningModel(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    init_s = time.perf_counter() - t0
    emb = torch.from_numpy(np.random.default_rng(6).normal(size=(SIZE_BATCH, 512))
                           .astype(np.float32)).cuda()
    record = {"phase": f"size_{name}", "n_embd": g.n_embd, "n_head": g.n_head,
              "n_layer": g.n_layer, "depth_cut": name in SIZE_DEPTH_CUTS,
              "mapper": f"transformer (512 -> {g.n_embd}, 15 + 10, 8 heads of {g.n_embd // 8})",
              "batch": SIZE_BATCH, "max_length": SIZE_STEPS,
              "init_seconds": init_s}
    counts = {}
    runs = (("greedy_bf16", "bf16", dict(temperature=0.0), "logits_argmax"),
            ("greedy_f32", "f32", dict(temperature=0.0), "logits_argmax"),
            ("sampled_bf16", "bf16", dict(temperature=1.0, top_p=TOP_P), "logits"))
    for path, precision, kw, vocab in runs:
        def run(use=None):
            gen = torch.Generator(device="cuda").manual_seed(3)
            return model.generate(emb, max_length=SIZE_STEPS, decode_precision=precision,
                                  generator=gen, use_kernels=use, **kw)

        run()  # warm-up: the weight copy and packs
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        steps = decode_steps(out, cfg.eos_token_id)
        check(tuple(out.shape) == (SIZE_BATCH, SIZE_STEPS), f"{name} {path}: shape {out.shape}")
        check_padding(out, cfg.eos_token_id, g.vocab_size)
        check_decode_launches(launches, vocab, steps, 1, cfg)
        t0 = time.perf_counter()
        plain = run(use=False)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        rec = {"decode_steps": steps, "seconds_kernels": seconds, "seconds_plain": plain_seconds,
               "rows_identical_to_plain": int((out == plain).all(dim=1).sum()),
               "launches": launches}
        if kw["temperature"] == 0.0:
            worst, n, agree = teacher_forced(model, emb, out, precision=precision)
            tol = TF_TOL_F32 if precision == "f32" else TF_TOL
            check(worst <= tol, f"{name} {path}: a chosen token is {worst} below the plain max "
                                f"(tolerance {tol})")
            rec["teacher_forced"] = {"worst_deficit": worst, "tolerance": tol,
                                     "tokens_checked": n, "share_plain_argmax": agree}
        else:
            worst, n, top1 = nucleus_mass(model, emb, out, 1.0, precision=precision)
            check(worst <= TOP_P + NUCLEUS_SLACK,
                  f"{name} {path}: a drawn token has plain mass {worst} above it")
            rec["nucleus"] = {"worst_mass_above": worst, "limit": TOP_P + NUCLEUS_SLACK,
                              "tokens_checked": n, "share_plain_argmax": top1}
        record[path] = rec
        counts[f"size_{name}_{path}"] = launches
    record["peak_memory_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
    record["held_before_gb"] = held / 1e9
    del model
    torch.cuda.empty_cache()
    record["tiny_f32_exact"] = size_tiny_exact(name)
    counts[f"size_{name}_tiny_f32"] = record["tiny_f32_exact"]["launches"]
    record["card"] = nvidia_smi()
    return record, counts


def sizes_phase() -> tuple[list[dict], dict]:
    records, counts = [], {}
    for name in SIZES:
        record, c = size_phase(name)
        records.append(record)
        counts.update(c)
    return records, counts


# ---------------------------------------------------------------------------
# Phase 9: HTTP serving over both services
# ---------------------------------------------------------------------------

# HTTP_REQUESTS JPEG bodies of mixed sizes from HTTP_CLIENTS client threads,
# each of which sends all of its requests (one connection each) before it
# reads any answer, so every request is in flight at once; the coalescing
# server's window; device batches allowed beyond 2 per 128 requests: the
# batch the window cuts before the surge has arrived, and the last one.
HTTP_REQUESTS, HTTP_CLIENTS, HTTP_WINDOW_MS, HTTP_STRAGGLERS = 256, 32, 50.0, 2


def http_bodies(n: int, seed: int) -> list[bytes]:
    """JPEG bodies, 96-640 pixels a side: smooth random images (8 x 8 noise
    resized), which compress as photographs do."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w, h = (int(x) for x in rng.integers(96, 641, size=2))
        small = Image.fromarray(rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8))
        buf = io.BytesIO()
        small.resize((w, h), Image.BILINEAR).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def http_post_all(port: int, bodies: list[bytes], paths: list[str], pool=None):
    """POST every body from HTTP_CLIENTS threads of a client process of
    their own (so that the clients do not take the server's interpreter
    lock; ``pool``: a one-process pool of :func:`http_client_pool` to reuse,
    else one is started), each thread with all of its requests in flight at
    once, its answers read as their sockets turn readable: ([(status,
    JSON)], [seconds from send to answer], wall seconds)."""
    if pool is not None:
        return pool.apply(http_clients, (port, bodies, paths))
    with http_client_pool() as pool:
        return pool.apply(http_clients, (port, bodies, paths))


def http_client_pool():
    """A pool of one spawned client process (which imports this script, so
    it takes seconds to start)."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(1)


def http_clients(port: int, bodies: list[bytes], paths: list[str]):
    """The client process of :func:`http_post_all`."""
    import http.client
    import selectors
    import threading

    n = len(bodies)
    answers, latency = [None] * n, [0.0] * n

    def client(c: int) -> None:
        sel, sent = selectors.DefaultSelector(), {}
        for i in range(c, n, HTTP_CLIENTS):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            sent[i] = (conn, time.perf_counter())
            conn.request("POST", paths[i], body=bodies[i])
            sel.register(conn.sock, selectors.EVENT_READ, i)
        while sent:
            for key, _ in sel.select(timeout=600):
                i = key.data
                conn, t0 = sent.pop(i)
                sel.unregister(key.fileobj)
                r = conn.getresponse()
                answers[i] = (r.status, json.loads(r.read()))
                latency[i] = time.perf_counter() - t0
                conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, latency, time.perf_counter() - t0


def http_raw(port: int, method: str, path: str, body: bytes = b"",
             headers: dict | None = None) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest(method, path)
        for k, v in (headers if headers is not None else {"Content-Length": str(len(body))}
                     ).items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def http_errors(port: int) -> dict:
    """The answers given before any device call: 404 (another path), 400 (a
    body that is no image), 411 (a malformed Content-Length), 413 (a length
    above the limit, nothing read)."""
    cases = {"404": ("GET", "/nope", b"", {}), "400": ("POST", "/caption", b"junk", None),
             "411": ("POST", "/caption", b"", {"Content-Length": "abc"}),
             "413": ("POST", "/caption", b"x", {"Content-Length": str(1 << 30)})}
    got = {}
    for code, (method, path, body, headers) in cases.items():
        status, answer = http_raw(port, method, path, body, headers)
        check(status == int(code) and set(answer) == {"error"},
              f"HTTP {code} case answered {status} {answer}")
        got[code] = answer["error"][:60]
    return got


def serving_stats(answers, latency, seconds) -> dict:
    lat = np.sort(latency)
    return {"requests": len(answers), "seconds": seconds,
            "requests_per_s": len(answers) / seconds,
            "latency_p50_s": float(lat[len(lat) // 2]),
            "latency_p95_s": float(lat[int(len(lat) * 0.95)])}


def http_phase() -> tuple[list[dict], dict]:
    """Both HTTP surfaces at full width: CLIP ViT-B/32 + GPT-2 124M with
    config.yml's transformer mapper, bf16, random weights from a seed; the
    synthetic tokenizer, so captions parse back to ids."""
    import io
    import threading

    from PIL import Image

    from gpt2_image_captioning_tpu_torch import serving as S
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import resize_and_crop

    model, _ = serving_model()
    model.tokenizer = synthetic_tokenizer(V)
    _, clip_cfg, clip_params = tower_params("clip")
    cfg, eos = model.cfg, model.cfg.eos_token_id
    bodies = http_bodies(HTTP_REQUESTS, seed=12)
    records, counts = [], {}

    # the coalescing surface
    svc = S.CaptionService(model, clip_params, clip_cfg, batch_size=B, max_length=50,
                           decode_precision="bf16")
    want = svc.caption_bytes(bodies)  # also the warm-up
    batches, caption_batch = [], svc._caption_batch

    def counted(u8):
        batches.append(len(u8))
        return caption_batch(u8)

    svc._caption_batch = counted
    server = S.serve_http(svc, port=0, window_ms=HTTP_WINDOW_MS)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    torch.cuda.synchronize()
    reset_launches()
    answers, latency, seconds = http_post_all(port, bodies, ["/caption"] * HTTP_REQUESTS)
    torch.cuda.synchronize()
    launches = read_launches()
    errors = http_errors(port)
    status, health = http_raw(port, "GET", "/healthz", headers={})
    server.shutdown()
    server.server_close()
    serving.join(30)
    check(not server.dispatcher_thread.is_alive() and not serving.is_alive(),
          "serve_http: shutdown() left a thread running")
    check(all(a[0] == 200 for a in answers),
          f"serve_http: answers {sorted({a[0] for a in answers})}")
    parted = sum(a[1]["caption"] != w for a, w in zip(answers, want))
    check(parted == 0, f"serve_http: {parted} captions differ from caption_bytes of the body")
    allowed = 2 * -(-HTTP_REQUESTS // B) + HTTP_STRAGGLERS
    check(len(batches) <= allowed, f"serve_http: {len(batches)} device batches for "
                                   f"{HTTP_REQUESTS} requests (<= {allowed})")
    used = ("patch_embed", "flash_attention", "prefill", "fused_linear", "decode_attention",
            "logits_argmax")
    check(all(launches[k] > 0 for k in used), f"serve_http: launches {launches}")
    check(status == 200 and health["ok"], f"serve_http /healthz: {status} {health}")
    counts["http"] = launches
    records.append({
        "phase": "http_serve", "model": f"CLIP ViT-B/32 + {MODEL_NAME}", "dtype": "bf16",
        "batch_size": B, "window_ms": HTTP_WINDOW_MS, "clients": HTTP_CLIENTS,
        **serving_stats(answers, latency, seconds), "device_batches": len(batches),
        "device_batches_allowed": allowed, "requests_per_batch": batches,
        "captions_equal_to_caption_bytes": True, "errors": errors, "launches": launches,
        "card": nvidia_smi()})
    del svc

    # the rolling-admission surface: greedy, a max_length of 8-50 a request
    rng = np.random.default_rng(13)
    caps = rng.integers(8, 51, size=HTTP_REQUESTS)
    csvc = S.ContinuousCaptionService(model, clip_params, clip_cfg, **CONTINUOUS,
                                      decode_precision="bf16")
    prepped = np.stack([resize_and_crop(np.asarray(Image.open(io.BytesIO(b)).convert("RGB"),
                                                   np.uint8), csvc.spec) for b in bodies])
    for p in prepped[:16]:  # warm-up, on this thread
        csvc.submit_prepped(p, max_length=8)
    csvc.drain()
    csvc._results.clear()
    seen, encode = [], csvc._encode

    def recorded(params, u8):  # the embeddings each request was served from
        e = encode(params, u8)
        seen.append((u8, e))
        return e

    csvc._encode = recorded
    server = S.serve_http_continuous(csvc, port=0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    torch.cuda.synchronize()
    reset_launches()
    answers, latency, seconds = http_post_all(
        port, bodies, [f"/caption?max_length={int(c)}" for c in caps])
    torch.cuda.synchronize()
    launches = read_launches()
    errors = http_errors(port)
    status, bad_len = http_raw(port, "POST", "/caption?max_length=99", bodies[0])
    check(status == 400, f"serve_http_continuous: max_length 99 answered {status}")
    status, health = http_raw(port, "GET", "/healthz", headers={})
    server.shutdown()
    server.server_close()
    serving.join(30)
    check(not server.pump_thread.is_alive() and not serving.is_alive(),
          "serve_http_continuous: shutdown() left a thread running")
    check(all(a[0] == 200 for a in answers),
          f"serve_http_continuous: answers {sorted({a[0] for a in answers})}")
    ids = [caption_ids(a[1]["caption"]) for a in answers]
    for r, c in zip(ids, caps):
        check(len(r) <= c and all(0 <= t < eos for t in r), "a served caption breaks its cap")
    by_image = {}
    for u8, e in seen:
        for px, row in zip(u8.cpu().numpy(), e.float().cpu().numpy()):
            by_image[px.tobytes()] = row
    embs = np.stack([by_image[p.tobytes()] for p in prepped])
    tokens, n_gen = served_matrix(ids, caps, eos)
    checked = check_served_tokens(model, embs, tokens, n_gen, sampled=False)
    one_shot = []
    for c0 in range(0, HTTP_REQUESTS, B):
        out = model.generate(embs[c0 : c0 + B], max_length=50, temperature=0.0,
                             decode_precision="bf16")
        one_shot += one_shot_ids(out, caps[c0 : c0 + B], eos)
    check(all(launches[k] > 0 for k in used), f"serve_http_continuous: launches {launches}")
    check(status == 200 and health["ok"], f"serve_http_continuous /healthz: {status} {health}")
    counts["http_continuous"] = launches
    records.append({
        "phase": "http_serve_continuous", "model": f"CLIP ViT-B/32 + {MODEL_NAME}",
        "dtype": "bf16", **CONTINUOUS, "clients": HTTP_CLIENTS, "caps": [8, 50],
        **serving_stats(answers, latency, seconds), "tokens": int(n_gen.sum()),
        "occupancy": csvc.stats.get("occupancy"), "checked": checked,
        "identical_to_one_shot_generate": sum(a == b for a, b in zip(ids, one_shot)) / len(ids),
        "errors": {**errors, "max_length_99": bad_len["error"]}, "launches": launches,
        "card": nvidia_smi()})
    del csvc, clip_params, model
    torch.cuda.empty_cache()
    return records, counts


# ---------------------------------------------------------------------------
# Phase 10: config-driven training, the sweep and the environment check
# ---------------------------------------------------------------------------

PIPELINE_RUN = Path(__file__).resolve().parent / "chip_pipeline"  # removed at the end
# synthetic COCO splits: (annotations file, images, captions per image)
PIPELINE_SPLITS = {"train": ("captions_train2017.json", 256, 2),
                   "val": ("captions_val2017.json", 128, 1),
                   "test": ("captions_val2014.json", 128, 1)}


def pipeline_config(root: Path) -> Path:
    """config.yml with its data under ``root`` and a run of CPU-free size:
    the transformer mapper 512 -> 768, prefix 15, GPT-2 124M, bf16 compute, b
    128, one epoch, greedy evaluation each epoch; written as a file."""
    from gpt2_image_captioning_tpu_torch.core.config import load_config, update_cfg

    here = Path(__file__).resolve().parent
    cfg = update_cfg(load_config(str(here / "config.yml")), {
        "paths": {"data_dir": f"{root / 'coco'}/"},
        "mapping": {"type": "transformer", "embed_dim": 512, "gpt_dim": 768,
                    "prefix_length": 15, "hidden_length": 10},
        "tpu": {"compute_dtype": "bfloat16", "mesh": {"dp": -1, "tp": 1}},
        "training": {"batch_size": B, "num_epochs": 1, "save_every_epoch": 1},
        "validation": {"eval_every_epoch": 1, "batch_size": B, "temperature": 0.0},
    })
    path = root / "config.yml"
    cfg.save(str(path))
    return path


def write_pipeline_data(root: Path):
    """PIPELINE_SPLITS under ``root/coco`` (embeddings and annotations, as
    config.yml's paths name them) and the fabricated tokenizer's files in
    ``root/gpt2_tokenizer``: (tokenizer, its folder)."""
    shutil.rmtree(root, ignore_errors=True)
    (root / "coco" / "embeddings").mkdir(parents=True)
    (root / "coco" / "annotations").mkdir()
    tok = fabricated_tokenizer()
    tok_dir = root / "gpt2_tokenizer"
    tok_dir.mkdir()
    (tok_dir / "vocab.json").write_text(json.dumps(tok.encoder))
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    (tok_dir / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    rng = np.random.default_rng(14)
    for split, (ann, n, per_image) in PIPELINE_SPLITS.items():
        write_split(split, n, per_image, rng,
                    str(root / "coco" / "embeddings" / f"{split}_clip_embeddings.pt"),
                    str(root / "coco" / "annotations" / ann))
    return tok, tok_dir


def pipeline_launches_used(launches: dict, what: str) -> None:
    """Training ran flash attention; the greedy evaluations ran the prefill,
    the step's kernels and the argmax."""
    used = ("flash_attention", "prefill", "fused_linear", "decode_attention", "logits_argmax")
    check(all(launches[k] > 0 for k in used), f"{what}: launches {launches}")


def gpt_rel_change(model, fresh) -> float:
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    return trainable_rel_err(C._gpt(model.trainable, model.frozen),
                             C._gpt(fresh.trainable, fresh.frozen))


def pipeline_phase() -> tuple[list[dict], dict]:
    """``training_pipeline.run`` from a config.yml-schema file, then
    ``sweep.run_one`` for ids 1 and 2 of the repo's automation_config.yml
    and for id 1 with an unfrozen GPT-2, on synthetic COCO splits and the
    fabricated 50,257-token tokenizer (``vocab.json`` + ``merges.txt`` in
    ``$GPT2_TOKENIZER_DIR``); the artifacts, GPT-2 moved only when unfrozen,
    the test predictions decoded again from ``select_test_checkpoint``'s
    file; then ``python -m gpt2_image_captioning_tpu_torch``."""
    import os

    from gpt2_image_captioning_tpu_torch import sweep
    from gpt2_image_captioning_tpu_torch import training_pipeline as tp
    from gpt2_image_captioning_tpu_torch.core.config import load_config, update_cfg
    from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
    from gpt2_image_captioning_tpu_torch.evaluation.generation import (
        generate_test_caption_predictions,
    )

    here = Path(__file__).resolve().parent
    seconds, counts = {}, {}
    t0 = time.perf_counter()
    tok, tok_dir = write_pipeline_data(PIPELINE_RUN)
    cfg = load_config(str(pipeline_config(PIPELINE_RUN)))
    seconds["data_and_tokenizer_files"] = time.perf_counter() - t0

    built, build = [], tp.build_model

    def keep(*a, **k):  # the models the pipeline trains
        m = build(*a, **k)
        built.append(m)
        return m

    old_env, old_cwd = os.environ.get("GPT2_TOKENIZER_DIR"), os.getcwd()
    os.environ["GPT2_TOKENIZER_DIR"] = str(tok_dir)
    os.chdir(PIPELINE_RUN)  # train() logs under ./logs
    tp.build_model = keep
    records, changes = [], {}
    try:
        t0 = time.perf_counter()
        reset_launches()
        hist = tp.run(cfg, save_dir=str(PIPELINE_RUN / "run"), device="cuda")
        torch.cuda.synchronize()
        seconds["training_pipeline_run"] = time.perf_counter() - t0
        counts["pipeline_run"] = read_launches()
        pipeline_launches_used(counts["pipeline_run"], "training_pipeline.run")
        check(len(hist["epoch_losses"]) == 1 and np.isfinite(hist["epoch_losses"][0]),
              f"training_pipeline.run: losses {hist['epoch_losses']}")
        check(built[-1].policy.compute_dtype == torch.bfloat16, "tpu.compute_dtype not bf16")
        run_files = ["model_epoch_1.npz", "optimizer_epoch_1.npz", "best_model_epoch_1.npz",
                     "eval_results/epoch_1_val_predictions.json",
                     "eval_results/epoch_1_val_metrics.json",
                     "eval_results/val_metrics_summary.json"]
        missing = [f for f in run_files if not (PIPELINE_RUN / "run" / f).exists()]
        check(not missing, f"training_pipeline.run: missing {missing}")
        fresh = build(cfg, tok, device="cuda")
        changes["pipeline_run"] = gpt_rel_change(built[-1], fresh)
        check(changes["pipeline_run"] == 0.0, "training_pipeline.run moved the frozen GPT-2")
        del fresh
        built.clear()

        auto = load_config(str(here / "automation_config.yml"))
        plans = sweep.plan_runs(cfg, auto, ["1", "2"])
        run_cfg = dict((i, c) for i, c, _ in plans)
        plans.append(("1_unfrozen", update_cfg(run_cfg["1"], {
            "image_captioning": {"freeze_gpt_weights": False}}), "id 1, GPT-2 unfrozen"))
        for run_id, run_c, desc in plans:
            t0 = time.perf_counter()
            reset_launches()
            sweep.run_one(run_c, run_id, str(PIPELINE_RUN / "sweep"), desc, device="cuda")
            torch.cuda.synchronize()
            seconds[f"sweep_run_one_{run_id}"] = time.perf_counter() - t0
            counts[f"sweep_{run_id}"] = read_launches()
            pipeline_launches_used(counts[f"sweep_{run_id}"], f"sweep {run_id}")
            d = PIPELINE_RUN / "sweep" / f"checkpoint_{run_id}"
            want = [f"config_{run_id}.yml", f"training_info_{run_id}.txt",
                    f"test_predictions_{run_id}.json", f"test_metrics_{run_id}.json"] + run_files
            missing = [f for f in want if not (d / f).exists()]
            check(not missing, f"sweep {run_id}: missing {missing}")
            metrics = json.loads((d / f"test_metrics_{run_id}.json").read_text())
            check("CIDEr" in metrics, f"sweep {run_id}: test metrics {metrics}")
            trained = built[0]  # the model run() trained; the test pass's is built by sweep
            fresh = build(run_c, tok, device="cuda")
            changes[run_id] = gpt_rel_change(trained, fresh)
            unfrozen = not run_c.image_captioning.freeze_gpt_weights
            check((changes[run_id] > 0) == unfrozen,
                  f"sweep {run_id}: GPT-2 moved by {changes[run_id]} (unfrozen: {unfrozen})")
            t0 = time.perf_counter()
            best = sweep.select_test_checkpoint(os.listdir(d))
            fresh.load_saved_parameters(str(d / best))
            test_ds = CocoDataset(tp.embeddings_file(run_c, "test"),
                                  str(PIPELINE_RUN / "coco" / "annotations" /
                                      "captions_val2014.json"),
                                  tokenizer=tok, max_length=run_c.max_caption_length)
            again = generate_test_caption_predictions(
                fresh, test_ds, output_path=str(PIPELINE_RUN / "again.json"),
                batch_size=run_c.validation.batch_size, max_length=run_c.max_caption_length,
                temperature=run_c.validation.temperature, top_p=run_c.validation.top_p,
                decode_precision=run_c.validation.get("decode_precision"), device="cuda")
            first = json.loads((d / f"test_predictions_{run_id}.json").read_text())
            check(again == first, f"sweep {run_id}: the test predictions of {best} decoded "
                                  "again differ")
            seconds[f"redecode_{run_id}"] = time.perf_counter() - t0
            info = dict(line.split(": ", 1) for line in
                        (d / f"training_info_{run_id}.txt").read_text().splitlines())
            records.append({"phase": f"pipeline_sweep_{run_id}", "description": desc,
                            "checkpoint": best, "test_metrics": metrics,
                            "training_info": info, "gpt2_rel_change": changes[run_id],
                            "test_predictions_equal_on_redecode": True,
                            "launches": counts[f"sweep_{run_id}"]})
            del trained, fresh
            built.clear()
            torch.cuda.empty_cache()
    finally:
        tp.build_model = build
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop("GPT2_TOKENIZER_DIR", None)
        else:
            os.environ["GPT2_TOKENIZER_DIR"] = old_env
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gpt2_image_captioning_tpu_torch"],
                          capture_output=True, text=True, timeout=300, cwd=str(here))
    seconds["python_m_check"] = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    check(proc.returncode == 0 and name in proc.stdout,
          f"python -m gpt2_image_captioning_tpu_torch: exit {proc.returncode}\n{proc.stdout}"
          f"\n{proc.stderr}")
    shutil.rmtree(PIPELINE_RUN, ignore_errors=True)
    records.insert(0, {
        "phase": "pipeline", "model": MODEL_NAME, "dtype": "bf16 compute (tpu.compute_dtype)",
        "splits": {k: v[1:] for k, v in PIPELINE_SPLITS.items()}, "batch": B, "epochs": 1,
        "run_history": {k: hist[k] for k in ("epoch_losses", "best_val_cider", "best_epoch")},
        "gpt2_rel_change": changes, "seconds_by_part": seconds,
        "python_m": proc.stdout.strip().splitlines(), "card": nvidia_smi()})
    return records, counts


# ---------------------------------------------------------------------------
# Phase 11: retrieval-augmented training (RAT)
# ---------------------------------------------------------------------------

# The device store at COCO train2017's scale: 118,287 images and 591,753
# captions (5 an image; 318 images hold a sixth or a seventh), seeded unit
# vectors of 512, float32 on the card (about 1.45 GB).
COCO_IMAGES, COCO_CAPTIONS, COCO_EXTRA = 118_287, 591_753, {6: 270, 7: 24}
RAT_TOP = dict(top_k=10, top_i=4)  # config.yml's retrieval block
RAT_STEPS = 6  # timed train steps a configuration, after one warm-up step
# The fused retrieval's image ids against a float64 reference: equal, except
# where two of the reference's similarities within 1e-6 of each other sit
# on either side of a rank (the float32 product cannot order them).
RAT_GAP = 1e-6
# The host stores (flat and HNSW at M 32, ef_construction 200, ef_search
# 64): 8,192 images around RAT_CENTRES cluster centres, as real CLIP
# embeddings lie (uniform random 512-d vectors are HNSW's worst case), and
# HOST_CAPTIONS caption vector an image near it (so top_k 10 over 4 images
# gives 4 rows and 6 zero rows).  HNSW's single-threaded build of both
# indices (≈ 90 s at 2 captions an image on the card's host) runs in a
# thread beside the other parts.
HOST_IMAGES, HOST_CAPTIONS, RAT_CENTRES = 8192, 1, 300
HNSW_RECALL_MIN = 0.95  # tests/test_hnsw_store.py's recall bound
HOST_STEPS = 6  # train steps in a traced window of the prefetched loop
# Caption extraction: the CLIP text tower at full size (ViT-B/32's: 49,408
# tokens, 12 layers of 512, 8 heads, 77 positions) over EXTRACT_CAPTIONS
# captions of 1,024 images in batches of EXTRACT_BATCH; features against
# the plain path by the towers' bounds.
EXTRACT_CAPTIONS, EXTRACT_BATCH = 4096, 256
RAT_RUN = Path(__file__).resolve().parent / "chip_rat"  # removed at the end


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def coco_store():
    """The COCO-scale DeviceVectorStore, made on the card from a seed."""
    from gpt2_image_captioning_tpu_torch.retrieval.exact import DeviceVectorStore

    g = torch.Generator(device="cuda").manual_seed(15)
    images = unit_rows(torch.randn(COCO_IMAGES, 512, generator=g, device="cuda"))
    captions = unit_rows(torch.randn(COCO_CAPTIONS, 512, generator=g, device="cuda"))
    counts = np.full(COCO_IMAGES, 5)
    picked = np.random.default_rng(15).choice(COCO_IMAGES, sum(COCO_EXTRA.values()),
                                              replace=False)
    counts[picked[:COCO_EXTRA[6]]], counts[picked[COCO_EXTRA[6]:]] = 6, 7
    check(int(counts.sum()) == COCO_CAPTIONS, f"{counts.sum()} captions")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(counts.max())
    table = np.where(slot[None] < counts[:, None], starts[:, None] + slot[None], -1)
    names = [f"COCO_train2017_{i:012d}.jpg" for i in range(COCO_IMAGES)]
    return DeviceVectorStore(names, images, captions, np.arange(COCO_CAPTIONS), table,
                             device="cuda")


def retrieval_reference(queries: torch.Tensor, images: torch.Tensor, got_idx: np.ndarray,
                        top_i: int) -> dict:
    """The ranked image ids against numpy in float64 (self-matches above
    0.9999 dropped): rows equal, or equal up to RAT_GAP."""
    q64, im64 = queries.double().cpu().numpy(), images.double().cpu().numpy()
    ref = q64 @ im64.T
    ref[ref > 0.9999] = -np.inf
    want = np.argsort(-ref, axis=1, kind="stable")[:, :top_i]
    equal, near = 0, 0
    for r, (g_, w_) in enumerate(zip(got_idx, want)):
        if np.array_equal(g_, w_):
            equal += 1
            continue
        gap = float(np.abs(ref[r, g_] - ref[r, w_]).max())
        check(gap < RAT_GAP, f"retrieval row {r}: ids {g_} against the reference's {w_} "
                             f"(similarities {gap} apart)")
        near += 1
    return {"rows": len(want), "equal": equal, "equal_up_to_gap": near, "gap": RAT_GAP}


def caption_rows_walked(store, img_idx: np.ndarray, top_k: int) -> torch.Tensor:
    """The caption rows of ranked images gathered by walking the table on the
    host, each image's captions in order, up to top_k, zeros after."""
    table = store.caption_table.cpu().numpy()
    out = torch.zeros(len(img_idx), top_k, store.caption_embeddings.shape[1], device="cuda")
    for r, row in enumerate(img_idx):
        caps = [c for i in row for c in table[i] if c >= 0][:top_k]
        out[r, : len(caps)] = store.caption_embeddings[torch.tensor(caps, device="cuda")]
    return out


def rat_model_params(cfg, rcfg, seed: int):
    """(trainable, frozen) of a RAT model: GPT-2 124M frozen, the mapper and
    the aggregator of ``rcfg`` trainable, from a seed."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import rat as R

    gen = torch.Generator().manual_seed(seed)
    tr, fz = C.init_params(gen, cfg, device="cuda")
    agg = R.init_aggregator(gen, rcfg, device="cuda")
    if agg:
        tr["aggregator"] = agg
    return tr, fz


def rat_loss_check(cfg, rcfg, tr, fz, batch, arrays) -> dict:
    """The fused RAT loss and its gradients with the kernels against
    ``use_kernels=False`` on the same weights and batch, by the train
    phase's bounds."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves
    from gpt2_image_captioning_tpu_torch.models import rat as R

    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    params = tree_leaves(tr)
    out = []
    for use in (None, False):
        s_, c = R.loss_fn_fused(tr, fz, cfg, rcfg, batch, arrays, BF16, use_kernels=use)
        loss = s_ / torch.clamp(c, min=1)
        loss.backward()
        out.append((float(loss.detach()), torch.cat([p.grad.float().flatten() for p in params])))
        for p in params:
            p.grad = None
    (lk, gk), (lp, gp) = out
    grad_err = float((gk - gp).norm() / gp.norm())
    check(abs(lk - lp) <= TRAIN_TOL["loss_bf16"], f"RAT loss {lk} against plain {lp}")
    check(grad_err <= TRAIN_TOL["grad_bf16"], f"RAT grads: relative error {grad_err}")
    return {"loss_kernels": lk, "loss_plain": lp, "grad_rel_err": grad_err,
            "tolerance": [TRAIN_TOL["loss_bf16"], TRAIN_TOL["grad_bf16"]]}


def timed_steps(step, tr, opt, sched, fz, batches, extra=None) -> tuple[float, dict, list]:
    """One warm-up step, then the batches timed with the launch counters set
    to 0 just before and read just after: (seconds, launches, losses)."""
    step(tr, opt, sched, fz, batches[0], extra)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = [step(tr, opt, sched, fz, b, extra) for b in batches[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, read_launches(), [float(l) for l, _ in out]


def rat_device_store_part() -> tuple[dict, dict]:
    """The fused RAT train step on the COCO-scale store: the retrieval's ids
    and rows, its device ms against its bound, the loss against the plain
    path, captions/s with the attention and the mean aggregators beside the
    plain step's, peak memory, one traced step."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.models import rat as R
    from gpt2_image_captioning_tpu_torch.retrieval import exact as E
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store = coco_store()
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    store_gb = (torch.cuda.memory_allocated() - held) / 1e9
    arrays = store.arrays()
    top_i, top_k = RAT_TOP["top_i"], RAT_TOP["top_k"]
    rng = np.random.default_rng(16)
    g = torch.Generator(device="cuda").manual_seed(16)
    own = torch.from_numpy(rng.choice(COCO_IMAGES, B // 2, replace=False)).cuda()
    queries = torch.cat([store.image_embeddings[own],
                         unit_rows(torch.randn(B - B // 2, 512, generator=g, device="cuda"))])
    sims, idx = E.top_images(E.similarities(queries, store.image_embeddings), top_i)
    ids = retrieval_reference(queries, store.image_embeddings, idx.cpu().numpy(), top_i)
    check(not (idx[: B // 2] == own[:, None]).any(), "a query retrieved its own image")
    fused = store.retrieve_fused(queries, top_i, top_k)
    walked = caption_rows_walked(store, idx.cpu().numpy(), top_k)
    check(torch.equal(fused, walked), "fused caption rows differ from the table walk")
    retrieve = lambda: E.fused_retrieve(queries, *arrays.values(), top_i=top_i, top_k=top_k)
    nbytes = 4 * (COCO_IMAGES * 512 + B * 512 + B * top_k * 512)  # store, queries, rows out
    bound_ms, bound_by = bound(nbytes, 2 * B * 512 * COCO_IMAGES, torch.float32)
    retrieval = {"ms": time_ms(retrieve), "device_ms": device_ms(retrieve, None,
                                                                  "rat_retrieval_trace.json"),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "multiply_adds": B * 512 * COCO_IMAGES, "bytes": nbytes,
                 "float32_product": "torch.matmul, TF32 off"}

    cfg = full_config()
    ds = Captions(RAT_STEPS * B + 40, 50, cfg.eos_token_id, 512, seed=17)  # the last padded
    ds.data["image_embedding"] = store.image_embeddings[
        torch.from_numpy(rng.integers(0, COCO_IMAGES, len(ds))).cuda()].cpu().numpy()
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher

    batches = list(Batcher(ds, B, seed=0).epoch(0))
    opt_cfg = optim.AdamWConfig(learning_rate=1e-4, num_training_steps=100)
    per_step = cfg.mapping.num_layers + cfg.gpt2.n_layer
    runs, counts, checks = {}, {}, {}
    for kind in ("attention", "mean"):
        rcfg = R.RATConfig(aggregation_type=kind, **RAT_TOP)
        tr, fz = rat_model_params(cfg, rcfg, seed=18)
        opt, sched = optim.make_optimizer(tr, opt_cfg)
        checks[kind] = rat_loss_check(cfg, rcfg, tr, fz, batches[0], arrays)
        step = loop.make_train_step(cfg, opt_cfg, BF16, device="cuda", rat_cfg=rcfg,
                                    fused_retrieval=True)
        torch.cuda.reset_peak_memory_stats()
        seconds, launches, losses = timed_steps(step, tr, opt, sched, fz, batches, arrays)
        steps = len(batches) - 1
        check(launches["flash_attention"] == per_step * steps,
              f"RAT {kind}: flash launches {launches['flash_attention']} != {per_step} x {steps}")
        check(all(np.isfinite(losses)), f"RAT {kind}: losses {losses}")
        runs[kind] = {"captions_per_s": B * steps / seconds, "ms_per_step": 1e3 * seconds / steps,
                      "losses": losses, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": launches}
        counts[f"rat_fused_{kind}"] = launches
        if kind == "mean":
            profiled = profile_train_step(lambda: step(tr, opt, sched, fz, batches[1], arrays),
                                          "rat_train_trace.json", "rat_train_profile")
        del tr, opt, sched
    plain_tr, fz = rat_model_params(cfg, R.RATConfig(), seed=18)
    opt, sched = optim.make_optimizer(plain_tr, opt_cfg)
    plain_step = loop.make_train_step(cfg, opt_cfg, BF16, device="cuda")
    seconds, _, _ = timed_steps(plain_step, plain_tr, opt, sched, fz, batches)
    del plain_tr, opt, sched, store, arrays
    torch.cuda.empty_cache()
    record = {"phase": "rat_fused", "model": MODEL_NAME + ", aggregator trainable",
              "store": {"images": COCO_IMAGES, "captions": COCO_CAPTIONS, "dim": 512,
                        "device_gb": store_gb, "made_s": store_s},
              "batch": B, "caption_length": 50, **RAT_TOP, "timed_steps": len(batches) - 1,
              "retrieval_ids": ids, "caption_rows_bit_equal": True, "retrieval": retrieval,
              "by_aggregation": runs, "loss_vs_plain": checks,
              "plain_step_captions_per_s": B * (len(batches) - 1) / seconds,
              "train_profile": profiled, "card": nvidia_smi()}
    return record, counts


def host_store_data():
    """HOST_IMAGES clustered unit vectors with HOST_CAPTIONS caption vectors
    each near its image: (names, images, grouped caption entries)."""
    rng = np.random.default_rng(19)
    centres = rng.normal(size=(RAT_CENTRES, 512))
    x = centres[rng.integers(0, RAT_CENTRES, HOST_IMAGES)] + 0.3 * rng.normal(size=(HOST_IMAGES, 512))
    images = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    names = [f"COCO_train2017_{i:012d}.jpg" for i in range(HOST_IMAGES)]
    entries = []
    for i, f in enumerate(names):
        caps = images[i] + 0.5 * rng.normal(size=(HOST_CAPTIONS, 512)) / np.sqrt(512)
        caps = (caps / np.linalg.norm(caps, axis=1, keepdims=True)).astype(np.float32)
        entries.append({"filenames": f, "embeddings": [
            {"caption_id": HOST_CAPTIONS * i + c, "embedding": torch.from_numpy(v)}
            for c, v in enumerate(caps)]})
    return names, images, entries


def ranked(store, queries: np.ndarray, top_i: int) -> list[list[str]]:
    """Each query's retrieved filenames, through the store's search API."""
    from gpt2_image_captioning_tpu_torch.retrieval import exact as E

    if isinstance(store, E.DeviceVectorStore):
        rows = E.retrieve_images_by_vector_similarity(store, queries, top_i)
    else:
        rows = store.retrieve_images_by_vector_similarity(queries, top_i)
    return [[f for f, _ in row] for row in rows]


def rat_host_store_part(hnsw_build) -> tuple[dict, dict]:
    """``train_rat`` with the flat and the HNSW store (one epoch each):
    captions/s, the host retrieval's ms a batch, and a traced window of the
    prefetched loop — its device idle share beside the fused step's; the
    flat store's ids against the device store's, HNSW's recall."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
    from gpt2_image_captioning_tpu_torch.models import rat as R
    from gpt2_image_captioning_tpu_torch.retrieval import exact as E
    from gpt2_image_captioning_tpu_torch.retrieval import store as S
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    names, images, entries = host_store_data()
    t0 = time.perf_counter()
    flat = S.create_store(names, images, entries, backend="flat")
    flat_build_s = time.perf_counter() - t0
    device = E.DeviceVectorStore.build(names, images, entries, device="cuda")
    top_i, top_k = RAT_TOP["top_i"], RAT_TOP["top_k"]
    rng = np.random.default_rng(20)
    queries = images[rng.choice(HOST_IMAGES, 512, replace=False)]
    want = ranked(device, queries, top_i)
    got = ranked(flat, queries, top_i)
    ref = queries.astype(np.float64) @ images.T.astype(np.float64)
    index = {f: i for i, f in enumerate(names)}
    flat_near = 0
    for r, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = float(np.abs(ref[r, [index[f] for f in a]] - ref[r, [index[f] for f in b]]).max())
            check(gap < RAT_GAP, f"flat store row {r}: {a} against the device store's {b}")
            flat_near += 1
    hnsw, hnsw_build_s = hnsw_build.result()
    recall = float(np.mean([len(set(a) & set(b)) / top_i
                            for a, b in zip(ranked(hnsw, queries, top_i), got)]))
    check(recall >= HNSW_RECALL_MIN, f"HNSW recall@{top_i} {recall} < {HNSW_RECALL_MIN}")

    cfg = full_config()
    rcfg = R.RATConfig(aggregation_type="mean", **RAT_TOP)
    ds = Captions(10 * B, 50, cfg.eos_token_id, 512, seed=21)
    ds.data["image_embedding"] = images[rng.integers(0, HOST_IMAGES, len(ds))]
    batches = list(Batcher(ds, B, seed=0).epoch(0))
    opt_cfg = optim.AdamWConfig(learning_rate=1e-4, num_training_steps=100)
    per_step = cfg.mapping.num_layers + cfg.gpt2.n_layer
    stores, record, counts = {"flat": flat, "hnsw": hnsw, "device": device}, {}, {}
    # one model trains through both host stores in turn, and one set of trees
    # runs the three traced windows (each with a fresh optimizer)
    model = R.RetrievalAugmentedTransformer(rcfg, cfg, generator=torch.Generator().manual_seed(22),
                                            policy=BF16, device="cuda")
    tr, fz = rat_model_params(cfg, rcfg, seed=23)
    for name, store in stores.items():
        def retrieve(batch, store=store):
            return dict(batch, retrieved_embeddings=np.asarray(
                R.retrieve(rcfg, store, batch["image_embedding"]), np.float32))

        rec = {}
        if name != "device":
            t0 = time.perf_counter()
            for b in batches[:5]:
                retrieve(b)
            rec["retrieval_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / 5
            out = RAT_RUN / f"train_rat_{name}"
            reset_launches()
            t0 = time.perf_counter()
            hist = loop.train_rat(ds, model, store, batch_size=B, num_epochs=1, device="cuda",
                                  outputs_dir=str(out), log_dir=str(out / "logs"),
                                  save_optimizer_state=False, **RAT_TOP)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches()
            steps = len(batches)
            check(launches["flash_attention"] == per_step * steps,
                  f"train_rat {name}: flash launches {launches['flash_attention']}")
            check(np.isfinite(hist["epoch_losses"][0]), f"train_rat {name}: {hist}")
            rec.update({"train_rat_epoch_s": seconds, "captions_per_s": B * steps / seconds,
                        "epoch_loss": hist["epoch_losses"][0], "launches": launches})
            counts[f"train_rat_{name}"] = launches
        # the loop of train(): retrieval prefetched a batch ahead (host
        # stores) or fused in the step (device), HOST_STEPS steps traced
        opt, sched = optim.make_optimizer(tr, opt_cfg)
        fused = name == "device"
        step = loop.make_train_step(cfg, opt_cfg, BF16, device="cuda", rat_cfg=rcfg,
                                    fused_retrieval=fused)
        extra = device.arrays() if fused else None
        window = batches[1: 1 + HOST_STEPS]
        step(tr, opt, sched, fz, window[0] if fused else retrieve(window[0]), extra)

        def run_window():
            feed = iter(window) if fused else loop._prefetched(iter(window), retrieve)
            for b in feed:
                step(tr, opt, sched, fz, b, extra)

        wall, events, dropped = traced(run_window, f"rat_{name}_window_trace.json")
        lo = min(e["ts"] for e in events)
        hi = max(e["ts"] + e["dur"] for e in events)
        rec["window"] = {"steps": len(window), "wall_s": wall, "ms_per_step": 1e3 * wall / len(window),
                         "device_busy_s": busy_us(events, lo, hi) * 1e-6,
                         "idle_share": 1.0 - busy_us(events, lo, hi) / (hi - lo),
                         "dropped_device_records": dropped}
        record[name] = rec
        del opt, sched
    del model, tr, fz
    for name in ("flat", "hnsw"):
        record[name]["prefetch_hides_retrieval"] = bool(
            record[name]["window"]["idle_share"] <= record["device"]["window"]["idle_share"] + 0.05)
    torch.cuda.empty_cache()
    return {"phase": "rat_host_stores", "images": HOST_IMAGES, "captions_per_image": HOST_CAPTIONS,
            "centres": RAT_CENTRES, **RAT_TOP, "batch": B,
            "flat_ids_vs_device": {"rows": len(got), "equal_up_to_gap": flat_near, "gap": RAT_GAP},
            "hnsw": {"M": 32, "ef_construction": 200, "ef_search": 64,
                     f"recall_at_{top_i}": recall, "bound": HNSW_RECALL_MIN,
                     "build_s_in_thread": hnsw_build_s},
            "flat_build_s": flat_build_s, "by_store": record, "card": nvidia_smi()}, counts


def clip_text_tokenizer():
    """A 49,408-token CLIP vocabulary built as ``tests/test_clip_tokenizer.py``
    builds its assets (the published files are not in the repository): the
    256 byte symbols, each also with ``</w>``, 48,894 word-final merges of
    two symbols, BOS and EOS last (49,406 and 49,407, ViT-B/32's ids)."""
    from gpt2_image_captioning_tpu_torch.data.tokenizer import CLIPBPETokenizer, bytes_to_unicode

    symbols = [bytes_to_unicode()[i] for i in range(256)]
    merges = [(a, b + "</w>") for a in symbols for b in symbols][:49408 - 2 - 512]
    vocab = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    tok = CLIPBPETokenizer({t: i for i, t in enumerate(vocab)}, merges)
    check(tok.eos_token_id == 49407 and tok.bos_token_id == 49406, "CLIP ids")
    return tok


def rat_extraction_part() -> tuple[dict, dict]:
    """``extract_caption_embeddings`` with the CLIP text tower at full size,
    bf16, b 256: captions/s, 12 flash launches a batch, the artifact; a
    batch's features against the plain path."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.embeddings.word_embeddings import (
        extract_caption_embeddings,
    )
    from gpt2_image_captioning_tpu_torch.models import clip as CL

    cfg = CL.CLIPTextConfig()
    tok = clip_text_tokenizer()
    params = CL.init_text(torch.Generator().manual_seed(24), cfg, device="cuda")
    rng = np.random.default_rng(25)
    n_images = EXTRACT_CAPTIONS // 4
    anns = [{"image_id": i % n_images, "id": i,
             "caption": " ".join(rng.choice(CAPTION_WORDS, size=int(rng.integers(5, 13))))}
            for i in range(EXTRACT_CAPTIONS)]
    ann_path = RAT_RUN / "captions_extract.json"
    ann_path.write_text(json.dumps({"images": [{"id": i} for i in range(n_images)],
                                    "annotations": anns}))
    ids = torch.from_numpy(tok([a["caption"] for a in anns[:EXTRACT_BATCH]])["input_ids"]).cuda()
    got = CL.encode_text(params, cfg, ids, policy=BF16)
    plain = CL.encode_text(params, cfg, ids, policy=BF16, use_kernels=False)
    diff = float((got - plain).abs().max())
    cos = float((got * plain).sum(-1).min())
    check(diff <= TOWER_TOL and cos >= TOWER_COS,
          f"text features: max diff {diff} (<= {TOWER_TOL}), min cosine {cos}")
    encode_ms = time_ms(lambda: CL.encode_text(params, cfg, ids, policy=BF16), iters=10)
    out = RAT_RUN / "train_clip_caption_embeddings.pt"
    reset_launches()
    t0 = time.perf_counter()
    result = extract_caption_embeddings(str(ann_path), str(out), params, cfg, tok,
                                        batch_size=EXTRACT_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    batches = -(-EXTRACT_CAPTIONS // EXTRACT_BATCH)
    check(launches["flash_attention"] == cfg.num_hidden_layers * batches,
          f"extraction flash launches {launches['flash_attention']}")
    read = torch.load(out, weights_only=False)
    vecs = torch.stack([e["embedding"] for item in read for e in item["embeddings"]])
    check(len(read) == n_images and len(vecs) == EXTRACT_CAPTIONS and len(result) == n_images,
          f"artifact: {len(read)} images, {len(vecs)} captions")
    check(bool(((vecs.norm(dim=1) - 1).abs() < 1e-3).all()), "caption features not unit norm")
    del params
    return {"phase": "rat_extraction", "tower": "CLIP ViT-B/32 text (49,408 x 512, 12 layers, "
            "8 heads, 77 positions)", "dtype": "bf16", "captions": EXTRACT_CAPTIONS,
            "batch": EXTRACT_BATCH, "seconds": seconds, "captions_per_s": EXTRACT_CAPTIONS / seconds,
            "encode_ms_per_batch": encode_ms,
            "encode_captions_per_s": EXTRACT_BATCH / encode_ms * 1e3,
            "features_vs_plain_max_diff": diff, "features_vs_plain_min_cos": cos,
            "tolerance": [TOWER_TOL, TOWER_COS], "launches": launches,
            "card": nvidia_smi()}, {"rat_extraction": launches}


def rat_sweep_part() -> tuple[list[dict], dict]:
    """``sweep.run_one`` for ids 18 and 19 of automation_config.yml (RAT,
    top_k 20, top_i 6, mean; 19 with GPT-2 unfrozen) on the pipeline phase's
    data with the train split's caption embeddings: the artifacts, GPT-2
    moved only when unfrozen, the test predictions decoded again through
    the rebuilt store from ``select_test_checkpoint``'s file equal, and RAT
    eval img/s in greedy and beam-4."""
    import os

    from gpt2_image_captioning_tpu_torch import sweep
    from gpt2_image_captioning_tpu_torch import training_pipeline as tp
    from gpt2_image_captioning_tpu_torch.core.config import load_config
    from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
    from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
    from gpt2_image_captioning_tpu_torch.evaluation.generation import (
        generate_predictions,
        generate_test_caption_predictions,
    )
    from gpt2_image_captioning_tpu_torch.retrieval import rat_pipeline as RP

    here = Path(__file__).resolve().parent
    root = RAT_RUN / "pipeline"
    tok, tok_dir = write_pipeline_data(root)
    cfg = load_config(str(pipeline_config(root)))
    names, images = load_embeddings(tp.embeddings_file(cfg, "train"))
    rng = np.random.default_rng(26)
    entries = []
    for i, (f, v) in enumerate(zip(names, images)):
        caps = v + 0.05 * rng.normal(size=(int(rng.integers(2, 6)), 512))
        entries.append({"filenames": f, "embeddings": [
            {"caption_id": 10 * i + c, "embedding": torch.from_numpy(
                (u / np.linalg.norm(u)).astype(np.float32))} for c, u in enumerate(caps)]})
    torch.save(entries, RP.caption_embeddings_file(cfg))
    plans = sweep.plan_runs(cfg, load_config(str(here / "automation_config.yml")), ["18", "19"])
    built, build = [], tp.build_model

    def keep(*a, **k):  # the models the pipeline trains
        m = build(*a, **k)
        built.append(m)
        return m

    old_env, old_cwd = os.environ.get("GPT2_TOKENIZER_DIR"), os.getcwd()
    os.environ["GPT2_TOKENIZER_DIR"] = str(tok_dir)
    os.chdir(root)
    tp.build_model = keep
    records, counts = [], {}
    try:
        for run_id, run_c, desc in plans:
            check(run_c.retrieval_augmentation and run_c.retrieval.top_k == 20
                  and run_c.retrieval.top_i == 6, f"id {run_id}: {run_c.retrieval}")
            t0 = time.perf_counter()
            reset_launches()
            sweep.run_one(run_c, run_id, str(root / "sweep"), desc, device="cuda")
            torch.cuda.synchronize()
            seconds = {"run_one": time.perf_counter() - t0}
            counts[f"rat_sweep_{run_id}"] = read_launches()
            pipeline_launches_used(counts[f"rat_sweep_{run_id}"], f"RAT sweep {run_id}")
            d = root / "sweep" / f"checkpoint_{run_id}"
            want = [f"config_{run_id}.yml", f"training_info_{run_id}.txt",
                    f"test_predictions_{run_id}.json", f"test_metrics_{run_id}.json",
                    "model_epoch_1.npz", "optimizer_epoch_1.npz", "best_model_epoch_1.npz",
                    "eval_results/epoch_1_val_predictions_rat.json",
                    "eval_results/epoch_1_val_metrics_rat.json",
                    "eval_results/val_metrics_summary.json"]
            missing = [f for f in want if not (d / f).exists()]
            check(not missing, f"RAT sweep {run_id}: missing {missing}")
            metrics = json.loads((d / f"test_metrics_{run_id}.json").read_text())
            trained = built[0]
            fresh = build(run_c, tok, device="cuda")
            change = gpt_rel_change(trained, fresh)
            unfrozen = not run_c.image_captioning.freeze_gpt_weights
            check((change > 0) == unfrozen, f"RAT sweep {run_id}: GPT-2 moved by {change}")
            t0 = time.perf_counter()
            fresh = RP.wrap_model(run_c, fresh)
            best = sweep.select_test_checkpoint(os.listdir(d))
            fresh.load_saved_parameters(str(d / best))
            store = RP.build_store(run_c, device="cuda")
            test_ds = CocoDataset(tp.embeddings_file(run_c, "test"),
                                  str(root / "coco" / "annotations" / "captions_val2014.json"),
                                  tokenizer=tok, max_length=run_c.max_caption_length)
            kw = dict(batch_size=run_c.validation.batch_size, max_length=run_c.max_caption_length,
                      db_store=store, top_k=run_c.retrieval.top_k, top_i=run_c.retrieval.top_i,
                      device="cuda")
            again = generate_test_caption_predictions(
                fresh, test_ds, output_path=str(root / "again.json"),
                temperature=run_c.validation.temperature, top_p=run_c.validation.top_p,
                decode_precision=run_c.validation.get("decode_precision"), **kw)
            first = json.loads((d / f"test_predictions_{run_id}.json").read_text())
            check(again == first, f"RAT sweep {run_id}: the test predictions of {best} "
                                  "decoded again through the rebuilt store differ")
            seconds["redecode"] = time.perf_counter() - t0
            eval_ips = {}
            modes = (("greedy", dict(temperature=0.0, decode_precision="bf16")),
                     ("beam", dict(decode="beam", beam_size=BEAM_K, decode_precision="bf16")))
            for mode, mkw in modes if run_id == plans[0][0] else ():  # timed once
                generate_predictions(fresh, test_ds, verbose=False, **mkw, **kw)  # warm-up
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                preds = generate_predictions(fresh, test_ds, verbose=False, **mkw, **kw)
                torch.cuda.synchronize()
                eval_ips[mode] = len(preds) / (time.perf_counter() - t0)
                counts[f"rat_eval_{mode}_{run_id}"] = read_launches()
                check(len(preds) == PIPELINE_SPLITS["test"][1], f"RAT eval {mode}: {len(preds)}")
            info = dict(line.split(": ", 1) for line in
                        (d / f"training_info_{run_id}.txt").read_text().splitlines())
            records.append({"phase": f"rat_sweep_{run_id}", "description": desc,
                            "checkpoint": best, "test_metrics": metrics, "training_info": info,
                            "gpt2_rel_change": change, "seconds_by_part": seconds,
                            "test_predictions_equal_on_redecode": True,
                            "rat_eval_img_per_s": eval_ips, "eval_precision": "bf16",
                            "launches": counts[f"rat_sweep_{run_id}"]})
            del trained, fresh, store
            built.clear()
            torch.cuda.empty_cache()
    finally:
        tp.build_model = build
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop("GPT2_TOKENIZER_DIR", None)
        else:
            os.environ["GPT2_TOKENIZER_DIR"] = old_env
    return records, counts


def rat_tiny_exact() -> dict:
    """Tiny float32 RAT greedy tokens through a device store (attention
    aggregator): the kernels' tokens equal the plain path's."""
    from gpt2_image_captioning_tpu_torch.models import rat as R
    from gpt2_image_captioning_tpu_torch.retrieval.exact import DeviceVectorStore

    cfg = tiny_config()
    rng = np.random.default_rng(27)
    images = rng.normal(size=(64, 16)).astype(np.float32)
    images /= np.linalg.norm(images, axis=1, keepdims=True)
    entries = [{"filenames": f"{i}.jpg", "embeddings": [
        {"caption_id": 4 * i + c, "embedding": torch.from_numpy(rng.normal(size=16)
                                                                 .astype(np.float32))}
        for c in range(i % 4)]} for i in range(64)]
    store = DeviceVectorStore.build([f"{i}.jpg" for i in range(64)], images, entries,
                                    device="cuda")
    model = R.RetrievalAugmentedTransformer(
        R.RATConfig(embed_dim=16, aggregation_type="attention", top_k=5, top_i=3), cfg,
        generator=torch.Generator().manual_seed(28), device="cuda")
    emb = images[:12] * 0.7 + rng.normal(size=(12, 16)).astype(np.float32) * 0.3
    reset_launches()
    got = model.generate(emb, db_store=store, max_length=12, temperature=0.0)
    torch.cuda.synchronize()
    launches = read_launches()
    want = model.generate(emb, db_store=store, max_length=12, temperature=0.0, use_kernels=False)
    check(torch.equal(got, want), f"tiny f32 RAT tokens differ:\n{got.cpu()}\n{want.cpu()}")
    plain = model.generate(emb, max_length=12, temperature=0.0)
    check(launches["prefill"] == 1 and launches["logits_argmax"] > 0, f"launches {launches}")
    return {"batch": 12, "max_length": 12, "tokens_equal": True,
            "rows_changed_by_retrieval": int((plain != got).any(dim=1).sum()),
            "launches": launches}


def rat_phase() -> tuple[list[dict], dict]:
    """Retrieval-augmented training on the card (RAT_* above): the fused step
    on the COCO-scale device store, ``train_rat`` with the host stores,
    caption extraction with the CLIP text tower, a RAT sweep of ids 18 and
    19, tiny float32 RAT tokens exact."""
    import concurrent.futures

    from gpt2_image_captioning_tpu_torch.retrieval import store as S

    shutil.rmtree(RAT_RUN, ignore_errors=True)
    RAT_RUN.mkdir()
    seconds = {}

    def build_hnsw():  # the ctypes calls leave the interpreter lock to the card's work
        t0 = time.perf_counter()
        store = S.create_store(*host_store_data(), backend="hnsw")
        return store, time.perf_counter() - t0

    records, counts = [], {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        hnsw_build = pool.submit(build_hnsw)
        for name, part in (("fused", rat_device_store_part), ("extraction", rat_extraction_part),
                           ("sweep", rat_sweep_part),
                           ("host_stores", lambda: rat_host_store_part(hnsw_build))):
            t0 = time.perf_counter()
            got, c = part()
            seconds[name] = time.perf_counter() - t0
            records += got if isinstance(got, list) else [got]
            counts.update(c)
    tiny = rat_tiny_exact()
    counts["rat_tiny_f32"] = tiny.pop("launches")
    shutil.rmtree(RAT_RUN, ignore_errors=True)
    records.insert(0, {"phase": "rat", "seconds_by_part": seconds, "tiny_f32_exact": tiny,
                       "card": nvidia_smi()})
    return records, counts


# ---------------------------------------------------------------------------
# Phase: data parallelism (``--only parallel``)
# ---------------------------------------------------------------------------

PARALLEL_RUN = Path(__file__).resolve().parent / "chip_parallel"  # removed at the end
PARALLEL_RANK_TIMEOUT = 480  # seconds: a rank still running after it is killed
PAR_TINY_B = 5  # rows of the tiny decodes: dp 2 does not divide them
PAR_TINY_TOL = 1e-5  # tiny float32 train steps against one process: losses, step-1 gradients
# the tiny steps' AdamW updates against one process's, each leaf by its norm:
# a wrong sum over the ranks or a rank-local mean is off by far more
PAR_TINY_UPDATE_TOL = 1e-3
PAR_CONTINUOUS = dict(slots=2 * 256, segment=4, bursts=8, admit=32, max_length=50)
PAR_CONTINUOUS_REQUESTS = 1024
PAR_EXTRACT = ((256, 256), (256, 100))  # CLIP extraction: (batch, real rows) a batch
PAR_EXTRACT_TOL = 1e-2  # features of the two ranks against one process's, bf16
# the kernel families the full-width part must launch inside every rank
PAR_FAMILIES = ("fused_linear", "logits_argmax", "decode_attention", "prefill",
                "flash_attention", "patch_embed")
# tp and pp ranks: the families they must launch, and at tp the step
# kernels, which the layerwise tp branch never runs
TP_FAMILIES = ("decode_attention", "flash_attention", "patch_embed")
TP_IDLE = ("fused_linear", "prefill", "logits_argmax", "logits", "logits_topk", "logits_sample",
           "rowquant")
PP_FAMILIES = ("flash_attention",)
PP_MICRO = 4  # microbatches of the pp train step: 32 rows each at b 128
TP_IMAGE_TOKENS = 20  # the tp CaptionService's captions (the greedy request's run to 50)
# a tp or pp bf16 train step against one process's: the loss, absolute;
# the clipped gradients by grad_agreement within TRAIN_TOL["grad_bf16"] (two
# computations of one bf16 gradient); the update of the trainable leaves, by
# norm, no farther from one process's than one process's own step on the
# flash kernel's plain twin (measured in the same run: AdamW's first step
# divides each element by its own gradient, so the bf16 noise of the
# near-zero gradients, the mapper's key bias exactly zero, becomes steps of
# the learning rate's size; a 2 % bound sits below that floor)
MP_TRAIN_TOL = {"loss": 2e-3}
# sequence parallelism: an sp-2 pair in both forms.  Tiny float32 at
# tiny_config's GPT-2 with an MLP mapper (4 prefix rows + captions of 11 =
# 15, padded to 16), GPT-2 frozen and unfrozen, held to one process's
# mean_loss by PAR_TINY_TOL (loss relative, each gradient leaf by its norm);
# full width as parallel_train_step's model and batch (65 rows, padded to
# 66), held by MP_TRAIN_TOL["loss"] and, on the gradients, by SP_GRAD_TOL
# (the largest leaf-wise max |got - ref| / max |ref|: two computations of
# one bf16 gradient, as grad_agreement measures the tp and pp steps)
SP_FORMS = ("allgather", "ring")
SP_TINY_L = 11
SP_GRAD_TOL = 5e-2
# the HTTP endpoints over the dp pair's services, PAR_HTTP_REQUESTS JPEG
# POSTs (224 px after the crop) to each endpoint from a client process: at
# full width (CLIP B/32 + the serving model, bf16 decode), every served
# token teacher-forced on the plain path from the embedding its rank
# encoded, the captions not all one; and on tiny_pixel_model (float32, so
# that the captions can equal one process's exactly)
PAR_HTTP_REQUESTS = 128
PAR_HTTP_SETTINGS = {
    "full": {"fixed": dict(batch_size=B, max_length=50, decode_precision="bf16"),
             "continuous": dict(slots=2 * 64, segment=4, bursts=8, admit=32, max_length=50,
                                decode_precision="bf16")},
    "tiny": {"fixed": dict(batch_size=8, max_length=12),
             "continuous": dict(slots=16, segment=2, bursts=2, admit=4, max_length=12)}}
PAR_HTTP_FAMILIES = ("patch_embed", "flash_attention", "prefill", "fused_linear",
                     "decode_attention", "logits_argmax")


def parallel_tiny(mesh) -> dict:
    """Tiny float32 runs of every dp path, on ``mesh`` (None: one process, the
    reference): greedy, W8A8 and beam-4 ``generate`` of 5 rows, continuous
    greedy serving (4 slots: 2 a rank at dp 2), and three train steps on
    global batches of 8, each rank on its ``Batcher`` shard.  The steps
    train an MLP mapper: the transformer mapper's attention key bias has an
    exactly-zero gradient, whose float32 noise Adam scales up to the size of
    an update (as ``tests/test_torch_epoch.py`` notes)."""
    from gpt2_image_captioning_tpu_torch import F32, ImageCaptioningModel
    from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.mapping import MLPMappingConfig
    from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    cfg = tiny_config()
    tr, fz = C.init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.normal(size=(PAR_TINY_B, 16)).astype(np.float32)).cuda()
    out = {"greedy": C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0, mesh=mesh),
           "int8": C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0,
                              decode_quant=True, mesh=mesh),
           "beam": C.beam_generate(tr, fz, cfg, emb, max_length=12, beam_size=BEAM_K,
                                   mesh=mesh)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    model = ImageCaptioningModel(cfg, tokenizer=synthetic_tokenizer(cfg.gpt2.vocab_size),
                                 policy=F32, device="cuda")
    model.trainable, model.frozen = tr, fz
    svc = ContinuousCaptionService(model, slots=4, segment=2, bursts=2, admit=2, max_length=12,
                                   mesh=mesh)
    embs = rng.normal(size=(9, 16)).astype(np.float32)
    out["continuous"] = served_ids(svc, embs, rng.integers(2, 13, size=9))

    cfg = dataclasses.replace(cfg, mapping=MLPMappingConfig(prefix_length=4, embed_dim=16,
                                                            gpt_dim=cfg.gpt2.n_embd))
    tr, fz = C.init_params(torch.Generator().manual_seed(3), cfg, device="cuda")
    ds = Captions(3 * 8 - 3, 24, cfg.eos_token_id, 16, seed=4)  # the last batch padded
    coords = {} if mesh is None else dict(process_index=mesh.dp_rank, process_count=mesh.dp)
    opt_cfg = optim.AdamWConfig(learning_rate=1e-3, num_training_steps=3)
    optimizer, scheduler = optim.make_optimizer(tr, opt_cfg)
    step = loop.make_train_step(cfg, opt_cfg, F32, device="cuda", mesh=mesh)
    def leaves(grad=False):
        return {k: (v.grad if grad else v).detach().cpu().clone()
                for k, v in flatten_with_paths(tr).items()}

    out["train_before"], out["train_losses"] = leaves(), []
    for i, b in enumerate(Batcher(ds, 8, seed=0, **coords).epoch(0)):
        out["train_losses"].append(float(step(tr, optimizer, scheduler, fz, b)[0]))
        if i == 0:  # the first step's gradient, summed over the ranks and clipped
            out["train_grads"] = leaves(grad=True)
    out["train_params"] = leaves()
    return out


def parallel_train_step(mesh, use_kernels: bool | None = None) -> dict:
    """One bf16 train step of :func:`train_path`'s model at b 128 in one
    process (``mesh`` None) or on ``mesh``: dp (each rank its 64 rows), tp
    (GPT-2's slices, every rank the 128 rows) or a pipeline (its stage's
    layers, PP_MICRO microbatches).  The step's loss, the trainable leaves
    before and after it and their clipped gradients (on the host; GPT-2 is
    frozen, so the trainable tree is the replicated mapper, updated in
    place).  ``use_kernels=False``: one process on the flash kernel's plain
    twin."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig
    from gpt2_image_captioning_tpu_torch.parallel import pipeline as PP
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    cfg = C.CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                            mapping=TransformerMappingConfig(512, 768, 15, 10))
    tr, fz = C.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    coords = ({} if mesh is None or mesh.dp == 1
              else dict(process_index=mesh.dp_rank, process_count=mesh.dp))
    batch = next(Batcher(Captions(B, 50, cfg.eos_token_id, 512, seed=1), B, seed=0,
                         **coords).epoch(0))
    opt_cfg = optim.AdamWConfig(learning_rate=1e-4, num_training_steps=100)
    if isinstance(mesh, PP.PipelineMesh):
        tr_local, fz_local = PP.shard_stage_params(tr, fz, cfg, mesh)
        step = PP.make_pipeline_train_step(cfg, opt_cfg, mesh, BF16, num_microbatches=PP_MICRO)
    else:
        tr_local, fz_local = C.shard_params(tr, fz, cfg, mesh)
        step = loop.make_train_step(cfg, opt_cfg, BF16, device="cuda", mesh=mesh,
                                    use_kernels=use_kernels)
    optimizer, scheduler = optim.make_optimizer(tr_local, opt_cfg)
    before = {k: v.detach().cpu().clone() for k, v in flatten_with_paths(tr).items()}
    loss, norm = step(tr_local, optimizer, scheduler, fz_local, batch)
    flat = flatten_with_paths(tr)
    return {"loss": float(loss), "grad_norm": float(norm), "before": before,
            "after": {k: v.detach().cpu() for k, v in flat.items()},
            "grads": {k: v.grad.detach().float().cpu() for k, v in flat.items()}}


def tiny_tp_config():
    """:func:`tiny_config` at head counts tp 2 divides: GPT-2 2 x 256 = 4
    heads of 64 (2 a rank), its vocabulary of 293 padded to 294 rows at tp
    2; the transformer mapper's 2 heads of 128."""
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig

    cfg = tiny_config()
    return dataclasses.replace(
        cfg, gpt2=dataclasses.replace(cfg.gpt2, n_embd=256, n_head=4),
        mapping=TransformerMappingConfig(16, 256, prefix_length=4, hidden_length=3,
                                         num_layers=2, num_heads=2))


def parallel_tiny_tp(mesh) -> dict:
    """Tiny float32 greedy and beam-4 ``generate`` of 5 rows at
    :func:`tiny_tp_config`, kernels on: on a tp ``mesh`` (the rank's
    slices, the layerwise decode) or in one process (None: the step
    kernels)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    cfg = tiny_tp_config()
    tr, fz = C.init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
    tr, fz = C.shard_params(tr, fz, cfg, mesh)
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.normal(size=(PAR_TINY_B, 16)).astype(np.float32)).cuda()
    out = {"greedy": C.generate(tr, fz, cfg, emb, max_length=12, temperature=0.0, mesh=mesh),
           "beam": C.beam_generate(tr, fz, cfg, emb, max_length=12, beam_size=BEAM_K,
                                   mesh=mesh)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def timed_part(name, fn, seconds: dict, counts: dict):
    """``fn()`` with every launch counter set to 0 just before and read just
    after, into ``counts[name]``, its seconds (to a synchronize) into
    ``seconds[name]``."""
    reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds[name], counts[name] = time.perf_counter() - t0, read_launches()
    return result


def parallel_full_tp(mesh) -> dict:
    """The full-width part of a tp rank, launch counts by part: greedy
    ``generate`` of a 128-image request (bf16, every rank all rows),
    ``CaptionService`` from 128 images' pixels (CLIP B/32, captions of up to
    TP_IMAGE_TOKENS), one bf16 train step at b 128; rank 0 holds the greedy
    tokens to the plain path."""
    from gpt2_image_captioning_tpu_torch.serving import CaptionService

    out, counts, seconds = {}, {}, {}
    model, reqs = serving_model()
    model.tokenizer = synthetic_tokenizer(V)
    emb = torch.from_numpy(reqs[0]).cuda()
    model.generate(emb[:8], max_length=8, temperature=0.0, decode_precision="bf16",
                   mesh=mesh)  # warm-up
    tokens = timed_part("greedy", lambda: model.generate(
        emb, max_length=50, temperature=0.0, decode_precision="bf16", mesh=mesh),
        seconds, counts)
    check(tuple(tokens.shape) == (B, 50), f"tp greedy: shape {tuple(tokens.shape)}")
    out["greedy_tokens"] = tokens.cpu().numpy()
    if mesh.is_main:
        worst, n, agree = teacher_forced(model, emb, tokens)
        check(worst <= TF_TOL, f"tp greedy: a token is {worst} below the plain max")
        out["greedy_teacher_forced"] = {"worst_deficit": worst, "tolerance": TF_TOL,
                                        "tokens_checked": n, "share_plain_argmax": agree}
    _, clip_cfg, clip_params = tower_params("clip")
    svc = CaptionService(model, clip_params, clip_cfg, batch_size=B,
                         max_length=TP_IMAGE_TOKENS, decode_precision="bf16", mesh=mesh)
    pixels = np.random.default_rng(4).integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8)
    out["image_captions"] = timed_part("images", lambda: svc.caption_prepped(pixels),
                                       seconds, counts)
    del model, svc, clip_params
    torch.cuda.empty_cache()
    out["train"] = timed_part("train", lambda: parallel_train_step(mesh), seconds, counts)
    out["seconds"], out["launches"] = seconds, counts
    return out


def parallel_full_pp(mesh) -> dict:
    """The full-width part of a pp rank: one bf16 train step at b 128 in
    PP_MICRO microbatches, its launch counts and seconds."""
    out, counts, seconds = {}, {}, {}
    out["train"] = timed_part("train", lambda: parallel_train_step(mesh), seconds, counts)
    out["seconds"], out["launches"] = seconds, counts
    return out


def parallel_extract(mesh, path: Path) -> tuple[list[str], np.ndarray]:
    """CLIP B/32 extraction (bf16, seeded weights) of PAR_EXTRACT's batches
    from an in-memory loader, on ``mesh`` or in one process, written to
    ``path``."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.embeddings.extract import _run_extraction
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS

    mod, cfg, params = tower_params("clip")
    rng = np.random.default_rng(9)
    loader = []
    for i, (bs, n) in enumerate(PAR_EXTRACT):
        batch = rng.integers(0, 256, size=(bs, 224, 224, 3), dtype=np.uint8)
        batch[n:] = batch[n - 1]
        loader.append(([f"img_{i}_{j:04d}.jpg" for j in range(n)], batch, np.arange(bs) < n))
    return _run_extraction(loader, str(path), lambda u8: mod.encode_image_u8(
        params, cfg, u8, SPECS["clip"], policy=BF16), "CLIP", mesh=mesh, device="cuda")


def parallel_full(mesh) -> dict:
    """The full-width part of a gloo rank, launch counts by part: greedy
    ``generate`` of a 128-image request (64 rows a rank), continuous greedy
    serving over 2 x 256 slots, both HTTP endpoints over dp services, tiny
    and on this model from pixels (:func:`http_dp`, one client process for
    all their POSTs), one bf16 train step at b 128, CLIP extraction at b 256;
    rank 0 holds the served tokens to the plain path."""
    from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService

    out, counts, seconds = {}, {}, {}
    model, reqs = serving_model()
    model.tokenizer = synthetic_tokenizer(V)
    eos = model.cfg.eos_token_id
    emb = torch.from_numpy(reqs[0]).cuda()
    model.generate(emb, max_length=50, temperature=0.0, decode_precision="bf16")  # warm-up

    def part(name, fn):
        return timed_part(name, fn, seconds, counts)

    tokens = part("greedy", lambda: model.generate(emb, max_length=50, temperature=0.0,
                                                   decode_precision="bf16", mesh=mesh))
    check(tuple(tokens.shape) == (B, 50), f"dp greedy: shape {tuple(tokens.shape)}")
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(PAR_CONTINUOUS_REQUESTS, 512)).astype(np.float32)
    caps = rng.integers(8, 51, size=PAR_CONTINUOUS_REQUESTS)
    svc = ContinuousCaptionService(model, decode_precision="bf16", seed=0, mesh=mesh,
                                   **PAR_CONTINUOUS)
    ids = part("continuous", lambda: served_ids(svc, embs, caps))
    out["continuous_stats"] = {k: svc.stats[k] for k in ("occupancy", "macros", "host_reads")}
    bodies = http_bodies(PAR_HTTP_REQUESTS, seed=21)
    with http_client_pool() if mesh.is_main else contextlib.nullcontext() as pool:
        out["http_tiny"] = part("http_tiny", lambda: http_dp(mesh, "tiny", bodies, pool))
        out["http"] = part("http", lambda: http_dp(mesh, "full", bodies, pool, model))
    if mesh.is_main:
        worst, n, agree = teacher_forced(model, emb, tokens)
        check(worst <= TF_TOL, f"dp greedy: a token is {worst} below the plain max")
        out["greedy_teacher_forced"] = {"worst_deficit": worst, "tolerance": TF_TOL,
                                        "tokens_checked": n, "share_plain_argmax": agree}
        for r, c in zip(ids, caps):
            check(len(r) <= c and all(0 <= t < eos for t in r), "a served caption breaks its cap")
        out["continuous_checked"] = check_served_tokens(model, embs, *served_matrix(ids, caps, eos),
                                                        sampled=False)
    del model, svc
    torch.cuda.empty_cache()
    out["train"] = part("train", lambda: parallel_train_step(mesh))
    out["extraction"] = part("extraction", lambda: parallel_extract(
        mesh, PARALLEL_RUN / "extract_dp.pt"))
    out["seconds"], out["launches"] = seconds, counts
    return out


def sp_tiny_batch() -> dict:
    rng = np.random.default_rng(6)
    am = np.ones((8, SP_TINY_L), np.int32)
    am[:, -2:] = 0
    labels = rng.integers(0, 292, (8, SP_TINY_L)).astype(np.int32)
    labels[am == 0] = -100
    return {"token_ids": rng.integers(0, 292, (8, SP_TINY_L)).astype(np.int32),
            "labels": labels, "attention_mask": am,
            "image_embedding": rng.normal(size=(8, 16)).astype(np.float32)}


def one_process_loss(tr, fz, cfg, batch, policy) -> dict:
    """``mean_loss`` and its gradients in this process, kernels on, on the
    host; leaves no gradient behind."""
    from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    params = flatten_with_paths(tr)
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(batch[k], device="cuda")
             for k in ("token_ids", "labels", "attention_mask", "image_embedding")}
    loss = C.mean_loss(tr, fz, cfg, batch, policy)
    loss.backward()
    out = {"loss": float(loss.detach()), "grads": {k: p.grad.float().cpu()
                                                   for k, p in params.items()}}
    for p in params.values():
        p.grad = None
    return out


def sp_loss(fn, tr, fz, batch) -> dict:
    from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths

    loss, grads = fn(tr, fz, batch)
    return {"loss": float(loss), "grads": {k: v.float().cpu()
                                           for k, v in flatten_with_paths(grads).items()}}


def sp_tiny(mesh) -> dict:
    """Tiny float32 loss and gradients (SP_* above), GPT-2 unfrozen and
    frozen, kernels on: on an sp ``mesh`` in both forms (keys
    ``f{freeze}_{form}``), or in one process (None: ``mean_loss``, keys
    ``f{freeze}``)."""
    from gpt2_image_captioning_tpu_torch import F32
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.mapping import MLPMappingConfig
    from gpt2_image_captioning_tpu_torch.parallel import sequence as S

    out, batch = {}, sp_tiny_batch()
    for freeze in (False, True):
        cfg = dataclasses.replace(tiny_config(), freeze_gpt_weights=freeze, mapping=MLPMappingConfig(
            prefix_length=4, embed_dim=16, gpt_dim=tiny_config().gpt2.n_embd))
        tr, fz = C.init_params(torch.Generator().manual_seed(3), cfg, device="cuda")
        if mesh is None:
            out[f"f{int(freeze)}"] = one_process_loss(tr, fz, cfg, batch, F32)
            continue
        for form in SP_FORMS:
            out[f"f{int(freeze)}_{form}"] = sp_loss(
                S.make_sp_loss_and_grad(cfg, mesh, F32, ring=form == "ring"), tr, fz, batch)
    return out


def sp_full(mesh) -> dict:
    """Full width, bf16, kernels on: :func:`parallel_train_step`'s model
    (GPT-2 124M frozen, config.yml's mapper) and b 128 batch (captions
    padded to 50: 65 rows); on an sp ``mesh`` each form's loss and
    gradients with its launch counts and seconds, or one process's
    ``mean_loss`` (None)."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig
    from gpt2_image_captioning_tpu_torch.parallel import sequence as S

    cfg = C.CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                            mapping=TransformerMappingConfig(512, 768, 15, 10))
    tr, fz = C.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    batch = next(Batcher(Captions(B, 50, cfg.eos_token_id, 512, seed=1), B, seed=0).epoch(0))
    if mesh is None:
        return one_process_loss(tr, fz, cfg, batch, BF16)
    out, counts, seconds = {"n_layer": cfg.gpt2.n_layer}, {}, {}
    for form in SP_FORMS:
        fn = S.make_sp_loss_and_grad(cfg, mesh, BF16, ring=form == "ring")
        out[form] = timed_part(form, lambda: sp_loss(fn, tr, fz, batch), seconds, counts)
    out["seconds"], out["launches"] = seconds, counts
    return out


def sp_checks(ranks: list[dict], refs: dict) -> tuple[dict, dict]:
    """The sp pair held to this process's runs (:func:`sp_tiny`,
    :func:`sp_full`): the ranks' losses and gradients equal to each other,
    within PAR_TINY_TOL / MP_TRAIN_TOL and SP_GRAD_TOL of one process's; the
    all-gather form launching the flash kernel once a layer more than the
    ring form (its blocks' attention; both run the mapper's).  Returns (the
    record, launch counts by rank)."""
    check([r["backend"] for r in ranks] == ["gloo"] * 2,
          f"sp backends {[r['backend'] for r in ranks]}")
    tiny = {}
    for key, got in ranks[0]["tiny"].items():
        want = refs["tiny"][key.split("_")[0]]
        check(all(r["tiny"][key]["loss"] == got["loss"] and all(
            torch.equal(r["tiny"][key]["grads"][k], v) for k, v in got["grads"].items())
            for r in ranks), f"sp tiny {key}: the ranks differ")
        loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        grad_err = rel_err(got["grads"], want["grads"])
        check(loss_err <= PAR_TINY_TOL and grad_err[0] <= PAR_TINY_TOL,
              f"sp tiny {key}: loss {loss_err}, gradient {grad_err} off one process")
        tiny[key] = {"loss_rel_err": loss_err, "grad_rel_err": list(grad_err)}
    full, counts = {}, {}
    ref = refs["full"]
    for form in SP_FORMS:
        got = ranks[0]["full"][form]
        check(all(r["full"][form]["loss"] == got["loss"] for r in ranks),
              f"sp {form}: the ranks' losses differ")
        loss_err, grad_err = abs(got["loss"] - ref["loss"]), grad_agreement(got, ref)
        check(loss_err <= MP_TRAIN_TOL["loss"] and grad_err[0] <= SP_GRAD_TOL,
              f"sp {form}: loss {got['loss']} against {ref['loss']}, gradients {grad_err}")
        full[form] = {"loss": got["loss"], "loss_abs_err": loss_err,
                      "grad_rel_err": list(grad_err)}
    n_layer = ranks[0]["full"]["n_layer"]
    for r, got in enumerate(ranks):
        launches = got["full"]["launches"]
        flash = {form: launches[form]["flash_attention"] for form in SP_FORMS}
        check(flash["allgather"] - flash["ring"] == n_layer and flash["ring"] > 0,
              f"sp rank {r}: flash launches by form {flash} (the all-gather form's blocks: "
              f"{n_layer} more)")
        counts[f"parallel_sp_rank{r}"] = {k: sum(c[k] for c in launches.values())
                                          for k in launches["ring"]}
    record = {
        "mesh": "(dp, sp) = (1, 2), two gloo ranks sharing the card",
        "tiny_f32": {"cases": tiny, "tolerance": PAR_TINY_TOL, "ranks_equal": True,
                     "config": "GPT-2 2 x 192 (3 heads of 64), vocab 293; MLP mapper, prefix 4; "
                               f"b 8, captions of {SP_TINY_L}: 15 rows padded to 16"},
        "full_width": {"batch": B, "rows": "65 padded to 66", "loss_one_process": ref["loss"],
                       **full, "tolerance": {**MP_TRAIN_TOL, "grad": SP_GRAD_TOL},
                       "seconds_by_form": [g["full"]["seconds"] for g in ranks],
                       "launches_by_rank_and_form": [g["full"]["launches"] for g in ranks]},
    }
    return record, counts


def http_dp_services(mesh, size: str, model=None) -> dict:
    """``CaptionService`` and ``ContinuousCaptionService`` by kind on
    ``mesh`` (None: one process), PAR_HTTP_SETTINGS[size]: ``full`` CLIP
    B/32 + ``model``, :func:`serving_model`'s captioner with the synthetic
    tokenizer; ``tiny`` :func:`tiny_pixel_model` in float32."""
    from gpt2_image_captioning_tpu_torch import F32
    from gpt2_image_captioning_tpu_torch.serving import CaptionService, ContinuousCaptionService

    if size == "full":
        _, vcfg, vparams = tower_params("clip")
        policy = {}
    else:
        model, vparams, vcfg = tiny_pixel_model()
        policy = {"policy": F32}
    kw = PAR_HTTP_SETTINGS[size]
    return {"fixed": CaptionService(model, vparams, vcfg, mesh=mesh, **policy, **kw["fixed"]),
            "continuous": ContinuousCaptionService(model, vparams, vcfg, mesh=mesh,
                                                   **kw["continuous"])}


def http_dp_prepped(bodies: list[bytes], spec) -> np.ndarray:
    """The bodies' pixels, decoded, resized and cropped as the handlers
    do."""
    import io

    from PIL import Image

    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import resize_and_crop

    return np.stack([resize_and_crop(np.asarray(Image.open(io.BytesIO(b)).convert("RGB"),
                                                np.uint8), spec)
                     for b in bodies])


def http_dp_reference() -> dict:
    """One process's tiny float32 captions of the bodies' pixels from both
    services."""
    services = http_dp_services(None, "tiny")
    prepped = http_dp_prepped(http_bodies(PAR_HTTP_REQUESTS, seed=21), services["fixed"].spec)
    cont = services["continuous"]
    rids = [cont.submit_prepped(p) for p in prepped]
    cont.drain()
    return {"fixed": services["fixed"].caption_prepped(prepped),
            "continuous": [cont.pop_result(r) for r in rids]}


def http_dp(mesh, size: str, bodies: list[bytes], pool, model=None) -> dict:
    """Both endpoints over dp services of several ranks (PAR_HTTP_SETTINGS
    [size], ``model`` the full size's captioner): the main rank serves each
    on port 0 and takes the JPEG ``bodies`` as POSTs from ``pool``'s client
    process, then shuts it down; every other rank runs its follower's
    ``serve_forever()`` until then.  Full width, each rank also keeps the
    embedding of every body's image it encoded (``embeddings``, NaN rows
    for the others), for the parent's teacher-forced check."""
    import threading

    from gpt2_image_captioning_tpu_torch.serving import serve_http, serve_http_continuous

    out = {}
    services = http_dp_services(mesh, size, model)
    index = {p.tobytes(): i for i, p in enumerate(http_dp_prepped(bodies,
                                                                  services["fixed"].spec))}
    for kind, svc in services.items():
        embs = np.full((PAR_HTTP_REQUESTS, svc.model.cfg.mapping.embed_dim), np.nan, np.float32)
        encode = svc._encode

        def recorded(params, u8, encode=encode, embs=embs):
            e = encode(params, u8)
            for px, row in zip(u8.cpu().numpy(), e.float().cpu().numpy()):
                embs[index[px.tobytes()]] = row
            return e

        if size == "full":
            svc._encode = recorded
        server = (serve_http if kind == "fixed" else serve_http_continuous)(svc, port=0)
        if not mesh.is_main:
            server.serve_forever()
            out[kind] = {"server": type(server).__name__, "images": svc.stats["images"],
                         "embeddings": embs}
            continue
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        answers, latency, seconds = http_post_all(port, bodies, ["/caption"] * len(bodies), pool)
        health = http_raw(port, "GET", "/healthz")
        server.shutdown()
        server.server_close()
        thread.join(60)
        check(all(status == 200 for status, _ in answers) and health[0] == 200,
              f"HTTP over dp, {size} {kind}: statuses {sorted({a[0] for a in answers})}, "
              f"healthz {health}")
        out[kind] = {"server": type(server).__name__, "images": health[1]["images"],
                     "captions": [a[1]["caption"] for a in answers], "embeddings": embs,
                     **serving_stats(answers, latency, seconds)}
    return out


def http_dp_checks(ranks: list[dict], want_tiny: dict) -> dict:
    """Each endpoint over the dp pair, on the main rank's answers, the
    follower's service having captioned as many images: tiny float32, the
    captions equal to one process's of the same pixels; full width, every
    rank having launched PAR_HTTP_FAMILIES, the captions not all one, every
    image encoded by one rank or the other, and every served token
    teacher-forced on the plain path from its image's embedding (within
    TF_TOL of the plain max)."""
    model = None
    record = {}
    for size in ("tiny", "full"):
        part = "http" if size == "full" else "http_tiny"
        for kind in ("fixed", "continuous"):
            main, follower = ranks[0]["full"][part][kind], ranks[1]["full"][part][kind]
            name = f"HTTP over dp, {size} {kind}"
            check(follower["server"] == "_Follower" and follower["images"] == main["images"],
                  f"{name}: follower {follower['server']} {follower['images']} images against "
                  f"main {main['images']}")
            rec = {k: main[k] for k in ("requests", "seconds", "requests_per_s",
                                        "latency_p50_s", "latency_p95_s", "images")}
            rec["distinct_captions"] = len(set(main["captions"]))
            if size == "tiny":
                check(main["captions"] == want_tiny[kind],
                      f"{name}: captions differ from one process's")
                rec["captions_equal_one_process"] = True
            else:
                check(rec["distinct_captions"] > 1, f"{name}: every image got one caption")
                embs = np.where(np.isnan(main["embeddings"]), follower["embeddings"],
                                main["embeddings"])
                check(not np.isnan(embs).any(), f"{name}: an image no rank encoded")
                if model is None:
                    model, _ = serving_model()
                eos = model.cfg.eos_token_id
                ids = [caption_ids(c) for c in main["captions"]]
                caps = [PAR_HTTP_SETTINGS["full"][kind]["max_length"]] * len(ids)
                rec["checked"] = check_served_tokens(model, embs, *served_matrix(ids, caps, eos),
                                                     sampled=False)
            record[f"{size}_{kind}"] = rec
    for r, got in enumerate(ranks):
        launches = got["full"]["launches"]["http"]
        idle = [k for k in PAR_HTTP_FAMILIES if launches[k] == 0]
        check(not idle, f"HTTP over dp, full: rank {r} never launched {idle}")
    del model
    torch.cuda.empty_cache()
    return {**record, "models": {"full": f"CLIP ViT-B/32 + {MODEL_NAME}, bf16 decode",
                                 "tiny": "tiny float32 (tiny_pixel_model)"},
            "settings": PAR_HTTP_SETTINGS,
            "launches_full_by_rank": [g["full"]["launches"]["http"] for g in ranks],
            "note": "two ranks sharing one card: requests/s is not a dp speed"}


def parallel_rank(argv: list[str]) -> int:
    """A rank of the parallel phase (``--parallel-rank SPEC RANK``): joins the
    group over the spec's ``file://`` rendezvous on this process's card, runs
    the spec's parts on its mesh (``kind``: ``dp`` tiny and full width,
    ``dp_tiny``, ``tp`` on a tp mesh of the world, ``pp`` on a pipeline of
    the world, ``sp`` on a (1, world) sequence-parallel mesh), prints its launch counts by kernel and part, and saves what
    it computed for the parent."""
    from gpt2_image_captioning_tpu_torch.core.mesh import MeshSpec, create_mesh, init_distributed
    from gpt2_image_captioning_tpu_torch.parallel.pipeline import create_pipeline_mesh
    from gpt2_image_captioning_tpu_torch.parallel.sequence import create_sp_mesh

    spec = json.loads(Path(argv[0]).read_text())
    rank, kind = int(argv[1]), spec["kind"]
    init_distributed(spec["init_method"], rank=rank, world_size=spec["world"], device="cuda")
    if kind == "pp":
        mesh = create_pipeline_mesh(1, spec["world"], device="cuda")
    elif kind == "sp":
        mesh = create_sp_mesh(1, spec["world"], device="cuda")
    else:
        mesh = create_mesh(MeshSpec(dp=-1, tp=spec["world"] if kind == "tp" else 1),
                           device="cuda")
    out = {"backend": mesh.backend, "device": str(mesh.device), "shape": mesh.shape}
    if kind == "tp":
        out["tiny"] = parallel_tiny_tp(mesh)
        out["full"] = parallel_full_tp(mesh)
    elif kind == "pp":
        out["full"] = parallel_full_pp(mesh)
    elif kind == "sp":
        out["tiny"] = sp_tiny(mesh)
        out["full"] = sp_full(mesh)
    else:
        out["tiny"] = parallel_tiny(mesh)
        if kind == "dp":
            out["full"] = parallel_full(mesh)
    if "full" in out:
        print(json.dumps({"phase": "parallel_rank", "kind": kind, "world": spec["world"],
                          "rank": rank, "backend": mesh.backend,
                          "launches_by_part": out["full"]["launches"],
                          "seconds_by_part": out["full"]["seconds"]}), flush=True)
    torch.save(out, Path(spec["dir"]) / f"{spec['name']}_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    check("jax" not in sys.modules, "a rank imported jax")
    return 0


def launch_ranks(groups: dict[str, tuple[int, str]]) -> tuple[dict, dict]:
    """Start every group's ranks of this script at once on the parent's card
    (a group ``name: (world, kind)``, the kind as :func:`parallel_rank`
    takes it: gloo when its ranks share the card, nccl for a world of one),
    wait for all, and return each group's outputs
    and its seconds (until its last rank exited).  A rank that fails, or
    outlives PARALLEL_RANK_TIMEOUT, fails the phase, and every rank still
    running is killed by its handle."""
    card = str(torch.cuda.current_device())
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        card = visible.split(",")[int(card)]
    procs, logs = {}, []
    t0 = time.perf_counter()
    for name, (world, kind) in groups.items():
        spec_path = PARALLEL_RUN / f"{name}.json"
        spec_path.write_text(json.dumps({
            "world": world, "kind": kind, "name": name, "dir": str(PARALLEL_RUN),
            "init_method": f"file://{PARALLEL_RUN / (name + '.rendezvous')}"}))
        for rank in range(world):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=card, RANK=str(rank),
                       LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
            log = open(PARALLEL_RUN / f"{name}_rank{rank}.log", "w")
            logs.append(log)
            procs[name, rank] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
                 str(spec_path), str(rank)], stdout=log, stderr=subprocess.STDOUT, env=env)
    seconds = {}
    deadline = time.monotonic() + PARALLEL_RANK_TIMEOUT
    try:
        while True:
            for name in groups:
                ranks = [p for (n, _), p in procs.items() if n == name]
                if name not in seconds and all(p.poll() is not None for p in ranks):
                    seconds[name] = time.perf_counter() - t0
            failed = any(p.poll() not in (None, 0) for p in procs.values())
            if len(seconds) == len(groups) or failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for name, rank in procs:
        shutil.copy(PARALLEL_RUN / f"{name}_rank{rank}.log",
                    OUT_DIR / f"parallel_{name}_rank{rank}.log")
    codes = {f"{name} rank {rank}": p.returncode for (name, rank), p in procs.items()}
    check(set(codes.values()) == {0}, f"parallel: exit codes {codes} (0 expected; see "
                                      "chiprun_out/parallel_*_rank*.log)")
    outs = {name: [torch.load(PARALLEL_RUN / f"{name}_rank{r}.pt", weights_only=False)
                   for r in range(world)] for name, (world, _) in groups.items()}
    return outs, seconds


def rel_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest leaf-wise ||got - want|| / ||want|| and its leaf."""
    return max((float((got[k] - w).norm() / w.norm()), k) for k, w in want.items())


def check_tiny(name: str, ranks: list[dict], want: dict) -> dict:
    """Every rank's tiny tokens equal the one-process run's; the train
    losses and the first step's gradients (summed over the ranks, each leaf
    by its norm) within PAR_TINY_TOL, relative; each leaf's update over the
    three steps within PAR_TINY_UPDATE_TOL of one process's, by its norm;
    the ranks' parameters bit-equal.  The update's bound is wider than the
    gradients': AdamW normalises each element, so an element whose gradient
    is near 0 turns the gradient's summation-order difference (1e-7) into
    one of up to the learning rate in its update.  The parameters' largest
    elementwise difference is reported."""
    loss_err, param_err, worst_leaf, grad_err, update_err = 0.0, 0.0, None, (0.0, ""), (0.0, "")
    delta = {k: want["train_params"][k] - v for k, v in want["train_before"].items()}
    for r, got in enumerate(ranks):
        t = got["tiny"]
        for k in ("greedy", "int8", "beam"):
            check(np.array_equal(t[k], want[k]), f"parallel {name} rank {r}: {k} tokens differ")
        check(t["continuous"] == want["continuous"],
              f"parallel {name} rank {r}: continuous captions differ")
        loss_err = max(loss_err, max(abs(a - b) / abs(b) for a, b in
                                     zip(t["train_losses"], want["train_losses"])))
        for k, v in want["train_params"].items():
            err = float((t["train_params"][k] - v).abs().max())
            if err > param_err:
                param_err, worst_leaf = err, k
        grad_err = max(grad_err, rel_err(t["train_grads"], want["train_grads"]))
        update_err = max(update_err, rel_err(
            {k: t["train_params"][k] - v for k, v in want["train_before"].items()}, delta))
        check(all(torch.equal(t["train_params"][k], ranks[0]["tiny"]["train_params"][k])
                  for k in want["train_params"]), f"parallel {name}: ranks' parameters differ")
    check(loss_err <= PAR_TINY_TOL and grad_err[0] <= PAR_TINY_TOL,
          f"parallel {name}: train loss {loss_err}, gradient {grad_err} off one process")
    check(update_err[0] <= PAR_TINY_UPDATE_TOL,
          f"parallel {name}: train update {update_err} off one process")
    return {"tokens_equal": ["greedy", "int8", "beam", "continuous"],
            "train_loss_rel_err": loss_err, "train_grad_rel_err": list(grad_err),
            "train_update_rel_err": list(update_err),
            "train_param_max_abs_err": [param_err, worst_leaf],
            "tolerance": PAR_TINY_TOL, "update_tolerance": PAR_TINY_UPDATE_TOL,
            "ranks_bit_equal": True,
            "backend": [g["backend"] for g in ranks], "devices": [g["device"] for g in ranks]}


def parallel_phase() -> tuple[list[dict], dict]:
    """Data, tensor, pipeline and sequence parallelism on the card: two gloo
    ranks sharing it and one nccl rank (a world of one) at dp, the dp pair
    also serving both HTTP endpoints, a tp-2, a pp-2 and an sp-2 pair of
    gloo ranks, all subprocesses of this script started together, held to
    this process's one-process runs (PAR_*, MP_* and SP_* above)."""
    shutil.rmtree(PARALLEL_RUN, ignore_errors=True)
    PARALLEL_RUN.mkdir()
    t0 = time.perf_counter()
    want = parallel_tiny(None)
    ref_train = parallel_train_step(None)
    ref_names, ref_emb = parallel_extract(None, PARALLEL_RUN / "extract_one.pt")
    mp_refs = model_parallel_references(ref_train)
    sp_refs = {"tiny": sp_tiny(None), "full": sp_full(None)}
    http_ref = http_dp_reference()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    runs, t_ranks = launch_ranks({"gloo2": (2, "dp"), "nccl1": (1, "dp_tiny"),
                                  "tp2": (2, "tp"), "pp2": (2, "pp"), "sp2": (2, "sp")})
    gloo, nccl = runs["gloo2"], runs["nccl1"]
    tiny = {"gloo2": check_tiny("gloo2", gloo, want), "nccl1": check_tiny("nccl1", nccl, want)}
    check(tiny["gloo2"]["backend"] == ["gloo", "gloo"] and tiny["nccl1"]["backend"] == ["nccl"],
          f"backends {tiny['gloo2']['backend']} {tiny['nccl1']['backend']}")

    counts = {}
    for r, got in enumerate(gloo):
        full = got["full"]
        total = {k: sum(c[k] for c in full["launches"].values())
                 for k in full["launches"]["greedy"]}
        idle = [k for k in PAR_FAMILIES if total[k] == 0]
        check(not idle, f"parallel rank {r}: kernel families never launched: {idle}")
        counts[f"parallel_rank{r}"] = total
    f0, f1 = gloo[0]["full"], gloo[1]["full"]
    check(all(torch.equal(f0["train"]["after"][k], f1["train"]["after"][k])
              for k in f0["train"]["after"]), "parallel: the ranks' trained parameters differ")
    loss_err, update_err = train_agreement(f0["train"], ref_train)
    check(loss_err <= TRAIN_TOL["loss_bf16"], f"parallel train: loss {f0['train']['loss']} "
                                              f"against one process's {ref_train['loss']}")
    check(update_err <= TRAIN_TOL["grad_bf16"], f"parallel train: update error {update_err}")
    names, emb = f0["extraction"]
    check(names == ref_names == f1["extraction"][0], "parallel extraction: file order differs")
    extract_err = float(np.abs(emb - ref_emb).max())
    check(extract_err <= PAR_EXTRACT_TOL, f"parallel extraction: features {extract_err} off")
    from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings

    saved_names, saved = load_embeddings(str(PARALLEL_RUN / "extract_dp.pt"))
    check(saved_names == names and np.array_equal(saved, emb), "the dp .pt did not read back")
    model_parallel, mp_counts = model_parallel_checks(runs["tp2"], runs["pp2"], ref_train,
                                                     mp_refs)
    counts.update(mp_counts)
    sequence_parallel, sp_counts = sp_checks(runs["sp2"], sp_refs)
    counts.update(sp_counts)
    http_over_dp = http_dp_checks(gloo, http_ref)
    record = {
        "phase": "parallel", "model": MODEL_NAME,
        "seconds": {"one_process_references": t_ref,
                    "two_ranks_sharing_one_card": t_ranks["gloo2"],
                    "one_nccl_rank": t_ranks["nccl1"],
                    "tp2_ranks_sharing_one_card": t_ranks["tp2"],
                    "pp2_ranks_sharing_one_card": t_ranks["pp2"],
                    "sp2_ranks_sharing_one_card": t_ranks["sp2"]},
        "note": "the dp, tp, pp and sp groups' nine ranks share one card, started together: "
                "the seconds are not a parallel speed",
        "tiny_f32": tiny,
        "full_width": {
            "greedy": {"rows_a_rank": B // 2, **f0["greedy_teacher_forced"]},
            "continuous": {**PAR_CONTINUOUS, "requests": PAR_CONTINUOUS_REQUESTS,
                           **f0["continuous_checked"], "stats_rank0": f0["continuous_stats"]},
            "train": {"batch": B, "loss_dp": f0["train"]["loss"], "loss_one_process":
                      ref_train["loss"], "loss_abs_err": loss_err, "update_rel_err": update_err,
                      "tolerance": [TRAIN_TOL["loss_bf16"], TRAIN_TOL["grad_bf16"]],
                      "ranks_bit_equal": True},
            "extraction": {"batches": [list(b) for b in PAR_EXTRACT], "max_abs_err": extract_err,
                           "tolerance": PAR_EXTRACT_TOL, "file_order_equal": True},
            "seconds_by_part_rank0": f0["seconds"],
        },
        "launches_by_rank_and_part": [g["full"]["launches"] for g in gloo],
        "model_parallel": model_parallel,
        "sequence_parallel": sequence_parallel,
        "http_over_dp": http_over_dp,
        "card": nvidia_smi(),
    }
    shutil.rmtree(PARALLEL_RUN, ignore_errors=True)
    return [record], counts


def train_agreement(got: dict, ref: dict) -> tuple[float, float]:
    """A train step's loss error against one process's (absolute) and its
    update's error by norm: ||after - ref after|| / ||ref after - before||."""
    num = sum(float(((got["after"][k] - ref["after"][k]).float() ** 2).sum()) for k in ref["after"])
    den = sum(float(((ref["after"][k] - ref["before"][k]).float() ** 2).sum())
              for k in ref["after"])
    return abs(got["loss"] - ref["loss"]), (num / den) ** 0.5


def grad_agreement(got: dict, ref: dict) -> tuple[float, str]:
    """The step's clipped gradients against one process's: the largest
    leaf-wise max |got - ref| / max |ref| (``train_path``'s measure of two
    computations of one gradient) and its leaf.  A leaf whose reference is
    all zero (the mapper's key bias: softmax is shift-invariant) counts by
    its max |got| over the largest max |ref| of the tree."""
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    return max((float((got["grads"][k] - g).abs().max()) / (float(g.abs().max()) or scale), k)
               for k, g in ref["grads"].items())


def local_head_kernels(g) -> dict:
    """Decode attention and flash attention against their twins at tp's
    local heads (ATTN_TP_SHAPES, FLASH_TP_SHAPES), bf16 and float32."""
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        flash = {}
        for name, b, h, t, hd, causal, masked in FLASH_TP_SHAPES:
            q, k, v, mask = flash_inputs(b, h, t, hd, masked, dtype, g)
            want = A._flash_attention_plain(q, k, v, mask, causal)
            got = A.flash_attention_cuda(q, k, v, mask, causal)
            torch.cuda.synchronize()
            flash[name] = {"at": [b, h, t, hd], "max_abs_err": close(got, want, FLASH_TOL[dtype])}
        out[dtype_tag(dtype)] = {"decode_attention": attention_local_heads(dtype, g),
                                 "flash_attention": flash}
    return out


def model_parallel_references(ref_train: dict) -> dict:
    """What the tp and pp ranks are held to, in this process: the kernels at
    tp's local heads against their twins, the tiny tp tokens of one process,
    and the update's floor — one process's step on the flash kernel's plain
    twin against ``ref_train``."""
    floor = parallel_train_step(None, use_kernels=False)
    return {"kernels": local_head_kernels(torch.Generator(device="cuda").manual_seed(17)),
            "tiny": parallel_tiny_tp(None),
            "floor": dict(zip(("loss_abs_err", "update_rel_err"),
                              train_agreement(floor, ref_train)),
                          grad_rel_err=list(grad_agreement(floor, ref_train)))}


def model_parallel_checks(tp: list[dict], pp: list[dict], ref_train: dict,
                          refs: dict) -> tuple[dict, dict]:
    """The tp-2 and pp-2 ranks held to this process's runs
    (:func:`model_parallel_references`): tiny float32 tokens exactly, the
    full-width greedy request by teacher forcing (inside rank 0), the bf16
    train step against ``ref_train`` by MP_TRAIN_TOL and its comments; the
    launches each rank's parts must and must not show.  Returns (the
    record, launch counts by rank)."""
    want, floor = refs["tiny"], refs["floor"]
    check([r["backend"] for r in tp + pp] == ["gloo"] * 4,
          f"tp / pp backends {[r['backend'] for r in tp + pp]}")
    counts, train = {}, {}
    for r, got in enumerate(tp):
        for k in ("greedy", "beam"):
            check(np.array_equal(got["tiny"][k], want[k]), f"tp rank {r}: tiny {k} tokens differ")
        check(np.array_equal(got["full"]["greedy_tokens"], tp[0]["full"]["greedy_tokens"])
              and got["full"]["image_captions"] == tp[0]["full"]["image_captions"],
              "tp ranks returned different captions")
    for name, ranks, must, idle in (("tp", tp, TP_FAMILIES, TP_IDLE), ("pp", pp, PP_FAMILIES, ())):
        for r, got in enumerate(ranks):
            launches = got["full"]["launches"]
            total = {k: sum(c[k] for c in launches.values()) for k in launches["train"]}
            never = [k for k in must if total[k] == 0]
            check(not never, f"{name} rank {r}: kernel families never launched: {never}")
            ran = [k for k in idle if total[k] != 0]
            check(not ran, f"{name} rank {r}: step kernels launched at tp: {ran}")
            counts[f"parallel_{name}_rank{r}"] = total
        f0 = ranks[0]["full"]["train"]
        check(all(torch.equal(g["full"]["train"]["after"][k], f0["after"][k])
                  for g in ranks for k in f0["after"]), f"{name}: the ranks' parameters differ")
        loss_err, update_err = train_agreement(f0, ref_train)
        worst_leaf = rel_err({k: f0["after"][k] - v for k, v in ref_train["before"].items()},
                             {k: ref_train["after"][k] - v for k, v in ref_train["before"].items()})
        grad_err = grad_agreement(f0, ref_train)
        check(loss_err <= MP_TRAIN_TOL["loss"] and grad_err[0] <= TRAIN_TOL["grad_bf16"]
              and update_err <= floor["update_rel_err"],
              f"{name} train: loss {f0['loss']} against {ref_train['loss']}, gradients "
              f"{grad_err}, update {update_err} (worst leaf {worst_leaf}; one process on the "
              f"plain twin: {floor['update_rel_err']})")
        train[name] = {"batch": B, "loss": f0["loss"], "loss_one_process": ref_train["loss"],
                       "loss_abs_err": loss_err, "update_rel_err": update_err,
                       "update_rel_err_worst_leaf": list(worst_leaf),
                       "grad_rel_err": list(grad_err),
                       "tolerance": {**MP_TRAIN_TOL, "grad": TRAIN_TOL["grad_bf16"],
                                     "update": floor["update_rel_err"]},
                       "ranks_bit_equal": True,
                       "seconds_by_part": [g["full"]["seconds"] for g in ranks],
                       "launches_by_rank_and_part": [g["full"]["launches"] for g in ranks]}
    train["pp"]["microbatches"] = PP_MICRO
    record = {
        "local_head_kernels": refs["kernels"],
        "train_floor_one_process_plain_twin": floor,
        "tiny_f32_tp2": {"tokens_equal": ["greedy", "beam"], "rows": PAR_TINY_B,
                         "config": "GPT-2 2 x 256 (4 heads of 64), vocab 293; mapper 2 x 128"},
        "tp2_greedy": {"rows": B, **tp[0]["full"]["greedy_teacher_forced"]},
        "tp2_images": {"images": B, "ranks_equal": True},
        "train": train,
    }
    return record, counts


# ``--only <phase>``: one of the slice's phases alone, its records and launches
PHASES = {"http": http_phase, "pipeline": pipeline_phase, "sizes": sizes_phase, "rat": rat_phase,
          "parallel": parallel_phase}


# ``--only <part>``: (compute dtypes, checks) of one part, its records alone
ONLY = {
    "linear": ((torch.bfloat16, torch.float32), (check_linear, check_linear_int8)),
    "vocab": ((torch.bfloat16, torch.float32), VOCAB_CHECKS),
    "prefill": ((torch.bfloat16, torch.float32), (check_prefill,)),
    "quant": ((torch.bfloat16, torch.float32), (check_rowquant, check_fold)),
    "flash": ((torch.bfloat16, torch.float32), (check_flash,)),
    "patch": ((torch.bfloat16, torch.float32), (check_patch_embed,)),
}


def main(argv: list[str]) -> int:
    parts = (*ONLY, *PHASES)
    rank_call = len(argv) == 3 and argv[0] == "--parallel-rank"  # a rank of the parallel phase
    if not rank_call and argv not in ([], *(["--only", part] for part in parts)):
        print(f"usage: python3 chip_smoke.py [--only {'|'.join(parts)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from gpt2_image_captioning_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in full float32
    torch.backends.cudnn.allow_tf32 = False
    if rank_call:
        return parallel_rank(argv[1:])
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    emit(environment())

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": str(lib_path.name),
          "key": lib_path.parent.name})
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc.log").write_text((lib_path.parent / "nvcc.log").read_text())

    g = torch.Generator(device="cuda").manual_seed(0)
    if argv and argv[1] in PHASES:
        records, counts = PHASES[argv[1]]()
        for record in records:
            emit(record)
        emit({"phase": f"{argv[1]}_launches", "launches_by_path": counts})
        print(nvidia_smi(), flush=True)
        return 0
    if argv:  # one part's records alone, e.g. of an earlier tree's kernels on the same card
        if argv[1] == "vocab":
            emit(walk_registers())
        if argv[1] == "flash":
            emit(flash_registers())
        if argv[1] == "patch":
            emit(patch_registers())
        dtypes, fns = ONLY[argv[1]]
        for dtype in dtypes:
            for fn in fns:
                recs = fn(dtype, g)
                for rec in recs if isinstance(recs, list) else [recs]:
                    emit({"phase": "kernel_vs_plain", "dtype": dtype_tag(dtype), **rec})
        if argv[1] == "flash":
            emit(check_flash_backward(g))
        print(nvidia_smi(), flush=True)
        return 0
    emit(check_dot_f32(g))
    emit(check_vocab_ring())
    emit(walk_registers())
    emit(flash_registers())
    emit(patch_registers())
    kernel_rows = {}
    checks = (check_attention, check_attention_origin, check_attention_start, check_linear,
              check_logits_argmax, check_logits, check_logits_topk, check_sampler, check_flash,
              check_prefill, check_patch_embed, vocab_contract)
    int8_checks = (check_rowquant, check_linear_int8, check_fold, check_vocab_int8,
                   check_attention_int8, functools.partial(vocab_contract, quant=True))
    for dtype in (torch.bfloat16, torch.float32):
        for fn in checks + int8_checks:
            recs = fn(dtype, g)
            for rec in recs if isinstance(recs, list) else [recs]:
                rec = {"phase": "kernel_vs_plain", "dtype": str(dtype).replace("torch.", ""),
                       **rec}
                emit(rec)
                if "kernel" not in rec:  # the contract sweeps
                    continue
                if dtype == torch.bfloat16:
                    kernel_rows[rec["kernel"] + ("_" + rec["mode"] if "mode" in rec else "")] = rec
                elif rec["kernel"] in F32_ROWS and "mode" not in rec:
                    kernel_rows[rec["kernel"] + "_f32"] = rec
    emit(check_flash_backward(g))

    launches, bf16 = {}, {}
    for mode in ("greedy", "sampled", "in_kernel", "beam", "continuous", "greedy_int8",
                 "greedy_int8_kv", "beam_int8", "continuous_int8"):
        record = tiny_exact(mode)
        emit(record)
        if "launches" in record:
            launches[record["phase"].replace("_exact", "")] = record["launches"]
    emit(tiny_pixels())
    tower_records, tower_launches = towers_path()
    for record in tower_records:
        emit(record)
    launches.update(tower_launches)
    model, reqs = serving_model()
    for path, fn in (("greedy", greedy_path), ("sampled", sampled_path), ("beam", beam_path)):
        record, launches[path], profiled = fn(model, reqs)
        bf16[path] = record
        emit(record)
        emit(profiled)
    # the façade's default precision, float32, at full width: greedy, sampled
    # (the façade's defaults), the draw in the kernel and beam-4
    for path, fn in (("greedy_f32", lambda: greedy_path(model, reqs, "f32")),
                     ("sampled_f32", lambda: sampled_path(model, reqs, "f32")),
                     ("in_kernel_f32", lambda: sampled_path(model, reqs, "f32", in_kernel=True)),
                     ("beam_f32", lambda: beam_f32_path(model, reqs))):
        record, launches[path], profiled = fn()
        emit(record)
        emit(profiled)
    record, counts = long_prefix_path()
    emit(record)
    launches.update(counts)
    # the int8 paths, each beside the bf16 figure of its path from this run
    int8_paths = (
        ("greedy_int8", "greedy", lambda: greedy_path(model, reqs, "int8")),
        ("greedy_int8_kv", "greedy", lambda: greedy_path(model, reqs, "int8", quant_cache=True)),
        ("sampled_int8", "sampled", lambda: sampled_path(model, reqs, "int8")),
        ("in_kernel_int8", "sampled", lambda: sampled_path(model, reqs, "int8", in_kernel=True)),
        ("beam_int8", "beam", lambda: beam_path(model, reqs, quant=True)),
    )
    for path, base, fn in int8_paths:
        record, launches[path], profiled = fn()
        record["bf16_same_run"] = {k: bf16[base][k] for k in ("img_per_s_kernels",
                                                               "seconds_kernels")}
        emit(record)
        emit(profiled)
    model.tokenizer = synthetic_tokenizer(V)
    _, clip_cfg, clip_params = tower_params("clip")
    for mode in ("greedy", "sampled"):
        record, launches[f"images_{mode}"] = images_path(model, clip_cfg, clip_params, mode)
        emit(record)
    emit(extraction_phase(clip_cfg, clip_params))
    del clip_params
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(CONTINUOUS_REQUESTS, 512)).astype(np.float32)
    caps = rng.integers(8, CONTINUOUS["max_length"] + 1, size=CONTINUOUS_REQUESTS)
    for mode, precision in [(m, "bf16") for m in CONTINUOUS_MODES] + [("greedy", "int8")]:
        record, counts, profiled = continuous_path(model, mode, embs, caps, precision)
        launches[record["phase"]] = counts
        if precision == "int8":
            record["bf16_same_run"] = {k: bf16["continuous_greedy"][k] for k in (
                "requests_per_s", "latency_p50_s", "latency_p95_s", "occupancy")}
        bf16[record["phase"]] = record
        emit(record)
        emit(profiled)
    del model
    torch.cuda.empty_cache()
    train_record, train_profiled, launches["train"] = train_path()
    emit(train_record)
    emit(train_profiled)
    epochs_record, launches["train_epochs"], launches["train_epochs_eval"], trained, val_ds = \
        train_epochs_phase(train_record["captions_per_s"])
    emit(epochs_record)
    eval_record, eval_launches = evaluation_phase(trained, val_ds)
    launches.update(eval_launches)
    emit(eval_record)
    del trained
    shutil.rmtree(EPOCH_RUN, ignore_errors=True)
    torch.cuda.empty_cache()
    for phase in PHASES.values():
        records, counts = phase()
        for record in records:
            emit(record)
        launches.update(counts)

    source = "gpt2_image_captioning_tpu_torch/csrc/"
    step_kernel = "gpt2_image_captioning_tpu/ops/decode_step.py"
    # each kernel row: (its source, the TPU kernel it replaces, the path whose
    # launches it reports, what one "ms" covers and one count of "launches"
    # is: a wrapper call); the layers' kernels and the argmax count greedy
    # serving, flash attention the timed train steps, the stored logits the
    # sampled path, the top-k beam search, the start window greedy
    # continuous serving, the sampler in-kernel continuous serving
    rows = {
        "decode_attention": ("decode_attention.cu",
                             "gpt2_image_captioning_tpu/ops/decode_attention.py:68", "greedy",
                             "call (1 CUDA launch), idx 64, B 128"),
        "fused_linear": ("fused_linear.cu", f"{step_kernel}:112", "greedy",
                         "layer: 4 calls (qkv, attn_proj, mlp_fc, mlp_proj; 6 CUDA launches)"),
        "logits_argmax": ("logits_argmax.cu", f"{step_kernel}:112", "greedy",
                          "call (3 CUDA launches: LN_f, the walk, the merge), B 128"),
        "flash_attention": ("flash_attention.cu", "gpt2_image_captioning_tpu/ops/attention.py:40",
                            "train", "call (1 CUDA launch) at (128, 12, 65, 64), causal + mask"),
        "logits": ("logits.cu", f"{step_kernel}:617", "sampled",
                   "call (2 CUDA launches: LN_f, the walk), B 128"),
        "logits_topk": ("logits_topk.cu", f"{step_kernel}:569", "beam",
                        "call (3 CUDA launches), B 512, k 4"),
        "decode_attention_start": ("decode_attention.cu", f"{step_kernel}:113",
                                   "continuous_greedy",
                                   "call (1 CUDA launch), idx 64, B 512, random starts"),
        "logits_sample": ("logits_sample.cu", f"{step_kernel}:641", "continuous_in_kernel",
                          f"call (2 + 2 x {SAMPLE_ROUNDS} CUDA launches), B 512, temperature "
                          f"1.0, top_p {TOP_P}"),
        # the int8 modes: W8A8 (rowquant :234, stream_matmul :262-287, the
        # vocabulary's int8 tile :555-563 in each vocabulary mode) and the
        # int8 KV cache (:311-323, :404-409); the same wrappers, so the same
        # counters, read on the int8 paths
        "rowquant": ("rowquant.cu", f"{step_kernel}:234", "greedy_int8",
                     "CUDA launch: LN + quantize, B 128, D 768; launched inside the int8 calls"),
        "fused_linear_int8": ("fused_linear.cu", f"{step_kernel}:262", "greedy_int8",
                              "layer: 4 calls (6 CUDA launches: rowquant + the int8 product "
                              "for qkv and mlp_fc, the product quantizing its own rows for "
                              "attn_proj and mlp_proj)"),
        "logits_argmax_int8": ("logits_argmax.cu", f"{step_kernel}:555", "greedy_int8",
                               "call (3 CUDA launches), B 128"),
        "logits_int8": ("logits.cu", f"{step_kernel}:555", "sampled_int8",
                        "call (2 CUDA launches), B 128, emit_logits (:617)"),
        "logits_topk_int8": ("logits_topk.cu", f"{step_kernel}:555", "beam_int8",
                             "call (3 CUDA launches), B 512, k 4, topk (:569)"),
        "logits_sample_int8": ("logits_sample.cu", f"{step_kernel}:555", "in_kernel_int8",
                               f"call (2 + 2 x {SAMPLE_ROUNDS} CUDA launches), B 512, "
                               f"temperature 1.0, top_p {TOP_P}, sample (:641)"),
        "decode_attention_int8_kv": ("decode_attention.cu", f"{step_kernel}:311",
                                     "greedy_int8_kv",
                                     "call (1 CUDA launch, the quantizing append included), "
                                     "idx 64, B 128, int8 cache"),
        # the prefill counts greedy serving (one a request), the patch
        # embedding image serving (one a device batch of 128 images; its
        # row is timed at CLIP B/32's b 256)
        "prefill": ("prefill.cu", "gpt2_image_captioning_tpu/ops/prefill_step.py:87", "greedy",
                    "call (84 CUDA launches: 7 a layer), GPT-2 124M, B 128 x 15 tokens"),
        "patch_embed": ("patch_embed.cu", "gpt2_image_captioning_tpu/ops/patch_embed.py:36",
                        "images_greedy", "call (1 CUDA launch), CLIP B/32, b 256, 224 px"),
    }
    # the float32 rows: flash attention, the projections and the prefill (on
    # wgmma TF32), the vocabulary kernels (the three-term TF32 split
    # throughout), each counted on a float32 path at full width — the
    # façade's default greedy decode (mapper flash, layers, greedy
    # vocabulary, prefill), its sampled decode, the draw in the kernel and
    # the float32 beams — and the patch embedding (wgmma TF32), counted on
    # the float32 CLIP tower's encodes; bound_ms counts their float32
    # products at the split's 165 TFLOP/s
    for name, (src, replaces, home, per) in F32_ROWS.items():
        rows[f"{name}_f32"] = (src, replaces, home, per)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the redesigned kernels' rows also carry their device time and their
    # library call's
    redesigned = ("device_ms", "library_device_ms")

    def counter(name):  # the wrapper whose count a row reads
        return name.removesuffix("_int8_kv").removesuffix("_int8").removesuffix("_f32")

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{source}{src}", "replaces": replaces,
         "launches": launches[home][counter(name)], **{k: kernel_rows[name][k] for k in keys},
         **{k: kernel_rows[name][k] for k in redesigned if k in kernel_rows[name]},
         "per": per, "path": home,
         "launches_by_path": {path: counts[counter(name)] for path, counts in launches.items()}}
        for name, (src, replaces, home, per) in rows.items()
    ]}
    idle = [r["name"] for r in table["kernels"] if r["launches"] == 0]
    check(not idle, f"kernels never launched on their paths: {idle}")
    origin = kernel_rows["decode_attention_origin"]
    table["kernels"][0]["beam_origin"] = {
        "replaces": f"{step_kernel}:371", "launches": launches["beam"]["decode_attention"],
        "per": "call (1 CUDA launch), idx 40, B 512, gather_start 15",
        **{k: origin[k] for k in keys + redesigned}}
    emit({"phase": "script", "seconds": time.perf_counter() - T0, "card": card})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RESULTS + [table], indent=1))
    print(json.dumps(table), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
