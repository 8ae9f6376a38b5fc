"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--only linear`` runs the build and the projections' checks alone,
bf16 and int8, and prints their records without the summary lines: the
way to read an earlier tree's ``fused_linear`` on the same card.)

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
1-512, and each role called twice for equal bits).  Decode attention, the
patch embedding and the projections (at the 128 rows of a request and the
512 of beam-4 and continuous serving, the int8 quantizer's launch apart)
also report their device time from a profiler trace beside the events
time, their library call's too.  Then it drives the paths the port has,
each with the kernels' launch counters set to 0 just before and read just
after:

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
  float32 the captions must be the plain path's;
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
- the vision towers at full width, bf16, random seeded weights, on
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
  lower the loss.

Every request and admission prefills through the prefill kernel (an int8
decode through ``forward_cached``, as the reference), and the launch checks
count it.  Each phase prints one JSON line (an ``environment`` record lists
which of PIL, transformers, triton and numpy import); the last three lines
are the kernel table,
the card's name and power limit, and ``{"ok": true, ...}``.  Any failed
check raises, so the script exits non-zero without the ``ok`` line.
Without a CUDA device it exits non-zero at once.  Longer output (nvcc's
log, every phase's record) goes to ``chiprun_out/``.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
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
# product tile (common.cuh) and of flash attention run on the tensor cores as
# a three-term TF32 split, three TF32 products each: their bound takes the
# TF32 peak over three ("tf32x3", 165 TFLOP/s), which lies above float32's
# 67 TFLOP/s outside the tensor cores.
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
# transformer mapper (10 + 15 tokens, 768 / 8 heads), the GPT-2 prefill of
# the int8 decode (forward_cached), and the three vision towers at their
# batches (CLIP B/32: 49 patches + CLS; ViT-B/16: 196 + CLS; DINOv3 L/16:
# 196 + CLS + 4 registers).
FLASH_SHAPES = (
    ("gpt2_train", B, 12, 65, 64, True, True),
    ("mapper", B, 8, 25, 96, False, False),
    ("gpt2_prefill", B, 12, 15, 64, True, False),
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
# The shape a dtype's kernel row reports: bf16 the training step's, which
# launches it most; float32 the mapper's, which the float32 greedy path runs.
FLASH_MAIN = {torch.bfloat16: "gpt2_train", torch.float32: "mapper"}
# The flash kernel's contract beyond the paths' shapes, held to its twin
# under FLASH_TOL, correctness only: (name, B, H, Tq, Tk, hd, causal, key
# mask, q_offset) — a causal tail of 15 queries after 50 positions (Tq < Tk),
# T 1,024 (16 key tiles through the ring, 8 query tiles a head)
# bidirectional with a key mask and causal, and hd 96 at T 197.
FLASH_CONTRACT = (
    ("causal_q_offset", 32, 12, 15, 65, 64, True, False, 50),
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
                      "call (3 CUDA launches), B 128"),
    "logits": ("logits.cu", f"{STEP_KERNEL}:617", "sampled_f32",
               "call (2 CUDA launches), B 128"),
    "logits_topk": ("logits_topk.cu", f"{STEP_KERNEL}:569", "beam_f32",
                    "call (3 CUDA launches), B 512, k 4"),
    "logits_sample": ("logits_sample.cu", f"{STEP_KERNEL}:641", "in_kernel_f32",
                      "call (2 + 6 CUDA launches), B 512, temperature 1.0, top_p 0.9"),
    "prefill": ("prefill.cu", "gpt2_image_captioning_tpu/ops/prefill_step.py:87", "greedy_f32",
                "call (84 CUDA launches: 7 a layer), GPT-2 124M, B 128 x 15 tokens"),
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
# b 128, DINOv3 ViT-L/16 at b 64; flash attention at T 50, 197 and 201.
TOWERS = (("clip", 256, 32, 768, False), ("vit", 128, 16, 768, True),
          ("dino", 64, 16, 1024, True))
CLIP_LAYERS = 12  # CLIP ViT-B/32's, the tower of image serving
# The patch-embed kernel (csrc/patch_embed.cu) against its twin: both round
# the same normalised values to the operand type (the same float32 steps),
# so only the product's summation order differs (measured: bf16 1.4e-5,
# float32 6.2e-6 at outputs of |max| 7; float32 runs as the three-term TF32
# split).
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
    return {"kernel": "decode_attention", "max_abs_err": worst, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library": "scaled_dot_product_attention over the cache",
            "at": f"B {B}, D {D}, H {H}, T {T}, idx {idx}", "contract": contract}


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
    return {"kernel": "logits_sample", "max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work, "library_ms": None,
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


def check_logits(dtype, g) -> dict:
    """``csrc/logits.cu`` (emit_logits) at the sampled path's B 128.  The
    kernel and the twin both round LN_f's output to the compute dtype; their
    float32 statistics differ in summation order, which can flip a bf16
    rounding of that output, moving a logit by |w| x one bf16 ulp of the
    LN output (< 1e-2): the "out" tolerance."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x32, lnf, wte = vocab_inputs(B, dtype, g)
    want = DS.logits_plain(x32, lnf, wte)
    got = DS.logits_cuda(x32, lnf, wte)
    torch.cuda.synchronize()
    check(got.shape == (B, V) and got.dtype == torch.float32, f"logits shape {got.shape}")
    err = close(got, want, TOL[dtype]["out"])
    ms = time_ms(lambda: DS.logits_cuda(x32, lnf, wte))
    plain_ms = time_ms(lambda: DS.logits_plain(x32, lnf, wte))
    library_ms = time_ms(lambda: library_logits(x32, lnf, wte))
    nbytes = vocab_bytes(B, wte, 4 * B * V)
    bound_ms, bound_by = bound(nbytes, 2 * B * D * V, split_type(dtype))
    return {"kernel": "logits", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": library_ms, "library": "layer_norm + mm with a float32 result",
            "at": f"B {B}, D {D}, V {V}"}


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
    return {"kernel": "logits_topk", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": library_ms, "library": "layer_norm + mm + topk + logsumexp",
            "at": f"B {B_BEAM}, D {D}, V {V}, k {k}", "rows_with_clear_gaps": int(clear.sum()),
            "forced_ties": {"kernel": tie_i[0].tolist(), "plain": tie_plain[0].tolist()}}


def check_logits_argmax(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x32, lnf, wte = vocab_inputs(B, dtype, g)
    logits = DS.logits_plain(x32, lnf, wte)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    got = DS.logits_argmax_cuda(x32, lnf, wte)
    torch.cuda.synchronize()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL[dtype]["gap"]
    check(bool((got == want)[clear].all()), "argmax differs on a row with a clear top-2 gap")
    deficit = top2[:, 0] - logits.gather(1, got.long()[:, None])[:, 0]
    err = float(deficit.max())
    check(err <= TOL[dtype]["gap"], f"a chosen token's logit is {err} below the row max")
    # forced ties: copy row 0's winner into a lower id — id 0, in another
    # 32-column tile of the kernel, and the id just below it
    win = int(want[0])
    check(win > 0, "row 0's winner is id 0; change the seed")
    ties = {}
    for low in sorted({0, win - 1}):
        w2 = wte.clone()
        w2[low] = wte[win]
        tok = DS.logits_argmax_cuda(x32, lnf, w2)
        plain = DS.logits_argmax_plain(x32, lnf, w2)
        check(int(tok[0]) == low, f"tie between ids {low} and {win} picked {int(tok[0])}")
        ties[f"{low}={win}"] = {"kernel": int(tok[0]), "plain": int(plain[0])}
    ms = time_ms(lambda: DS.logits_argmax_cuda(x32, lnf, wte))
    plain_ms = time_ms(lambda: DS.logits_argmax_plain(x32, lnf, wte))
    # no single library call: cuBLAS's bare (B, D) x (D, V) product, for scale
    xf, wt = x32.to(dtype), wte.t()
    cublas_ms = time_ms(lambda: torch.mm(xf, wt))
    nbytes = vocab_bytes(B, wte, 4 * B)  # the tokens written
    bound_ms, bound_by = bound(nbytes, 2 * B * D * V, split_type(dtype))
    return {"kernel": "logits_argmax", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
            "cublas_mm_ms": cublas_ms,
            "at": f"B {B}, D {D}, V {V}", "rows_with_clear_gap": int(clear.sum()), "ties": ties}


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
                       "int8_identical": float((got_q == want_q).float().mean())}
    main = roles["ln_d"]
    return {"kernel": "rowquant", "max_abs_err": worst, "error_is": "max relative scale error",
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "library": "none: no one PyTorch call quantizes rows",
            "at": f"B {B}: LN + quantize of D {D} rows (the row's figures); roles below",
            "roles": roles}


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
# only: every role at D 768, 1024 and 1600 (GPT-2 XL's K 1600 and 6400 are
# no multiples of 64 boxes' worth of slices), M on each side of the kernel's
# 64-row warpgroups and 128-row tiles.
LINEAR_CONTRACT_M = (1, 3, 64, 127, 128, 129, 512)
LINEAR_CONTRACT_D = (768, 1024, 1600)


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


def linear_error(x, w, bias, res, kw, dtype) -> tuple[float, int]:
    """The kernel against its twin on one role's inputs: (max |diff|, int8
    quantizations one step apart).  bf16 and float32 under TOL; int8 under
    TOL plus, with a LayerNorm, :func:`flip_allowance`."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    r_plain, r_kernel = (None, None) if res is None else (res.clone(), res.clone())
    want = DS.fused_linear_plain(x, w, bias, residual=r_plain, **kw)
    got = DS.fused_linear_cuda(x, w, bias, residual=r_kernel, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"fused_linear gave {got.shape} "
          f"{got.dtype}, the twin {want.shape} {want.dtype}")
    tol = TOL[dtype]["f32" if kw["epilogue"] == "residual" else "out"]
    if "w_scale" not in kw:
        return close(got, want, tol), 0
    allowance, flips = (flip_allowance(x, kw["ln"], dtype, w, kw["w_scale"], want)
                        if kw["ln"] is not None else (0.0, 0))
    return close_int8(got, want, tol, allowance), flips


def linear_contract(dtype, quant: bool, g) -> dict:
    """fused_linear's bf16 / int8 route against its twin at
    LINEAR_CONTRACT_D x LINEAR_CONTRACT_M in every role."""
    worst, cases = 0.0, 0
    for d in LINEAR_CONTRACT_D:
        for _, k, n, ln, epi in linear_roles(d):
            for m in LINEAR_CONTRACT_M:
                err, _ = linear_error(*linear_inputs(m, k, n, ln, epi, dtype, quant, g), dtype)
                worst = max(worst, err)
                cases += 1
    return {"cases": cases, "max_abs_err": worst, "D": list(LINEAR_CONTRACT_D),
            "M": list(LINEAR_CONTRACT_M)}


def linear_repeat(x, w, bias, res, kw) -> None:
    """The same call twice on the same inputs gives the same bits: the K
    split's partial tiles are added in a fixed order."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    outs = [DS.fused_linear_cuda(x, w, bias, residual=None if res is None else res.clone(), **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(outs[0], outs[1]), f"fused_linear gave other bits on a repeat: "
          f"{kw['epilogue']}, ({x.shape[0]}, {w.shape[1]}) x {w.shape[0]}")


def linear_plan_of(m: int, k: int, n: int, quant: bool) -> dict | None:
    """The kernel's split of a role (None on a tree without one)."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    plan = getattr(DS, "linear_plan", None)
    return None if plan is None else plan(m, k, n, 1 if quant else 2)._asdict()


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
    if dtype == torch.bfloat16 or quant:
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
           "plan": linear_plan_of(b, k, n, quant) if quant or dtype == torch.bfloat16 else None}
    if quant:
        rec["int8_flips"] = flips
    if device:
        tag = f"{name}_b{b}_{'int8' if quant else str(dtype).replace('torch.', '')}"
        dev = device_split(kernel, ("rowquant_kernel",) * quant, f"kernel_linear_{tag}.json")
        rec["device_ms"] = dev if isinstance(dev, str) else dev["total"]
        if quant and not isinstance(dev, str):
            rec["rowquant_device_ms"] = dev["rowquant_kernel"]
            rec["product_device_ms"] = dev["total"] - dev["rowquant_kernel"]
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
    layer: bf16 runs the TMA / wgmma / cluster route (its device time from
    a trace beside the events time, at B 128 and at the 512 rows of beam-4
    and continuous serving; each role repeated for equal bits; the contract
    sweep), float32 the product tile at B 128."""
    wgmma = dtype == torch.bfloat16
    main = linear_layer(dtype, False, B, wgmma, g)
    rec = {"kernel": "fused_linear", **{k: v for k, v in main.items() if k != "roles"},
           "library": "addmm x 4 (bare product + bias on rows in the compute dtype)",
           "at": f"B {B}: the four projections of one layer, summed (6 CUDA launches)",
           "roles": main["roles"]}
    if wgmma:
        rec["b512"] = linear_layer(dtype, False, B_BEAM, True, g)
        rec["contract"] = linear_contract(dtype, False, g)
        rec["repeat"] = "every role at B 128 and 512: equal bits"
    return rec


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
           "at": f"B {B}: the four projections of one layer, summed (8 CUDA launches)",
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


def check_vocab_int8(dtype, g) -> list[dict]:
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
    for kind, b in (("logits_argmax", B), ("logits", B), ("logits_topk", B_BEAM),
                    ("logits_sample", B_SERVE)):
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
        if kind == "logits_argmax":
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > tol["gap"] + 2 * row_slack
            check(bool((got == want)[clear].all()),
                  "int8 argmax differs on a row with a clear top-2 gap")
            deficit = top2[:, 0] - logits.gather(1, got.long()[:, None])[:, 0]
            err = float(deficit.max())
            check(bool((deficit <= tol["gap"] + 2 * row_slack).all()),
                  f"int8 argmax: a chosen token's logit is {err} below the max")
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
        rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes,
                   library_ms=time_ms(library) if library else None,
                   library=("layer_norm + row quantization + torch._int_mm (V padded to "
                            f"{V + pad}) + dequantize" if library else "none"),
                   at=f"B {b}, D {D}, V {V}, int8 wte, {str(dtype).replace('torch.', '')} rows")
        out.append(rec)
    return out


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


def check_flash(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import attention as A

    shapes = {}
    for name, b, h, t, hd, causal, masked in FLASH_SHAPES:
        q, k, v, mask = flash_inputs(b, h, t, hd, masked, dtype, g)
        want = A._flash_attention_plain(q, k, v, mask, causal)
        got = A.flash_attention_cuda(q, k, v, mask, causal)
        torch.cuda.synchronize()
        err = close(got, want, FLASH_TOL[dtype])
        ms = time_ms(lambda: A.flash_attention_cuda(q, k, v, mask, causal))
        plain_ms = time_ms(lambda: A._flash_attention_plain(q, k, v, mask, causal))
        if masked:
            valid = A._valid(q, k, mask, causal, 0)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid))
        else:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        # q, k, v read and the output written once (and the mask); 4 hd
        # operations per (query, key) pair the masks leave to compute
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes = 4 * b * h * t * hd * q.element_size() + (4 * b * t if masked else 0)
        bound_ms, bound_by = bound(nbytes, 4 * hd * pairs * b * h, split_type(dtype))
        shapes[name] = {"at": [b, h, t, hd], "causal": causal, "padding_mask": masked,
                        "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
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
    shapes["fully_masked_row"] = check_flash_masked_row(dtype, g)
    main = shapes[FLASH_MAIN[dtype]]
    return {"kernel": "flash_attention", "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "at": FLASH_MAIN[dtype], "library": "scaled_dot_product_attention, same boolean mask",
            "tolerance": FLASH_TOL[dtype], "shapes": shapes}


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
        # the weights, biases and LN parameters read once; x0 read, the float32
        # stream and every layer's K/V rows written; four products and the
        # causal attention (4 hd per (query, key) pair) a layer
        rows = b * P_LEN
        nbytes = (n_layer * (12 * D * D * el + 4 * 13 * D) + rows * D * (el + 4)
                  + 2 * n_layer * rows * D * el)
        ops = n_layer * (2 * rows * 12 * D * D + 4 * (D // H) * H * b * P_LEN * (P_LEN + 1) // 2)
        bound_ms, bound_by = bound(nbytes, ops, split_type(dtype))
        shapes[f"b{b}"] = {"images": b, "prefix": P_LEN, "max_abs_err": max(errs.values()),
                           "errors": errs, "ms": ms, "plain_ms": plain_ms, "eager_ms": eager_ms,
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
    return {"kernel": "prefill", "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "eager_ms": main["eager_ms"],
            "eager": "gpt2.forward_cached with the flash kernel (the port's earlier prefill)",
            "tolerance": tol, "at": f"GPT-2 124M, B {B} x {P_LEN} tokens", "shapes": shapes,
            "refuses_prefix": PS.MAX_PREFIX + 1}


def check_patch_embed(dtype, g) -> dict:
    """The patch-embed kernel against its twin at the three towers' shapes,
    with its time beside the bound and the library route (unfold, normalise,
    ``torch.mm``)."""
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
        m, k = b * (224 // p) ** 2, 3 * p * p
        nbytes = b * 224 * 224 * 3 + k * d * w.element_size() + 4 * m * d + 8 * k + 4 * d
        bound_ms, bound_by = bound(nbytes, 2 * m * k * d, dtype)
        shapes[name] = {"images": b, "patch": p, "M": m, "K": k, "D": d, "bias": with_bias,
                        "max_abs_err": err, "ms": ms, "device_ms": dev,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_device_ms": library_dev, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes}
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


def tower_params(name: str):
    """A tower at full width from a seed, bf16 on the card: (module, config,
    params)."""
    from gpt2_image_captioning_tpu_torch.core.precision import cast_floating
    from gpt2_image_captioning_tpu_torch.models import clip as CL
    from gpt2_image_captioning_tpu_torch.models import dino as DN
    from gpt2_image_captioning_tpu_torch.models import vit as VT

    mod, cfg, init = {"clip": (CL, CL.CLIPVisionConfig.vit_b32(), CL.init_vision),
                      "vit": (VT, VT.ViTConfig.base_patch16_224(), VT.init),
                      "dino": (DN, DN.DINOv3Config.vitl16(), DN.init)}[name]
    params = cast_floating(init(torch.Generator().manual_seed(0), cfg, device="cuda"),
                           torch.bfloat16)
    return mod, cfg, params


def towers_path() -> tuple[list[dict], dict]:
    """Each tower at full width, bf16, from synthetic uint8 pixels through its
    uint8 entry point (the patch-embed kernel, then the tower with the flash
    kernel): img/s over three batches, launches, features against
    ``use_kernels=False``, and one traced encode's idle share."""
    from gpt2_image_captioning_tpu_torch import BF16
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS

    records, launches = [], {}
    for name, b, _, _, _ in TOWERS:
        mod, cfg, params = tower_params(name)
        g = torch.Generator(device="cuda").manual_seed(3)
        px = torch.randint(0, 256, (b, 224, 224, 3), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.uint8)

        def run(_=None, use=None):
            with torch.no_grad():
                return mod.encode_image_u8(params, cfg, px, SPECS[name], policy=BF16,
                                           use_kernels=use)

        run()  # warm-up
        torch.cuda.synchronize()
        outs, seconds, counts = run_counted(run, range(3))
        want = {k: 0 for k in counts}
        want.update(patch_embed=3, flash_attention=3 * cfg.num_hidden_layers)
        check(counts == want, f"{name} tower launches {counts} != {want}")
        feats, plain = outs[0].float(), run(use=False).float()
        check(tuple(feats.shape) == (b, plain.shape[1]) and bool(feats.isfinite().all()),
              f"{name}: bad features {tuple(feats.shape)}")
        diff = float((feats - plain).abs().max())
        cos = float((feats * plain).sum(-1).min())
        norm_err = float((feats.norm(dim=-1) - 1.0).abs().max())
        check(diff <= TOWER_TOL and cos >= TOWER_COS and norm_err <= 1e-3,
              f"{name} features: max diff {diff} (<= {TOWER_TOL}), min cosine {cos} "
              f"(>= {TOWER_COS}), norm error {norm_err}")
        _, events, _ = traced(run, f"{name}_encode_trace.json")
        seq = {"clip": 50, "vit": 197, "dino": 201}[name]
        records.append({
            "phase": f"tower_{name}", "config": type(cfg).__name__, "dtype": "bf16",
            "images": b, "batches": 3, "seconds": seconds, "img_per_s": 3 * b / seconds,
            "launches": counts, "flash_seq_len": seq, "features_vs_plain_max_abs": diff,
            "features_vs_plain_min_cos": cos, "tolerance": [TOWER_TOL, TOWER_COS],
            "traced_encode": {**trace_summary(events), "trace": f"{name}_encode_trace.json.gz"},
            "card": nvidia_smi()})
        launches[f"tower_{name}"] = counts
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


def tiny_pixels() -> dict:
    """Tiny float32 from pixels: a CLIP tower with the flash kernel's head dim
    (128 = 2 x 64, 64-pixel images of 16 patches) feeding the tiny captioner;
    ``CaptionService`` and the continuous service's ``submit_prepped`` give
    the same captions with the kernels as without them."""
    from gpt2_image_captioning_tpu_torch import F32
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.clip import CLIPVisionConfig, init_vision
    from gpt2_image_captioning_tpu_torch.serving import CaptionService, ContinuousCaptionService

    cfg = tiny_config()
    vcfg = CLIPVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, image_size=64, patch_size=16,
                            projection_dim=16)
    vparams = init_vision(torch.Generator().manual_seed(8), vcfg, device="cuda")
    model = C.ImageCaptioningModel(cfg, tokenizer=synthetic_tokenizer(cfg.gpt2.vocab_size),
                                   generator=torch.Generator().manual_seed(7), device="cuda")
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
LAYER_KERNELS = ("fused_linear_kernel", "linear_wgmma_kernel", "ln_stats_kernel",
                 "decode_attention_kernel", "ln_rows_kernel", "rowquant_kernel")
VOCAB_KERNELS = {"greedy": ("logits_tile_kernel", "argmax_reduce_kernel"),
                 "sampled": ("logits_store_kernel",),
                 "beam": ("topk_tile_kernel", "topk_merge_kernel")}
# continuous serving also runs the admission's mapper (flash attention) and
# prefill (csrc/prefill.cu; forward_cached's flash attention in int8)
ADMISSION_KERNELS = ("flash_attention_kernel", "prefill_linear_kernel", "prefill_attention_kernel",
                     "prefill_layernorm_kernel")
VOCAB_KERNELS.update({
    "continuous_greedy": VOCAB_KERNELS["greedy"] + ADMISSION_KERNELS,
    "continuous_sampled": VOCAB_KERNELS["sampled"] + ADMISSION_KERNELS,
    "continuous_in_kernel": ("sample_tile_kernel",) + ADMISSION_KERNELS})
# the int8 paths run the same kernels, instantiated for int8 operands
VOCAB_KERNELS.update({f"{path}_int8": names for path, names in VOCAB_KERNELS.items()})
VOCAB_KERNELS.update(greedy_int8_kv=VOCAB_KERNELS["greedy"], in_kernel_int8=("sample_tile_kernel",),
                     greedy_f32=VOCAB_KERNELS["greedy"], sampled_f32=VOCAB_KERNELS["sampled"],
                     in_kernel_f32=("sample_tile_kernel",))


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
    ops between them: the sampling tail, the beam bookkeeping)."""
    trace_name = f"{path}_decode_trace.json"
    wall, events, dropped = traced(run, trace_name)
    names = LAYER_KERNELS + VOCAB_KERNELS[path]

    def is_port(e):
        return e["cat"] == "kernel" and any(k in e["name"] for k in names)

    ours = [e for e in events if is_port(e)]
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
            "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / window_s,
            "port_kernels_s": sum(e["dur"] for e in ours) * 1e-6, "port_kernels_s_by_name": by_name,
            "other_kernels_s": sum(others.values()),
            "other_kernel_launches": sum(e["cat"] == "kernel" and not is_port(e)
                                         for e in in_window),
            "top_other_kernels_s": sorted(others.items(), key=lambda kv: -kv[1])[:8],
            "copies_s": sum(e["dur"] for e in in_window if e["cat"] != "kernel") * 1e-6,
            "events_in_window": len(in_window), "card": nvidia_smi()}


def profile_train_step(run_step) -> dict:
    """Trace one train step: its device window (first to last device event),
    busy time (their union), idle share, kernel launches, and device time by
    kind — the flash kernel, matrix products (cuBLAS/CUTLASS kernels), the
    other kernels (elementwise, reductions, softmax), copies — and the
    kernels that take the most of it."""
    wall, events, dropped = traced(run_step, "train_trace.json")
    record = {"phase": "train_profile", "profiled_step_s": wall, "trace": "train_trace.json.gz",
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
    """Row quantizer launches of one decode step: W8A8 quantizes the input of
    each of a layer's four projections and of the vocabulary.  The int8
    cache's new K and V rows are quantized inside decode attention's own
    launch, so they add none."""
    return (4 * n_layer + 1) * quant


def check_decode_launches(launches: dict, vocab_kernel: str, steps: int, requests: int, cfg,
                          quant: bool = False, images: bool = False) -> None:
    """Each request ran the mapper's flash attention once a mapper layer and
    the prefill kernel once — with an int8 pack, ``forward_cached``'s flash
    attention once a GPT-2 layer instead — and, fed by ``images``, the
    patch-embed kernel once and the CLIP tower's flash attention once a
    tower layer; each decode step launched the layers' kernels once a layer
    and this path's vocabulary kernel once, and the row quantizer as its
    int8 modes need; the other vocabulary kernels never ran."""
    n_layer = cfg.gpt2.n_layer
    flash_per_request = (cfg.mapping.num_layers + n_layer * quant
                         + images * CLIP_LAYERS)
    want = {"flash_attention": flash_per_request * requests, "decode_attention": n_layer * steps,
            "prefill": (not quant) * requests, "patch_embed": images * requests,
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
    profiled = profile_path(lambda: run(reqs[0]), path, decode_steps(outs[0], cfg.eos_token_id),
                            seconds / len(reqs))
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


def main(argv: list[str]) -> int:
    if argv not in ([], ["--only", "linear"]):
        print("usage: python3 chip_smoke.py [--only linear]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from gpt2_image_captioning_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in full float32
    torch.backends.cudnn.allow_tf32 = False
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
    if argv:  # the projections' records alone, e.g. of an earlier tree's kernel
        for fn in (check_linear, check_linear_int8):
            emit({"phase": "kernel_vs_plain", "dtype": "bfloat16", **fn(torch.bfloat16, g)})
        print(nvidia_smi(), flush=True)
        return 0
    emit(check_dot_f32(g))
    kernel_rows = {}
    checks = (check_attention, check_attention_origin, check_attention_start, check_linear,
              check_logits_argmax, check_logits, check_logits_topk, check_sampler, check_flash,
              check_prefill, check_patch_embed)
    int8_checks = (check_rowquant, check_linear_int8, check_vocab_int8, check_attention_int8)
    for dtype in (torch.bfloat16, torch.float32):
        for fn in checks + int8_checks:
            recs = fn(dtype, g)
            for rec in recs if isinstance(recs, list) else [recs]:
                rec = {"phase": "kernel_vs_plain", "dtype": str(dtype).replace("torch.", ""),
                       **rec}
                emit(rec)
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
    launches["beam_f32"] = bf16["beam"]["float32"]["launches"]
    # the façade's default precision, float32, at full width: greedy, sampled
    # (the façade's defaults) and the draw in the kernel
    for path, fn in (("greedy_f32", lambda: greedy_path(model, reqs, "f32")),
                     ("sampled_f32", lambda: sampled_path(model, reqs, "f32")),
                     ("in_kernel_f32", lambda: sampled_path(model, reqs, "f32", in_kernel=True))):
        record, launches[path], profiled = fn()
        emit(record)
        emit(profiled)
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
                          "call (3 CUDA launches), B 128"),
        "flash_attention": ("flash_attention.cu", "gpt2_image_captioning_tpu/ops/attention.py:40",
                            "train", "call (1 CUDA launch) at (128, 12, 65, 64), causal + mask"),
        "logits": ("logits.cu", f"{step_kernel}:617", "sampled", "call (2 CUDA launches), B 128"),
        "logits_topk": ("logits_topk.cu", f"{step_kernel}:569", "beam",
                        "call (3 CUDA launches), B 512, k 4"),
        "decode_attention_start": ("decode_attention.cu", f"{step_kernel}:113",
                                   "continuous_greedy",
                                   "call (1 CUDA launch), idx 64, B 512, random starts"),
        "logits_sample": ("logits_sample.cu", f"{step_kernel}:641", "continuous_in_kernel",
                          f"call (2 + {SAMPLE_ROUNDS} CUDA launches), B 512, temperature 1.0, "
                          f"top_p {TOP_P}"),
        # the int8 modes: W8A8 (rowquant :234, stream_matmul :262-287, the
        # vocabulary's int8 tile :555-563 in each vocabulary mode) and the
        # int8 KV cache (:311-323, :404-409); the same wrappers, so the same
        # counters, read on the int8 paths
        "rowquant": ("rowquant.cu", f"{step_kernel}:234", "greedy_int8",
                     "CUDA launch: LN + quantize, B 128, D 768; launched inside the int8 calls"),
        "fused_linear_int8": ("fused_linear.cu", f"{step_kernel}:262", "greedy_int8",
                              "layer: 4 calls (8 CUDA launches: rowquant + int8 tile each)"),
        "logits_argmax_int8": ("logits_argmax.cu", f"{step_kernel}:555", "greedy_int8",
                               "call (3 CUDA launches), B 128"),
        "logits_int8": ("logits.cu", f"{step_kernel}:555", "sampled_int8",
                        "call (2 CUDA launches), B 128, emit_logits (:617)"),
        "logits_topk_int8": ("logits_topk.cu", f"{step_kernel}:555", "beam_int8",
                             "call (3 CUDA launches), B 512, k 4, topk (:569)"),
        "logits_sample_int8": ("logits_sample.cu", f"{step_kernel}:555", "in_kernel_int8",
                               f"call (2 + {SAMPLE_ROUNDS} CUDA launches), B 512, temperature "
                               f"1.0, top_p {TOP_P}, sample (:641)"),
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
    # the float32 rows of the two redesigned kernels: flash attention and the
    # kernels built on the float32 product tile (common.cuh, the three-term
    # TF32 split), each counted on a float32 path at full width — the
    # façade's default greedy decode (mapper flash, layers, greedy
    # vocabulary, prefill), its sampled decode, the draw in the kernel and
    # the float32 beams; bound_ms counts their float32 products at the
    # split's 165 TFLOP/s
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
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RESULTS + [table], indent=1))
    print(json.dumps(table), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
