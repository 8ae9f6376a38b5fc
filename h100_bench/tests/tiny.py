"""Tiny cells for the CPU tests: the drivers' code at a size a test run
holds, on the port's plain twins."""

from __future__ import annotations

import copy

import torch

from h100_bench import harness as H

CONFIG = {
    "name": "tiny",
    "gpt2": {"vocab_size": 293, "n_positions": 128, "n_embd": 32, "n_layer": 2, "n_head": 2,
             "layer_norm_epsilon": 1e-05},
    "vision": {"image_size": 32, "patch_size": 8, "hidden_size": 32, "intermediate_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4, "projection_dim": 16,
               "layer_norm_eps": 1e-05},
    "mapping": {"type": "transformer", "embed_dim": 16, "gpt_dim": 32, "prefix_length": 4,
                "hidden_length": 3, "num_layers": 1, "num_heads": 2, "layer_norm_eps": 1e-05},
    "eos_token_id": 292,
}

TRAFFIC = {
    "batch": {"kind": "batch", "rows": 4, "max_length": 6, "decode_precision": "f32",
              "judge_rows": 8},
    "train": {"kind": "train", "batch": 4, "caption_length": 8, "caption_min": 2, "caption_max": 5,
              "compute_dtype": "float32", "judge_steps": 3,
              "optimizer": {"lr": 0.001, "beta1": 0.9, "beta2": 0.999, "eps": 1e-08,
                            "weight_decay": 0.01, "max_grad_norm": 1.0,
                            "schedule_steps": 10 ** 7}},
}

# limits at this size: the plain twins read 0 or within float32 rounding
LIMITS = {"batch": {"mean_gap": 1e-6},
          "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "tail_change_gap": 1e-3}}


def cell(kind: str, seed: int = 12345678901, seconds: float = 0.3, control: bool = False,
         fault: str | None = None, **traffic) -> H.Cell:
    tr = dict(copy.deepcopy(TRAFFIC[kind]), **traffic)
    return H.Cell(name=f"tiny.{kind}", config=copy.deepcopy(CONFIG), traffic=tr,
                  limits=dict(LIMITS[kind]), seed=seed, seconds=seconds, trace=False,
                  device=torch.device("cpu"), control=control, fault=fault)
