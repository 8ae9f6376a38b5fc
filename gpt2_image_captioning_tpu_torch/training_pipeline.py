"""Config-driven training: ``python -m gpt2_image_captioning_tpu_torch.training_pipeline``
— the counterpart of ``gpt2_image_captioning_tpu/training_pipeline.py``.

Reads the ``config.yml`` schema (``core/config.py``) and builds: datasets
from the ``{split}_{encoder}_embeddings.pt`` convention → the mapping
network by ``mapping.type`` → the captioner (frozen or unfrozen GPT-2, the
optional task prompt; pretrained GPT-2 weights through ``gpt_params``) →
:func:`train.loop.train`.

From the ``tpu:`` block: ``compute_dtype`` picks the bf16 or float32 policy,
``remat`` and ``grad_accum_steps`` pass through to ``train()``, and
``validation.decode_precision`` to its evaluation.  ``tpu.mesh`` must name
one device (``dp`` -1 or 1, ``tp`` 1): the port runs on one card, and other
meshes raise ``NotImplementedError`` (ROADMAP.md, queue 1: parallelism), as
does ``retrieval_augmentation: true`` (queue 1: RAT), before any data is
read.
"""

from __future__ import annotations

import argparse
import os

import torch

from gpt2_image_captioning_tpu_torch.core.config import Config, load_config
from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32
from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
from gpt2_image_captioning_tpu_torch.data.tokenizer import load_gpt2_tokenizer
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.models.mapping import make_mapping_config


def _tpu(cfg: Config) -> Config:
    return cfg.get("tpu", None) or Config({})


def refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a config whose run needs a slice
    still to come: retrieval augmentation, or a mesh of more than one
    device."""
    if cfg.get("retrieval_augmentation", False):
        raise NotImplementedError(
            "retrieval_augmentation: true (RAT) is not ported yet (ROADMAP.md, queue 1: RAT)")
    mesh = _tpu(cfg).get("mesh", None) or {}
    dp, tp = mesh.get("dp", -1), mesh.get("tp", 1)
    if dp not in (-1, 1) or tp != 1:
        raise NotImplementedError(
            f"tpu.mesh {{dp: {dp}, tp: {tp}}} needs parallelism, which is not ported yet "
            "(ROADMAP.md, queue 1: parallelism); the port runs on one card: dp -1 or 1, tp 1")


def build_model(cfg: Config, tokenizer, gpt_params=None, gpt_config=None,
                device=DEFAULT_DEVICE) -> C.ImageCaptioningModel:
    """config.yml blocks → ImageCaptioningModel on ``device`` (mapping net by
    ``mapping.type``, freeze/prompt by ``image_captioning.*``, the policy by
    ``tpu.compute_dtype``, the random init seeded by ``seed``)."""
    tpu = _tpu(cfg)
    prompt = cfg.image_captioning.get("prefix_task_prompt")
    ccfg = C.CaptionerConfig(
        gpt2=gpt_config or G.GPT2Config.gpt2_124m(),
        mapping=make_mapping_config(cfg.mapping),
        task_prompt_ids=tuple(tokenizer.encode(prompt)) if prompt else None,
        freeze_gpt_weights=cfg.image_captioning.get("freeze_gpt_weights", True),
        eos_token_id=tokenizer.eos_token_id,
        remat=bool(tpu.get("remat", False)),
    )
    policy = BF16 if tpu.get("compute_dtype", "bfloat16") == "bfloat16" else F32
    return C.ImageCaptioningModel(
        ccfg,
        tokenizer=tokenizer,
        generator=torch.Generator().manual_seed(cfg.get("seed", 42)),
        policy=policy,
        device=device,
        gpt_params=gpt_params,
    )


def embeddings_file(cfg: Config, split: str) -> str:
    """``{embeddings_path}/{split}_{vision_encoder}_embeddings.pt``."""
    return os.path.join(cfg.paths.embeddings_path, f"{split}_{cfg.vision_encoder}_embeddings.pt")


def build_datasets(cfg: Config, tokenizer) -> tuple[CocoDataset, CocoDataset]:
    """(train, val) over ``captions_train2017.json`` / ``captions_val2017.json``."""
    return tuple(
        CocoDataset(
            embeddings_file(cfg, split),
            os.path.join(cfg.paths.annotations_path, f"captions_{split}2017.json"),
            tokenizer=tokenizer,
            max_length=cfg.max_caption_length,
        )
        for split in ("train", "val")
    )


def run(cfg: Config, save_dir: str | None = None, gpt_params=None,
        device=DEFAULT_DEVICE) -> dict:
    """Train from ``cfg`` into ``save_dir`` (default ``paths.checkpoints_path``)
    and return ``train()``'s history."""
    from gpt2_image_captioning_tpu_torch.train.loop import train

    refuse_unported(cfg)
    tpu = _tpu(cfg)
    tokenizer = load_gpt2_tokenizer()
    train_ds, val_ds = build_datasets(cfg, tokenizer)
    model = build_model(cfg, tokenizer, gpt_params=gpt_params, device=device)
    return train(
        train_ds,
        model,
        batch_size=cfg.training.batch_size,
        num_epochs=cfg.training.num_epochs,
        num_workers=cfg.training.num_workers,
        learning_rate=cfg.training.learning_rate,
        num_warmup_steps=cfg.training.num_warmup_steps,
        save_every_epoch=cfg.training.save_every_epoch,
        outputs_dir=save_dir or cfg.paths.checkpoints_path,
        grad_accum_steps=tpu.get("grad_accum_steps", 1),
        val_dataset=val_ds,
        val_annotations_path=os.path.join(cfg.paths.annotations_path, "captions_val2017.json"),
        eval_every_epoch=cfg.validation.eval_every_epoch,
        eval_batch_size=cfg.validation.batch_size,
        eval_max_length=cfg.max_caption_length,
        eval_temperature=cfg.validation.temperature,
        eval_top_p=cfg.validation.top_p,
        eval_decode_precision=cfg.validation.get("decode_precision", None),
        seed=cfg.get("seed", 42),
        remat=bool(tpu.get("remat", False)),
        device=device,
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train the captioner from config.yml")
    parser.add_argument("--config", default="config.yml")
    parser.add_argument("--save-dir", default=None)
    args = parser.parse_args(argv)
    run(load_config(args.config), save_dir=args.save_dir)


if __name__ == "__main__":
    main()
