"""Config-driven training: ``python -m gpt2_image_captioning_tpu_torch.training_pipeline``
— the counterpart of ``gpt2_image_captioning_tpu/training_pipeline.py``.

Reads the ``config.yml`` schema (``core/config.py``) and builds: datasets
from the ``{split}_{encoder}_embeddings.pt`` convention → the mapping
network by ``mapping.type`` → the captioner (frozen or unfrozen GPT-2, the
optional task prompt; pretrained GPT-2 weights through ``gpt_params``) →
:func:`train.loop.train`.

From the ``tpu:`` block: ``compute_dtype`` picks the bf16 or float32 policy,
``remat`` and ``grad_accum_steps`` pass through to ``train()``, and
``validation.decode_precision`` to its evaluation.  ``tpu.mesh`` ``{dp: -1
| N, tp: 1}`` builds the dp mesh (:mod:`core.mesh`) over the ranks of the
process group: under ``torchrun --nproc-per-node N -m
gpt2_image_captioning_tpu_torch.training_pipeline`` it trains with dp = N,
each rank on its own card; with no launcher it is one rank.  A ``dp`` the
world size does not match raises :meth:`core.mesh.MeshSpec.resolve`'s
error, and ``tp > 1`` ``NotImplementedError`` (ROADMAP.md, queue 1: tensor
parallelism), both before any data is read.

``retrieval_augmentation: true`` runs retrieval-augmented training
(:func:`retrieval.rat_pipeline.run_rat_training`): the store of
``retrieval.backend`` (``device`` by default) over the train split's image
embeddings and ``train_{encoder}_caption_embeddings.pt``, the model wrapped
with the aggregator of ``retrieval.aggregation_type``, ``retrieval.top_k``
/ ``top_i``.  It passes the ``tpu`` block's options as the plain run does.
"""

from __future__ import annotations

import argparse
import os

import torch

from gpt2_image_captioning_tpu_torch.core.config import Config, load_config
from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE
from gpt2_image_captioning_tpu_torch.core.mesh import (
    MeshSpec, TP_REFUSAL, create_mesh, init_distributed, launched,
)
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32
from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
from gpt2_image_captioning_tpu_torch.data.tokenizer import load_gpt2_tokenizer
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.models.mapping import make_mapping_config


def _tpu(cfg: Config) -> Config:
    return cfg.get("tpu", None) or Config({})


def mesh_spec(cfg: Config) -> MeshSpec:
    """``tpu.mesh`` → :class:`MeshSpec` (``dp`` -1 and ``tp`` 1 by default)."""
    mesh = _tpu(cfg).get("mesh", None) or {}
    return MeshSpec(dp=mesh.get("dp", -1), tp=mesh.get("tp", 1))


def refuse_unported(cfg: Config) -> None:
    """Raise for a config this process cannot run, before anything is read:
    ``NotImplementedError`` for ``tp > 1`` (a slice still to come), and
    :meth:`MeshSpec.resolve`'s ``ValueError`` for a ``dp`` the process
    group's world size (1 without one) does not match."""
    spec = mesh_spec(cfg)
    if spec.tp > 1:
        raise NotImplementedError(f"tpu.mesh {{dp: {spec.dp}, tp: {spec.tp}}}: {TP_REFUSAL}")
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    spec.resolve(world)


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
    and return ``train()``'s history.  ``device``: the rank's device of the
    ``tpu.mesh`` mesh (``cuda`` is this rank's card)."""
    from gpt2_image_captioning_tpu_torch.train.loop import train

    refuse_unported(cfg)
    mesh = create_mesh(mesh_spec(cfg), device=device)
    device = mesh.device
    tpu = _tpu(cfg)
    tokenizer = load_gpt2_tokenizer()
    train_ds, val_ds = build_datasets(cfg, tokenizer)
    model = build_model(cfg, tokenizer, gpt_params=gpt_params, device=device)
    save_dir = save_dir or cfg.paths.checkpoints_path
    tpu_kw = dict(grad_accum_steps=tpu.get("grad_accum_steps", 1),
                  eval_decode_precision=cfg.validation.get("decode_precision", None),
                  remat=bool(tpu.get("remat", False)), mesh=mesh)
    if cfg.get("retrieval_augmentation", False):
        from gpt2_image_captioning_tpu_torch.retrieval.rat_pipeline import run_rat_training

        return run_rat_training(cfg, model, train_ds, val_ds, save_dir, device=device,
                                num_workers=cfg.training.num_workers, **tpu_kw)
    return train(
        train_ds,
        model,
        batch_size=cfg.training.batch_size,
        num_epochs=cfg.training.num_epochs,
        num_workers=cfg.training.num_workers,
        learning_rate=cfg.training.learning_rate,
        num_warmup_steps=cfg.training.num_warmup_steps,
        save_every_epoch=cfg.training.save_every_epoch,
        outputs_dir=save_dir,
        val_dataset=val_ds,
        val_annotations_path=os.path.join(cfg.paths.annotations_path, "captions_val2017.json"),
        eval_every_epoch=cfg.validation.eval_every_epoch,
        eval_batch_size=cfg.validation.batch_size,
        eval_max_length=cfg.max_caption_length,
        eval_temperature=cfg.validation.temperature,
        eval_top_p=cfg.validation.top_p,
        seed=cfg.get("seed", 42),
        device=device,
        **tpu_kw,
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train the captioner from config.yml")
    parser.add_argument("--config", default="config.yml")
    parser.add_argument("--save-dir", default=None)
    args = parser.parse_args(argv)
    if launched():
        init_distributed()
    run(load_config(args.config), save_dir=args.save_dir)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
