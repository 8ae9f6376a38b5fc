"""Hyperparameter sweep: ``python -m gpt2_image_captioning_tpu_torch.sweep`` — the
counterpart of ``gpt2_image_captioning_tpu/sweep.py``.

For every ``model.<id>`` override block of ``automation_config.yml`` (or the
ids given with ``--only``), merge it onto ``config.yml``, train and validate
(:func:`training_pipeline.run`), record the time and parameter counts, and
caption the held-out test split, with each run's artifacts under
``<output-dir>/checkpoint_<id>/``:

- ``config_<id>.yml`` (the merged run config)
- ``model_epoch_{n}`` checkpoints + ``eval_results/`` epoch JSONs
- ``training_info_<id>.txt`` (duration, parameter counts, description)
- ``test_predictions_<id>.json`` + ``test_metrics_<id>.json``

A retrieval-augmented id (``retrieval_augmentation: true``, ids 18 and 19
of the repo's automation_config.yml) trains through RAT; its test pass wraps
the freshly built model with an aggregator seeded by ``seed + 1`` and
rebuilds the training store, as the JAX package does.

Every selected id is merged and checked before the first run: ids whose
config this process cannot run (``tp > 1``, a slice not ported yet, or a
``dp`` that the process group's world size does not match) are refused
together, up front.  Under ``torchrun --nproc-per-node N`` each id trains
over a dp mesh of N ranks (:func:`training_pipeline.run`); rank 0 alone
writes the run's config and ``training_info`` and makes the test pass.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import time

import torch

from gpt2_image_captioning_tpu_torch.core.config import Config, load_config, update_cfg
from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE
from gpt2_image_captioning_tpu_torch.core.mesh import init_distributed, launched
from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
from gpt2_image_captioning_tpu_torch.data.tokenizer import load_gpt2_tokenizer
from gpt2_image_captioning_tpu_torch.evaluation.evaluate import evaluate_captions
from gpt2_image_captioning_tpu_torch.evaluation.generation import (
    generate_test_caption_predictions,
)
from gpt2_image_captioning_tpu_torch.training_pipeline import (
    build_model,
    embeddings_file,
    refuse_unported,
    run,
)
from gpt2_image_captioning_tpu_torch.utils import count_model_parameters

log = logging.getLogger("sweep")

_CKPT = re.compile(r"^(best_)?model_epoch_(\d+)\.(npz|pt)$")


def select_test_checkpoint(filenames) -> str | None:
    """The checkpoint the final test pass loads: the highest-epoch
    ``best_model_epoch_{n}`` if any best-by-CIDEr checkpoint exists, else the
    highest-epoch ``model_epoch_{n}``; epochs compare as numbers."""
    candidates = [(bool(m.group(1)), int(m.group(2)), f)
                  for f in filenames if (m := _CKPT.match(f))]
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[0], t[1]))[2]


def run_one(cfg: Config, run_id: str, base_dir: str, description: str = "",
            device=DEFAULT_DEVICE) -> dict:
    """One sweep run into ``base_dir/checkpoint_<run_id>`` on ``device``;
    returns the training history.  In a process group rank 0 alone writes
    the files outside the training run and makes the test pass."""
    refuse_unported(cfg)
    main = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    save_dir = os.path.join(base_dir, f"checkpoint_{run_id}")
    os.makedirs(save_dir, exist_ok=True)
    if main:
        cfg.save(os.path.join(save_dir, f"config_{run_id}.yml"))

    t0 = time.perf_counter()
    history = run(cfg, save_dir=save_dir, device=device)
    duration = time.perf_counter() - t0
    if not main:
        return history

    # parameter counts on a freshly built model of the same config, which
    # then takes the trained weights for the test pass
    tokenizer = load_gpt2_tokenizer()
    model = build_model(cfg, tokenizer, device=device)
    db_store = None
    if cfg.get("retrieval_augmentation", False):
        # the reference reuses the training store for the RAT test pass:
        # rebuild it, and wrap the model as the training run did
        from gpt2_image_captioning_tpu_torch.retrieval.rat_pipeline import build_store, wrap_model

        model = wrap_model(cfg, model)
        db_store = build_store(cfg, device=device)
    trainable, total = count_model_parameters(model)
    best = select_test_checkpoint(os.listdir(save_dir))
    if best:
        model.load_saved_parameters(os.path.join(save_dir, best))
        log.info("Loaded %s for test evaluation", best)

    with open(os.path.join(save_dir, f"training_info_{run_id}.txt"), "w") as f:
        f.write(f"run id: {run_id}\n")
        f.write(f"description: {description}\n")
        f.write(f"training duration (s): {duration:.1f}\n")
        f.write(f"trainable parameters: {trainable}\n")
        f.write(f"total parameters: {total}\n")
        f.write(f"best val CIDEr: {history.get('best_val_cider')}\n")
        f.write(f"best epoch: {history.get('best_epoch')}\n")

    # the final test pass on the held-out split (val2014): beam search when
    # tpu.decode is "beam", else greedy or sampled by validation.temperature
    test_emb = embeddings_file(cfg, "test")
    test_ann = os.path.join(cfg.paths.annotations_path, "captions_val2014.json")
    if os.path.exists(test_emb) and os.path.exists(test_ann):
        test_ds = CocoDataset(test_emb, test_ann, tokenizer=tokenizer,
                              max_length=cfg.max_caption_length)
        tpu = cfg.get("tpu", None) or Config({})
        preds = generate_test_caption_predictions(
            model,
            test_ds,
            output_path=os.path.join(save_dir, f"test_predictions_{run_id}.json"),
            batch_size=cfg.validation.batch_size,
            max_length=cfg.max_caption_length,
            temperature=cfg.validation.temperature,
            top_p=cfg.validation.top_p,
            decode="beam" if tpu.get("decode") == "beam" else "sample",
            beam_size=tpu.get("beam_size", 4),
            decode_precision=cfg.validation.get("decode_precision", None),
            db_store=db_store,
            top_k=cfg.retrieval.top_k if db_store is not None else None,
            top_i=cfg.retrieval.top_i if db_store is not None else None,
            device=device,
        )
        metrics = evaluate_captions(preds, test_ann)
        with open(os.path.join(save_dir, f"test_metrics_{run_id}.json"), "w") as f:
            json.dump(metrics.to_dict(), f, indent=2)
        log.info("Test metrics [%s]: %s", run_id, metrics)
    else:
        log.info("Test split not found (%s) — skipping test evaluation", test_emb)
    return history


def plan_runs(base: Config, updates: Config, only=None) -> list[tuple[str, Config, str]]:
    """Every selected id merged onto ``base`` → ``[(id, config, description)]``,
    ids without overrides skipped with a warning; raises
    ``NotImplementedError`` listing every id whose config is refused
    (:func:`training_pipeline.refuse_unported`)."""
    model_updates = updates.get("model", None) or Config({})
    plans = []
    for run_id in [str(i) for i in (only or model_updates.keys())]:
        overrides = model_updates.get(run_id)
        if overrides is None and run_id.isdigit():
            overrides = model_updates.get(int(run_id))
        if overrides is None:
            log.warning("No overrides for model id %s — skipping", run_id)
            continue
        overrides = (overrides.to_dict(resolve=False) if isinstance(overrides, Config)
                     else dict(overrides))
        description = overrides.pop("description", "")
        plans.append((run_id, update_cfg(base, overrides), description))
    refused = {}
    for run_id, cfg, _ in plans:
        try:
            refuse_unported(cfg)
        except (NotImplementedError, ValueError) as e:
            refused[run_id] = str(e)
    if refused:
        raise NotImplementedError(
            f"model ids {sorted(refused, key=lambda i: (len(i), i))} cannot run on the port yet: "
            + "; ".join(f"{i}: {why}" for i, why in refused.items())
            + ". Select the others with --only.")
    return plans


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Run the config sweep")
    parser.add_argument("--config", default="config.yml")
    parser.add_argument("--automation", default="automation_config.yml")
    parser.add_argument("--output-dir", default="checkpoints")
    parser.add_argument("--only", nargs="*", help="subset of model ids to run")
    args = parser.parse_args(argv)
    if launched():
        init_distributed()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    try:
        plans = plan_runs(load_config(args.config), load_config(args.automation), args.only)
    except NotImplementedError as e:
        parser.error(str(e))
    for run_id, cfg, description in plans:
        log.info("=== Sweep run %s: %s ===", run_id, description)
        run_one(cfg, run_id, args.output_dir, description)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
