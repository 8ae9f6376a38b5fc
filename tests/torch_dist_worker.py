"""One rank of the port's data-parallel CPU tests.

    python tests/torch_dist_worker.py TASK DIR RANK WORLD

joins a gloo group of WORLD ranks over a ``file://`` rendezvous in DIR, on
the CPU with one thread, runs TASK on the inputs the test wrote into DIR
(``spec.json`` and ``.npz`` files of numpy arrays, the weights as the JAX
package's trees flattened by path), and writes what it computed to
``DIR/TASK_rank{RANK}.pt``.  It imports the port alone, and asserts at
exit that ``jax`` was never imported.  pytest does not collect this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpt2_image_captioning_tpu_torch.core.mesh import (  # noqa: E402
    MeshSpec, create_mesh, init_distributed, shard_batch,
)
from gpt2_image_captioning_tpu_torch.core.precision import F32  # noqa: E402
from gpt2_image_captioning_tpu_torch.core.tree import (  # noqa: E402
    flatten_with_paths, unflatten_from_paths,
)


def load_tree(path: str, prefix: str) -> dict:
    with np.load(path) as z:
        return unflatten_from_paths({k[len(prefix) + 1:]: z[k] for k in z.files
                                     if k.startswith(prefix + "/")})


def flat_numpy(tree) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in flatten_with_paths(tree).items()}


def tokenizer(spec: dict):
    """The port's tokenizer over the test's tables."""
    from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer

    return GPT2BPETokenizer(spec["vocab"], [tuple(m) for m in spec["merges"]])


def captioner(spec: dict, root: str):
    """The port's façade over the weights the test wrote, with the tokenizer."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.models import mapping as M
    from gpt2_image_captioning_tpu_torch.models import porting

    cfg = C.CaptionerConfig(gpt2=G.GPT2Config(**spec["gpt2"]),
                            mapping=M.MLPMappingConfig(**spec["mapping"]),
                            eos_token_id=spec["eos"])
    model = C.ImageCaptioningModel(cfg, tokenizer=tokenizer(spec), device="cpu")
    weights = os.path.join(root, "weights.npz")
    model.trainable, model.frozen = porting.from_jax_numpy(
        load_tree(weights, "trainable"), load_tree(weights, "frozen"), cfg, device="cpu")
    return model


def rat_pipeline_run(mesh, spec: dict, root: str) -> dict:
    """``training_pipeline.run`` of the test's RAT config (a persistent store,
    ``tpu.mesh`` dp -1: the group's two ranks) on the weights the test
    wrote: the history, the store directories this rank wrote, and the
    images its store retrieves for the queries."""
    from gpt2_image_captioning_tpu_torch import training_pipeline as TP
    from gpt2_image_captioning_tpu_torch.core.config import Config
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.models import porting
    from gpt2_image_captioning_tpu_torch.retrieval import rat_pipeline as RP
    from gpt2_image_captioning_tpu_torch.retrieval import store as S

    rat = spec["rat"]
    weights = os.path.join(root, "rat_weights.npz")
    build, create, build_store = TP.build_model, S.create_persistent_store, RP.build_store
    writes, stores = [], []

    def tiny_model(cfg, tokenizer, **kw):
        model = build(cfg, tokenizer, gpt_config=G.GPT2Config(**spec["gpt2"]), **kw)
        model.trainable, model.frozen = porting.from_jax_numpy(
            load_tree(weights, "trainable"), load_tree(weights, "frozen"), model.cfg,
            device="cpu")
        return model

    TP.load_gpt2_tokenizer = lambda *a, **k: tokenizer(spec)
    TP.build_model = tiny_model
    S.create_persistent_store = lambda *a, **k: writes.append(a[0]) or create(*a, **k)
    RP.build_store = lambda *a, **k: stores.append(build_store(*a, **k)) or stores[-1]
    cwd = os.getcwd()
    os.chdir(rat["dir"])  # train() logs under ./logs
    try:
        hist = TP.run(Config(rat["config"]), device="cpu")
    finally:
        os.chdir(cwd)
    with np.load(os.path.join(root, "inputs.npz")) as z:
        queries = z["rat_queries"]
    retrieved = stores[0].retrieve_images_by_vector_similarity(queries, rat["top_i"])
    return {"epoch_losses": hist["epoch_losses"], "val_metrics": hist["val_metrics"],
            "writes": writes, "store": type(stores[0]).__name__,
            "retrieved": [[name for name, _ in row] for row in retrieved]}


def task_collectives(mesh, spec: dict, root: str) -> dict:
    """Each rank's shard of ``x`` through the three collectives."""
    from gpt2_image_captioning_tpu_torch.parallel import collectives as P

    with np.load(os.path.join(root, "inputs.npz")) as z:
        x = z["x"]
    local = shard_batch(mesh, {"x": x})["x"]
    grads = [local.clone(), (2 * local[:1]).clone()]
    P.psum_tensors(mesh, grads)
    return {"psum": P.psum_scalar(mesh, local).numpy(),
            "pmean": P.pmean_scalar(mesh, local).numpy(),
            "gather": P.all_gather_batch(mesh, local).numpy(),
            "psum_tensors": [g.numpy() for g in grads], "local": local.numpy()}


def task_dp(mesh, spec: dict, root: str) -> dict:
    """Every dp path of the port on this rank's shard (see the test module)."""
    from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset
    from gpt2_image_captioning_tpu_torch.evaluation.generation import generate_predictions
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import continuous as CE
    from gpt2_image_captioning_tpu_torch.models import porting
    from gpt2_image_captioning_tpu_torch.serving import CaptionService, ContinuousCaptionService
    from gpt2_image_captioning_tpu_torch.train import loop as L
    from gpt2_image_captioning_tpu_torch.train import optim as O

    out: dict = {}
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))

    # the train step: accumulation 1 (three global batches) and 2 (one group)
    for accum, key in ((1, "steps"), (2, "group")):
        model = captioner(spec, root)
        ocfg = O.AdamWConfig(learning_rate=1e-3, num_training_steps=4)
        optimizer, scheduler = O.make_optimizer(model.trainable, ocfg)
        step = L.make_train_step(model.cfg, ocfg, F32, grad_accum_steps=accum, device="cpu",
                                 mesh=mesh)
        names = ("token_ids", "labels", "attention_mask", "image_embedding")
        batches = [{n: inputs[f"{key}_{n}"][i] for n in names}
                   for i in range(len(inputs[f"{key}_labels"]))]
        losses, norms = [], []
        for batch in batches:
            if accum == 1:
                local = {n: v.numpy() for n, v in shard_batch(mesh, batch).items()}
            else:  # (accum, micro, ...): the rank's rows of every micro-batch
                per = batch["labels"].shape[1] // mesh.dp
                local = {n: v[:, mesh.rank * per:(mesh.rank + 1) * per] for n, v in batch.items()}
            loss, norm = step(model.trainable, optimizer, scheduler, model.frozen, local)
            losses.append(float(loss))
            norms.append(float(norm))
        out[f"step{accum}"] = {"losses": losses, "norms": norms,
                               "trainable": flat_numpy(model.trainable)}

    # greedy, int8 and beam generate on a batch dp does not divide
    model = captioner(spec, root)
    emb = torch.from_numpy(inputs["emb"])
    kw = dict(max_length=spec["max_length"], mesh=mesh)
    out["greedy"] = model.generate(emb, temperature=0.0, **kw).numpy()
    out["int8"] = model.generate(emb, temperature=0.0, decode_precision="int8", **kw).numpy()
    out["beam"] = C.beam_generate(model.trainable, model.frozen, model.cfg, emb, beam_size=4,
                                  **kw).numpy()
    out["sampled_shape"] = tuple(model.generate(emb, temperature=1.0, **kw).shape)

    # generate_predictions and train() over the synthetic COCO splits
    files = spec["coco"]
    val = CocoDataset(files["val_emb"], files["val_ann"], tokenizer=model.tokenizer,
                      max_length=10)
    out["predictions"] = generate_predictions(model, val, batch_size=4, max_length=8,
                                              temperature=0.0, mesh=mesh, device="cpu")
    train_ds = CocoDataset(files["train_emb"], files["train_ann"], tokenizer=model.tokenizer,
                           max_length=10)
    run = os.path.join(root, "train")
    hist = L.train(train_ds, model, batch_size=10, num_epochs=2, learning_rate=1e-3,
                   save_every_epoch=1, outputs_dir=run, log_dir=os.path.join(run, "logs"),
                   val_dataset=val, val_annotations_path=files["val_ann"], eval_batch_size=4,
                   eval_max_length=8, mesh=mesh)
    out["train"] = {"epoch_losses": hist["epoch_losses"], "best_epoch": hist["best_epoch"],
                    "val_metrics": hist["val_metrics"],
                    "trainable": flat_numpy(model.trainable)}

    # the dp engine: every request staged by the first macro, then macros
    # without admissions until every sub-pool has drained
    model = captioner(spec, root)
    eng = spec["engine"]
    state = CE.init_state_dp(model.cfg, mesh, eng["slots"], eng["t_max"],
                             model.cfg.total_prefix_length, F32)
    packed = C.prepare_decode_weights(model.trainable, model.frozen, model.cfg, F32)
    outs = []
    for m in range(eng["macros"]):
        n_q = inputs["engine_n"] if m == 0 else [0] * mesh.dp
        state, o = CE.macro_step_dp(
            mesh, packed, model.trainable, model.frozen, state,
            torch.from_numpy(inputs["engine_emb"]), torch.from_numpy(inputs["engine_cap"]),
            torch.from_numpy(inputs["engine_uid"]), n_q, cfg=model.cfg, policy=F32,
            seg=eng["seg"], bursts=eng["bursts"], admit=eng["admit"])
        outs.append(o.numpy())
    out["engine"] = np.stack(outs)
    out["engine_slots"] = tuple(state["k"].shape)

    # both services over the mesh
    svc = ContinuousCaptionService(model, slots=4, segment=2, bursts=2, admit=2,
                                   max_length=spec["max_length"], mesh=mesh)
    ids = [svc.submit_embedding(e) for e in inputs["service_emb"]]
    svc.drain()
    out["continuous"] = [svc.pop_result(i) for i in ids]
    out["continuous_q"] = (svc.q_cap, svc.admit)
    from gpt2_image_captioning_tpu_torch.models import clip

    vparams = porting.vision_from_jax_numpy(load_tree(os.path.join(root, "weights.npz"),
                                                      "vision"), device="cpu")
    vcfg = clip.CLIPVisionConfig.tiny()
    svc = CaptionService(model, vparams, vcfg, encoder="clip", batch_size=4,
                         max_length=spec["max_length"], policy=F32, mesh=mesh)
    out["captions"] = svc.caption_prepped(inputs["prepped"])

    # extraction over the test's PNG directory
    from gpt2_image_captioning_tpu_torch.embeddings.extract import extract_clip_embeddings

    xcfg = clip.CLIPVisionConfig(**spec["extract_tower"])
    xparams = porting.vision_from_jax_numpy(load_tree(os.path.join(root, "weights.npz"),
                                                      "extract_tower"), device="cpu")
    names, embs = extract_clip_embeddings(spec["png_dir"], os.path.join(root, "dp.pt"),
                                          xparams, xcfg, batch_size=4, num_workers=1,
                                          policy=F32, mesh=mesh)
    out["extraction"] = (names, embs)

    # RAT training through the pipeline with a persistent store
    out["rat"] = rat_pipeline_run(mesh, spec, root)
    return out


TASKS = {"collectives": task_collectives, "dp": task_dp}


def launch(task: str, root: str, world: int = 2, timeout: float = 120.0) -> list[dict]:
    """Run TASK on ``world`` ranks over ``root`` (which holds its inputs) and
    return each rank's outputs.  Every rank gets its own ``communicate``
    timeout; a rank still running after it, or after another rank failed, is
    killed by its handle, and any failure raises with the ranks' output."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), task, root, str(r),
                               str(world)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"ranks {failed} of {task} failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(os.path.join(root, f"{task}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main() -> None:
    # TensorBoard's writer imports TensorFlow where it is installed, and
    # TensorFlow may import jax: a rank blocks it, so that the check at exit
    # sees the port's own imports (TensorBoard then writes through its stub)
    sys.modules.setdefault("tensorflow", None)
    task, root, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    init_distributed(f"file://{os.path.join(root, 'rendezvous')}", rank=rank,
                     world_size=world, device="cpu")
    mesh = create_mesh(MeshSpec(dp=-1), device="cpu")
    out = TASKS[task](mesh, spec, root)
    out["mesh"] = {"dp": mesh.dp, "rank": mesh.rank, "backend": mesh.backend}
    torch.save(out, os.path.join(root, f"{task}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "a rank worker imported jax"


if __name__ == "__main__":
    main()
