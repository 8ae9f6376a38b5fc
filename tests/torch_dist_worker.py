"""One rank of the port's data-, tensor-, pipeline- and sequence-parallel
CPU tests, and of its HTTP endpoints over several ranks.

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
    flatten_with_paths, tree_leaves, unflatten_from_paths,
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


def tiny_model(spec: dict, root: str, name: str):
    """The port's façade of the test's config ``spec["configs"][name]`` (GPT-2,
    MLP mapper, freeze, eos) over the weights in ``DIR/{name}.npz``."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.models import mapping as M
    from gpt2_image_captioning_tpu_torch.models import porting

    c = spec["configs"][name]
    cfg = C.CaptionerConfig(gpt2=G.GPT2Config(**c["gpt2"]),
                            mapping=M.MLPMappingConfig(**c["mapping"]),
                            eos_token_id=c["eos"], freeze_gpt_weights=c["freeze"])
    model = C.ImageCaptioningModel(cfg, device="cpu")
    weights = os.path.join(root, f"{name}.npz")
    model.trainable, model.frozen = porting.from_jax_numpy(
        load_tree(weights, "trainable"), load_tree(weights, "frozen"), cfg, device="cpu")
    return model


def tp_train_step(model, mesh, batch: dict) -> dict:
    """One AdamW step (lr 1e-3, 4 scheduled steps) of the test's batch on a
    tp ``mesh``, each dp index on its rows: the loss, the gradient norm and
    the trainable tree gathered whole."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.train import loop as L
    from gpt2_image_captioning_tpu_torch.train import optim as O

    tr, fz = C.shard_params(model.trainable, model.frozen, model.cfg, mesh)
    ocfg = O.AdamWConfig(learning_rate=1e-3, num_training_steps=4)
    optimizer, scheduler = O.make_optimizer(tr, ocfg)
    step = L.make_train_step(model.cfg, ocfg, F32, device="cpu", mesh=mesh)
    local = {k: v.numpy() for k, v in shard_batch(mesh, batch).items()}
    loss, norm = step(tr, optimizer, scheduler, fz, local)
    return {"loss": float(loss), "norm": float(norm),
            "trainable": flat_numpy(C.gather_params(tr, model.cfg, mesh))}


def tp_pipeline_run(spec: dict, root: str) -> dict:
    """``training_pipeline.run`` of the test's config (``tpu.mesh`` tp 2 over
    the group's ranks, GPT-2 unfrozen) on the weights the test wrote; then
    the trained model's loss on the test's batch, in one process and at tp."""
    from gpt2_image_captioning_tpu_torch import training_pipeline as TP
    from gpt2_image_captioning_tpu_torch.core.config import Config
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.models import porting

    run = spec["run"]
    weights = os.path.join(root, "run_weights.npz")
    build, built = TP.build_model, []

    def model_of(cfg, tok, **kw):
        model = build(cfg, tok, gpt_config=G.GPT2Config(**run["gpt2"]), **kw)
        model.trainable, model.frozen = porting.from_jax_numpy(
            load_tree(weights, "trainable"), load_tree(weights, "frozen"), model.cfg,
            device="cpu")
        built.append(model)
        return model

    TP.load_gpt2_tokenizer = lambda *a, **k: tokenizer(spec)
    TP.build_model = model_of
    cwd = os.getcwd()
    os.chdir(run["dir"])  # train() logs under ./logs
    try:
        hist = TP.run(Config(run["config"]), device="cpu")
    finally:
        os.chdir(cwd)
    model = built[0]
    mesh = create_mesh(MeshSpec(dp=-1, tp=2), device="cpu")
    with np.load(os.path.join(root, "inputs.npz")) as z:
        batch = {k[len("batch_"):]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("batch_")}
    tr, fz = C.shard_params(model.trainable, model.frozen, model.cfg, mesh)
    return {"epoch_losses": hist["epoch_losses"], "val_metrics": hist["val_metrics"],
            "loss_one_process": float(C.mean_loss(model.trainable, model.frozen, model.cfg,
                                                  batch)),
            "loss_tp": float(C.mean_loss(tr, fz, model.cfg, batch, mesh=mesh))}


def conjugate_pair(mesh) -> dict:
    """The tp collectives' values and gradients on a rank whose input is
    ``(tp_rank + 1) · arange(6)`` (2, 3) and whose output is weighted by
    ``arange`` (or ``tp_rank + 1``): what the test holds to their sums."""
    from gpt2_image_captioning_tpu_torch.parallel import collectives as P

    scale = float(mesh.tp_rank + 1)
    out = {}
    for name, fn in (("reduce", P.reduce_from_tp), ("copy", P.copy_to_tp),
                     ("gather", P.gather_last_tp)):
        x = (scale * torch.arange(6.0).reshape(2, 3)).requires_grad_(True)
        y = fn(mesh, x)
        weight = scale if name == "copy" else torch.arange(float(y.numel())).reshape(y.shape)
        (y * weight).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def task_tp(mesh, spec: dict, root: str) -> dict:
    """The tp paths of the test's world (see tests/test_torch_tp.py): per
    mesh shape, the train step, greedy and beam tokens, the decode_quant
    pin, the slices' round trip; in the world of 4 the pipeline run and the
    dp-only refusals."""
    import warnings

    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService
    from gpt2_image_captioning_tpu_torch.embeddings.extract import _run_extraction

    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    batch = {k[len("batch_"):]: v for k, v in inputs.items() if k.startswith("batch_")}
    emb = torch.from_numpy(inputs["batch_image_embedding"])
    out: dict = {}
    for dp, tp, parts in spec["meshes"]:
        tmesh = create_mesh(MeshSpec(dp=dp, tp=tp), device="cpu")
        model = tiny_model(spec, root, "sharding")
        got = {"coords": (tmesh.dp_rank, tmesh.tp_rank), "pair": conjugate_pair(tmesh)}
        tr, fz = C.shard_params(model.trainable, model.frozen, model.cfg, tmesh)
        full = C.gather_params(tr, model.cfg, tmesh)
        got["round_trip"] = all(torch.equal(a, b) for a, b in zip(
            flatten_with_paths(full).values(), flatten_with_paths(model.trainable).values()))
        got["slices"] = {k: v for k, v in flat_numpy(tr).items() if k.startswith("gpt.")}
        kw = dict(max_length=spec["max_length"], mesh=tmesh)
        got["greedy"] = C.generate(tr, fz, model.cfg, emb, temperature=0.0, **kw).numpy()
        if "beam" in parts:
            got["beam"] = C.beam_generate(tr, fz, model.cfg, emb, max_length=5, beam_size=2,
                                          mesh=tmesh).numpy()
        if "quant" in parts:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got["quant"] = C.generate(tr, fz, model.cfg, emb, temperature=0.0,
                                          decode_quant=True, decode_quant_cache=True,
                                          **kw).numpy()
            got["quant_warnings"] = [str(w.message) for w in caught]
            got["sampled_shape"] = tuple(C.generate(tr, fz, model.cfg, emb, temperature=1.0,
                                                    **kw).shape)
        if "step" in parts:
            got["step"] = tp_train_step(model, tmesh, batch)
        out[f"{dp}x{tp}"] = got
    if "run" in spec:
        model = tiny_model(spec, root, "sharding")
        refusals = []
        for build in (lambda: ContinuousCaptionService(model, mesh=tmesh),
                      lambda: _run_extraction([], None, None, "CLIP", mesh=tmesh)):
            try:
                build()
                refusals.append(None)
            except ValueError as e:
                refusals.append(str(e))
        out["refusals"] = refusals
        out["run"] = tp_pipeline_run(spec, root)
    return out


def task_pp(mesh, spec: dict, root: str) -> dict:
    """The pipeline cases of the test's world (see tests/test_torch_pp.py):
    loss and gradients, gathered whole, per (case, microbatches); and two
    AdamW steps of the pipeline train step."""
    from gpt2_image_captioning_tpu_torch.parallel import pipeline as PP
    from gpt2_image_captioning_tpu_torch.train import optim as O

    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    out: dict = {}
    for case in spec["cases"]:
        pmesh = PP.create_pipeline_mesh(case["dp"], case["pp"], device="cpu")
        model = tiny_model(spec, root, case["config"])
        tr, fz = PP.shard_stage_params(model.trainable, model.frozen, model.cfg, pmesh)
        per = 8 // case["dp"]
        rows = slice(pmesh.dp_rank * per, (pmesh.dp_rank + 1) * per)
        got = {"coords": (pmesh.dp_rank, pmesh.stage)}
        if case["kind"] == "grads":
            for n_micro in case["micro"]:
                fn = PP.make_pipeline_loss_and_grad(model.cfg, pmesh, F32, num_microbatches=n_micro)
                batch = {k: v[rows] for k, v in _case_batch(inputs, case["batches"][0]).items()}
                loss, grads = fn(tr, fz, batch)
                got[n_micro] = {"loss": float(loss),
                                "grads": flat_numpy(PP.gather_stage_params(grads, model.cfg,
                                                                           pmesh))}
        else:
            ocfg = O.AdamWConfig(learning_rate=1e-3, num_training_steps=10)
            optimizer, scheduler = O.make_optimizer(tr, ocfg)
            step = PP.make_pipeline_train_step(model.cfg, ocfg, pmesh, F32,
                                               num_microbatches=case["micro"][0])
            losses = []
            for name in case["batches"]:
                batch = {k: v[rows] for k, v in _case_batch(inputs, name).items()}
                losses.append(float(step(tr, optimizer, scheduler, fz, batch)[0]))
            got["losses"] = losses
            got["trainable"] = flat_numpy(PP.gather_stage_params(tr, model.cfg, pmesh))
            got["steps"] = int(optimizer.state[tree_leaves(tr)[0]]["step"])
        out[case["name"]] = got
    return out


def _case_batch(inputs: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + "_")}


class CollectiveProbe:
    """Counts, while active, the calls this rank makes to
    ``torch.distributed``'s all_gather, all_reduce, reduce_scatter and
    batch_isend_irecv
    (with each posted pair's (op, peer)), by patching the functions, and the
    (rows, features) of every ``ops.nn.dense`` input inside
    ``parallel.sequence._sp_block``."""

    def __init__(self):
        import torch.distributed as dist

        from gpt2_image_captioning_tpu_torch.ops import nn
        from gpt2_image_captioning_tpu_torch.parallel import sequence as S

        self.calls: dict = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0,
                            "batch_isend_irecv": []}
        self.block_rows: list = []
        self._patches = []
        in_block = [False]

        def counted(mod, name, record):
            orig = getattr(mod, name)

            def wrapper(*a, **k):
                record(*a, **k)
                return orig(*a, **k)

            self._patches.append((mod, name, orig, wrapper))

        def bump(name):
            def record(*a, **k):
                self.calls[name] += 1
            return record

        def pairs(ops, *a, **k):
            self.calls["batch_isend_irecv"].append(
                [("send" if op.op is dist.isend else "recv", op.peer) for op in ops])

        def dense_rows(params, x, *a, **k):
            if in_block[0]:
                self.block_rows.append(tuple(x.shape[:-1]))

        counted(dist, "all_gather", bump("all_gather"))
        counted(dist, "all_reduce", bump("all_reduce"))
        counted(dist, "reduce_scatter", bump("reduce_scatter"))
        counted(dist, "batch_isend_irecv", pairs)
        counted(nn, "dense", dense_rows)
        block = S._sp_block

        def in_sp_block(*a, **k):
            in_block[0] = True
            try:
                return block(*a, **k)
            finally:
                in_block[0] = False

        self._patches.append((S, "_sp_block", block, in_sp_block))

    def snapshot(self) -> dict:
        return {**self.calls, "batch_isend_irecv": list(self.calls["batch_isend_irecv"]),
                "block_rows": list(self.block_rows)}

    def __enter__(self):
        for mod, name, _, wrapper in self._patches:
            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, orig, _ in self._patches:
            setattr(mod, name, orig)


def task_sp(mesh, spec: dict, root: str) -> dict:
    """The sequence-parallel cases of the test (tests/test_torch_sp.py) on a
    (dp, sp) mesh of the world: each case's loss and gradients on this
    rank's dp rows; ring attention on this rank's chunk, forward and
    q/k/v gradients; the collectives and block rows of one loss's forward
    and backward in each form."""
    from gpt2_image_captioning_tpu_torch.parallel import sequence as S
    from gpt2_image_captioning_tpu_torch.parallel.ring import ring_attention

    dp, sp = spec["mesh"]
    smesh = S.create_sp_mesh(dp, sp, device="cpu")
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    out: dict = {"coords": (smesh.dp_rank, smesh.sp_rank)}

    def local_rows(batch):
        per = len(batch["labels"]) // dp
        return {k: v[smesh.dp_rank * per:(smesh.dp_rank + 1) * per] for k, v in batch.items()}

    for case in spec["cases"]:
        model = tiny_model(spec, root, case["config"])
        fn = S.make_sp_loss_and_grad(model.cfg, smesh, F32, ring=case["ring"])
        loss, grads = fn(model.trainable, model.frozen,
                         local_rows(_case_batch(inputs, case["batch"])))
        out[case["name"]] = {"loss": float(loss), "grads": flat_numpy(grads)}

    for name, causal, masked in spec["ring_cases"]:
        q, k, v, w = (torch.from_numpy(inputs[f"{name}_{t}"]) for t in "qkvw")
        tc = q.shape[2] // sp
        rows = slice(smesh.sp_rank * tc, (smesh.sp_rank + 1) * tc)
        q, k, v = (t[:, :, rows].clone().requires_grad_(True) for t in (q, k, v))
        km = torch.from_numpy(inputs[f"{name}_mask"]) if masked else None
        o = ring_attention(q, k, v, mesh=smesh, q_offset=smesh.sp_rank * tc, key_mask=km,
                           causal=causal, policy=F32)
        (o * w[:, :, rows]).sum().backward()
        out[name] = {"out": o.detach().numpy(), "grads": [t.grad.numpy() for t in (q, k, v)]}

    model = tiny_model(spec, root, spec["probe"])
    batch = {k: torch.from_numpy(v) for k, v in local_rows(_case_batch(inputs, "probe")).items()}
    for ring in (False, True):
        tr = {k: v for k, v in model.trainable.items()}
        for p in tree_leaves(tr):
            p.requires_grad_(True)
            p.grad = None
        with CollectiveProbe() as probe:
            nll, count = S._shard_loss(model.cfg, smesh, F32, ring, tr, model.frozen, batch)
            forward = probe.snapshot()
            (nll / count).backward()
            total = probe.snapshot()
        out[f"probe_ring{int(ring)}"] = {"forward": forward, "total": total}
    return out


def task_http_dp(mesh, spec: dict, root: str) -> dict:
    """Both HTTP endpoints over dp-2 services of the test's tiny captioner
    and CLIP tower: rank 0 serves on port 0 and posts the test's bodies to
    itself (concurrently, one with a query, then an undecodable one, then
    the first again), reads /healthz and shuts down; rank 1 runs its
    follower's ``serve_forever()`` until then."""
    import threading
    import http.client

    from gpt2_image_captioning_tpu_torch.models import clip, porting
    from gpt2_image_captioning_tpu_torch.serving import (
        CaptionService, ContinuousCaptionService, serve_http, serve_http_continuous,
    )

    model = captioner(spec, root)
    vparams = porting.vision_from_jax_numpy(load_tree(os.path.join(root, "weights.npz"),
                                                      "vision"), device="cpu")
    vcfg = clip.CLIPVisionConfig.tiny()
    with np.load(os.path.join(root, "inputs.npz")) as z:
        bodies = [z[f"body_{i}"].tobytes() for i in range(spec["n_bodies"])]
    settings = spec["http"]

    def post(port, body, path="/caption", headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST" if body is not None else "GET", path, body=body,
                         headers=headers or {})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    out: dict = {}
    for kind, build, serve in (
            ("fixed", lambda: CaptionService(model, vparams, vcfg, policy=F32, mesh=mesh,
                                              **settings["fixed"]), serve_http),
            ("continuous", lambda: ContinuousCaptionService(model, vparams, vcfg, mesh=mesh,
                                                            **settings["continuous"]),
             serve_http_continuous)):
        svc = build()
        server = serve(svc, port=0)
        if not mesh.is_main:
            server.serve_forever()  # returns when rank 0 shuts down
            server.shutdown()
            server.server_close()
            out[kind] = {"server": type(server).__name__, "stats": svc.stats}
            continue
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        answers: dict = {}
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, post(port, bodies[i]))) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        got = {"plain": [answers[i] for i in range(len(bodies))]}
        if kind == "continuous":
            got["query"] = post(port, bodies[0], "/caption" + settings["query"])
        got["bad"] = post(port, b"not an image")
        got["after_bad"] = post(port, bodies[1])
        got["health"] = post(port, None, "/healthz")
        server.shutdown()
        server.server_close()
        thread.join(30)
        got["server"] = type(server).__name__
        got["serving_thread_alive"] = thread.is_alive()
        out[kind] = got
    return out


TASKS = {"collectives": task_collectives, "dp": task_dp, "tp": task_tp, "pp": task_pp,
         "sp": task_sp, "http_dp": task_http_dp}


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
