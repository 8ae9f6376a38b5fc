"""Closed-loop batch captioning: requests of ``rows`` precomputed image
embeddings (N(0, 1) from the seed), one in flight, through the façade's
``ImageCaptioningModel.generate`` at ``temperature`` 0 (greedy) and the
traffic's ``decode_precision``, ``max_length`` tokens.

End to end: ``captions_per_s``, every caption of every request in the
window over the window's seconds.  Correct: a sample of ``judge_rows`` rows
drawn from the seed across the window's requests, each served token held to
the reference; compared is the mean gap (:func:`reference.judge.greedy_gap`).
The control (``cell.control``): a float32 cell's is the reference with TF32
operands in the program's place, read at the same positions; a bf16 cell's
is the port's own int8 decode (``decode_precision="int8"``) run in the
window.
"""

from __future__ import annotations

import time

import torch

from h100_bench import faults, weights
from h100_bench import harness as H
from h100_bench.metrics.trace import Tracer
from h100_bench.reference import judge as J
from h100_bench.reference import model as R


def run(cell: H.Cell) -> H.Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    precision = tr["decode_precision"]
    served = "int8" if cell.control and precision == "bf16" else precision
    mp, gpt = weights.captioner(cfg, cell.seed, dev, bf16=precision == "bf16")
    model = H.port_model(cfg, mp, gpt, dev)
    gen = weights.generator(cell.seed, 3, dev)
    rows, length, embed = tr["rows"], tr["max_length"], cfg["mapping"]["embed_dim"]

    def request():
        emb = torch.randn((rows, embed), generator=gen, device=dev)
        return emb, model.generate(emb, max_length=length, temperature=0.0,
                                   decode_precision=served)

    seconds = H.window_seconds(cell)
    tracer = Tracer() if cell.trace else None
    with faults.planted(cell.fault):
        H.reset_peak(dev)
        request()  # warm-up: the decode copy and pack, every kernel at this shape
        H.synchronize(dev)
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        kept, stamps = [], []
        while True:
            if tracer:
                H.marker()
            kept.append(request())
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= seconds:
                break
        H.synchronize(dev)
        elapsed = time.perf_counter() - t0
        win = tracer.stop() if tracer else None
        card = H.card_state(dev)
    peak = H.memory_peak(dev)
    del model
    H.release(dev)

    eos = cfg["eos_token_id"]
    steps = sum(int(J.served_length(t, eos).max()) - 1 for _, t in kept)
    captions = rows * len(kept)
    rng = H.seeded_rng(cell.seed, 4)
    picks = rng.choice(captions, size=min(tr["judge_rows"], captions), replace=False)
    emb = torch.stack([kept[i // rows][0][i % rows] for i in picks])
    toks = torch.stack([kept[i // rows][1][i % rows] for i in picks])
    control = R.Precision("tf32") if cell.control and precision == "f32" else None
    got = J.greedy_gap(mp, gpt, cfg, emb, toks, J.served_length(toks, eos), control=control)
    value = got["control_mean_gap"] if control is not None else got["mean_gap"]
    notes = [f"judged {got['tokens_checked']} tokens of {len(picks)} rows; the reference's "
             f"argmax {got['share_reference_argmax']!r} of them; program gap "
             f"{got['greedy_gap']!r}, mean {got['mean_gap']!r}"
             + (f"; control gap {got['control_gap']!r}, mean {got['control_mean_gap']!r}"
                if control else "")
             + (f"; decode_precision {served}" if served != precision else ""),
             H.pace("requests", t0, stamps), card]
    return H.Outcome(
        e2e={"captions_per_s": captions / elapsed}, attempted=captions, failed=0,
        window_start=t0, memory_peak_bytes=peak,
        compared={"mean_gap": (value, cell.limits["mean_gap"])}, trace=win,
        counts={"requests": len(kept), "rows": rows, "decode_steps": steps,
                "precision": precision, "seconds": elapsed},
        notes=notes)
