"""The comparisons that decide ``correct``, on the reference of
:mod:`h100_bench.reference.model`.  Nothing here imports the port.

Served and batch captions: teacher-forced along the program's tokens, each
token's reference logit is compared with the reference's best at that
position (0 where the program chose the reference's argmax); the number
compared is that gap's mean over the judged tokens (its widest value swings
from seed to seed by its nature, and reads close to the control's).  The
control reads the same gap for the token that a lower-precision reference
puts first.

Training: each of the first steps' losses, the first gradient as the
optimizer took it and the parameters' change after the steps, each leaf's
norm against the reference's (:func:`leaf_gap`); and one step taken after
the window from the state the window left (:func:`reference_tail`).
"""

from __future__ import annotations

import statistics

import torch

from h100_bench.reference import model as R


def served_length(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """Tokens a row generated: up to and with its first EOS, or all."""
    is_eos = tokens == eos
    first = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
                        torch.full_like(tokens[:, 0], tokens.shape[1]))
    return first.long()


@torch.no_grad()
def greedy_gap(mp: dict, gpt: dict, cfg: dict, emb: torch.Tensor, tokens: torch.Tensor,
               lengths: torch.Tensor, control: R.Precision | None = None, block: int = 16
               ) -> dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over the first ``lengths[r]`` tokens of each row;
    with ``control``, also the widest gap of the tokens that the reference
    in that precision puts first at the same positions.  ``mean_gap``: the
    gap averaged over every judged token (0 where the program chose the
    reference's argmax), the number ``correct`` compares."""
    R.exact_float32()
    worst, worst_control, checked, agree, total, total_c = 0.0, 0.0, 0, 0, 0.0, 0.0
    for r0 in range(0, tokens.shape[0], block):
        e, t, n = emb[r0:r0 + block], tokens[r0:r0 + block], lengths[r0:r0 + block]
        width = int(n.max())
        t = t[:, :width]
        lg = R.caption_logits(mp, gpt, cfg, e, t, R.EXACT)
        live = torch.arange(width, device=t.device)[None, :] < n[:, None]
        best = lg.max(dim=-1).values
        chosen = lg.gather(-1, t.long()[..., None])[..., 0]
        gap = (best - chosen)[live]
        worst = max(worst, float(gap.max()))
        total += float(gap.sum())
        checked += int(live.sum())
        agree += int((lg.argmax(dim=-1) == t.long())[live].sum())
        if control is not None:
            lc = R.caption_logits(mp, gpt, cfg, e, t, control)
            pick = lc.argmax(dim=-1, keepdim=True)
            gap_c = (best - lg.gather(-1, pick)[..., 0])[live]
            worst_control = max(worst_control, float(gap_c.max()))
            total_c += float(gap_c.sum())
        del lg
    out = {"greedy_gap": worst, "mean_gap": total / max(1, checked), "tokens_checked": checked,
           "share_reference_argmax": agree / max(1, checked)}
    if control is not None:
        out.update(control_gap=worst_control, control_mean_gap=total_c / max(1, checked))
    return out


# nn.MultiheadAttention's in_proj packs three parameters (q, k and v) into
# one tensor; the judge undoes the packing, so that the key bias, whose
# gradient under softmax is nought, is a leaf of its own for the rule of
# :func:`moving_leaves`
PACKED = ("attn/in_proj/w", "attn/in_proj/b")


def parts(path: str, t: torch.Tensor) -> list[tuple[str, torch.Tensor]]:
    """The published parameters a tree leaf holds: its q, k and v thirds
    for a packed in_proj, else the leaf itself."""
    if path.endswith(PACKED):
        return [(f"{path}[{n}]", c) for n, c in zip("qkv", t.chunk(3, dim=-1))]
    return [(path, t)]


def part_norms(paths: list[str], tensors: list[torch.Tensor]) -> list[float]:
    return [float(c.float().norm()) for p, t in zip(paths, tensors) for _, c in parts(p, t)]


def part_names(paths: list[str], tensors: list[torch.Tensor]) -> list[str]:
    return [n for p, t in zip(paths, tensors) for n, _ in parts(p, t)]


def leaf_gap(got: list[float], want: list[float], keep: list[bool]) -> tuple[float, int]:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; leaves with ``keep`` false are left out.  Returns
    (gap, index of the worst leaf)."""
    kept = [w for w, k in zip(want, keep) if k]
    median = statistics.median(kept) if kept else 0.0
    worst, at = 0.0, -1
    for i, (g, w, k) in enumerate(zip(got, want, keep)):
        if not k:
            continue
        gap = abs(g - w) / max(w, median, 1e-30)
        if gap > worst:
            worst, at = gap, i
    return worst, at


def moving_leaves(grad_norms: list[float], share: float = 1e-3) -> list[bool]:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others (a gradient nought to rounding, such as a key bias
    under softmax) move under Adam by round-off alone."""
    median = statistics.median(grad_norms)
    return [g >= share * median for g in grad_norms]


def reference_training(mp0: list[torch.Tensor], paths: list[str], rebuild, gpt: dict, cfg: dict,
                       batches: list[dict], opt: dict, lr_at, prec: R.Precision = R.EXACT
                       ) -> dict:
    """The reference's first ``len(batches)`` steps from the initial mapper
    leaves ``mp0`` (cloned): each step's loss, the first step's clipped
    gradient norms and each leaf's change after the steps, by
    :func:`parts`.
    ``rebuild(leaves)`` makes the mapper tree of a leaf list; ``lr_at(i)``
    is the learning rate of step i (0-based)."""
    R.exact_float32()
    params = [p.detach().clone().float() for p in mp0]
    state: dict = {}
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        leaves = [p.requires_grad_(True) for p in params]
        loss = R.caption_loss(rebuild(leaves), gpt, cfg, batch, prec)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        grads = R.clip_gradients([g.detach() for g in grads], opt["max_grad_norm"])
        if i == 0:
            grad_norms = part_norms(paths, grads)
        params = [p.detach() for p in params]
        R.adamw_update(params, grads, state, lr_at(i), opt["beta1"], opt["beta2"], opt["eps"],
                       opt["weight_decay"])
    change = part_norms(paths, [p - p0.float() for p, p0 in zip(params, mp0)])
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def reference_tail(params: list[torch.Tensor], moments: list[torch.Tensor],
                   squares: list[torch.Tensor], index: int, paths: list[str], rebuild,
                   gpt: dict, cfg: dict, batch: dict, opt: dict, lr: float,
                   prec: R.Precision = R.EXACT) -> dict:
    """One AdamW step, the ``index``-th (0-based) of the run, from the
    mapper leaves ``params`` and the optimizer's first and second moments
    as the program left them after the window: the step's loss and each
    leaf's change, by :func:`parts`.  The program's state is the start,
    since the window's steps are too many to follow; the first steps of
    :func:`reference_training` check the start of the run itself."""
    R.exact_float32()
    start = [p.detach().clone().float() for p in params]
    leaves = [p.clone().requires_grad_(True) for p in start]
    loss = R.caption_loss(rebuild(leaves), gpt, cfg, batch, prec)
    grads = R.clip_gradients([g.detach() for g in torch.autograd.grad(loss, leaves)],
                             opt["max_grad_norm"])
    after = [p.detach().clone() for p in leaves]
    state = {"step": index, "m": [m.detach().clone().float() for m in moments],
             "v": [v.detach().clone().float() for v in squares]}
    R.adamw_update(after, grads, state, lr, opt["beta1"], opt["beta2"], opt["eps"],
                   opt["weight_decay"])
    return {"loss": float(loss.detach()),
            "change": part_norms(paths, [a - s for a, s in zip(after, start)])}
