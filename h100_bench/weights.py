"""Seeded random weights and the parameter trees both sides read.

The trees have the port's layouts, which follow the published checkpoints'
tensors with products stored (in, out): GPT-2 (``wte``, ``wpe``, ``ln_f``,
``blocks`` stacked on a leading layer dim), ClipCap's transformer mapper
(``linear``, ``prefix_const``, a list of ``layers``) and CLIP ViT-B/32's
vision tower (``layers`` stacked).  Every leaf is drawn on the device from
one generator in two calls (one normal, one uniform draw for all leaves),
then cut: GPT-2 and CLIP weights N(0, 0.02) (GPT-2's residual projections
0.02 / sqrt(2 · layers), positions 0.01), the mapper's products uniform in
±1/sqrt(fan in) as ``nn.Linear``'s, its constant prefix N(0, 1); biases
N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) and shifts N(0, 0.02), so that
no bias or LayerNorm parameter is an identity a fault could hide behind.

``bf16=True`` rounds every value to bfloat16 first (the type a bf16 cell
serves): the float32 copies the façade takes then hold the same values as
its bfloat16 copy, so the reference and the program read one set of weights.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (2 ** 63))


def _ln(shape) -> dict:
    return {"scale": ("ln_scale", shape), "bias": ("normal", shape, 0.02)}


def _dense(shape_w, std: float | None) -> dict:
    n_out = shape_w[-1]
    lead = shape_w[:-2]
    if std is None:  # nn.Linear's default
        bound = 1.0 / math.sqrt(shape_w[-2])
        return {"w": ("uniform", shape_w, bound), "b": ("uniform", (*lead, n_out), bound)}
    return {"w": ("normal", shape_w, std), "b": ("normal", (*lead, n_out), 0.02)}


def gpt2_spec(g: dict) -> dict:
    d, layers, v = g["n_embd"], g["n_layer"], g["vocab_size"]
    proj = 0.02 / math.sqrt(2 * layers)
    return {
        "wte": ("normal", (v, d), 0.02),
        "wpe": ("normal", (g["n_positions"], d), 0.01),
        "ln_f": _ln((d,)),
        "blocks": {
            "ln_1": _ln((layers, d)),
            "attn": {"c_attn": _dense((layers, d, 3 * d), 0.02),
                     "c_proj": _dense((layers, d, d), proj)},
            "ln_2": _ln((layers, d)),
            "mlp": {"c_fc": _dense((layers, d, 4 * d), 0.02),
                    "c_proj": _dense((layers, 4 * d, d), proj)},
        },
    }


def mapper_spec(m: dict) -> dict:
    d = m["gpt_dim"]
    return {
        "linear": _dense((m["embed_dim"], m["hidden_length"] * d), None),
        "prefix_const": ("normal", (m["prefix_length"], d), 1.0),
        "layers": [{
            "ln1": _ln((d,)),
            "attn": {"in_proj": _dense((d, 3 * d), None), "out_proj": _dense((d, d), None)},
            "ln2": _ln((d,)),
            "fc1": _dense((d, 4 * d), None),
            "fc2": _dense((4 * d, d), None),
        } for _ in range(m["num_layers"])],
    }


def tower_spec(vc: dict) -> dict:
    d, layers, inter = vc["hidden_size"], vc["num_hidden_layers"], vc["intermediate_size"]
    n = (vc["image_size"] // vc["patch_size"]) ** 2
    return {
        "class_embedding": ("normal", (d,), 0.02),
        "patch_embedding": ("normal", (3 * vc["patch_size"] ** 2, d), 0.02),
        "position_embedding": ("normal", (n + 1, d), 0.02),
        "pre_layernorm": _ln((d,)),
        "layers": {
            "ln1": _ln((layers, d)),
            "attn": {w: _dense((layers, d, d), 0.02) for w in ("q", "k", "v", "out")},
            "ln2": _ln((layers, d)),
            "mlp": {"fc1": _dense((layers, d, inter), 0.02),
                    "fc2": _dense((layers, inter, d), 0.02)},
        },
        "post_layernorm": _ln((d,)),
        "visual_projection": {"w": ("normal", (d, vc["projection_dim"]), 0.02)},
    }


def _leaves(spec, out: list) -> None:
    if isinstance(spec, dict):
        for v in spec.values():
            _leaves(v, out)
    elif isinstance(spec, list):
        for v in spec:
            _leaves(v, out)
    else:
        out.append(spec)


def _numel(shape) -> int:
    return math.prod(shape)


def build(spec, gen: torch.Generator, device, bf16: bool, dtype=torch.float32):
    """The tree ``spec`` describes, drawn from ``gen`` on ``device`` in one
    normal and one uniform call, every leaf its own tensor of ``dtype``."""
    leaves: list = []
    _leaves(spec, leaves)
    n_normal = sum(_numel(s[1]) for s in leaves if s[0] in ("normal", "ln_scale"))
    n_uniform = sum(_numel(s[1]) for s in leaves if s[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    pos = {"normal": 0, "uniform": 0}

    def make(s):
        kind, shape = s[0], s[1]
        src = "uniform" if kind == "uniform" else "normal"
        buf = uniform if src == "uniform" else normal
        n = _numel(shape)
        raw = buf[pos[src]: pos[src] + n].view(shape)
        pos[src] += n
        if kind == "normal":
            t = raw * s[2]
        elif kind == "ln_scale":
            t = 1.0 + 0.1 * raw
        else:
            t = (2.0 * raw - 1.0) * s[2]
        if bf16:
            t = t.to(torch.bfloat16)
        return t.to(dtype).contiguous()

    def walk(sp):
        if isinstance(sp, dict):
            return {k: walk(v) for k, v in sp.items()}
        if isinstance(sp, list):
            return [walk(v) for v in sp]
        return make(sp)

    return walk(spec)


def tree_leaves(tree) -> list[torch.Tensor]:
    out: list = []
    _leaves(tree, out)
    return out


def tree_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        return [pv for k, v in tree.items() for pv in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [pv for i, v in enumerate(tree) for pv in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def captioner(cfg: dict, seed: int, device, bf16: bool) -> tuple[dict, dict]:
    """(mapper tree, GPT-2 tree), float32, from the run's seed."""
    gen = generator(seed, 1, device)
    gpt = build(gpt2_spec(cfg["gpt2"]), gen, device, bf16)
    mp = build(mapper_spec(cfg["mapping"]), gen, device, bf16)
    return mp, gpt


def tower(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """CLIP's vision tower in ``dtype`` (bf16 values), from the run's seed."""
    return build(tower_spec(cfg["vision"]), generator(seed, 2, device), device, True, dtype)
