"""The plain reference against the port's plain path at a tiny size on the
CPU: the same trees, the same numbers.  (The tests import the port; the
reference does not.)"""

import pytest
import torch

from h100_bench import harness as H
from h100_bench import weights
from h100_bench.reference import model as R
from h100_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trees():
    mp, gpt = weights.captioner(tiny.CONFIG, 7, CPU, bf16=False)
    tower = weights.tower(tiny.CONFIG, 7, CPU, dtype=torch.float32)
    return mp, gpt, tower


def test_mapper_matches_the_port(trees):
    from gpt2_image_captioning_tpu_torch.models import mapping as M

    mp, _, _ = trees
    emb = torch.randn(5, 16, generator=torch.Generator().manual_seed(1))
    cfg = H.port_configs(tiny.CONFIG).mapping
    got = M.apply_mapping(mp, cfg, emb, use_kernels=False)
    want = R.mapper(mp, tiny.CONFIG["mapping"], emb)
    torch.testing.assert_close(want, got.float(), rtol=1e-5, atol=1e-5)


def test_gpt2_logits_match_the_port(trees):
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G

    _, gpt, _ = trees
    x = torch.randn(3, 9, 32, generator=torch.Generator().manual_seed(2))
    got = G.forward(gpt, H.port_configs(tiny.CONFIG).gpt2, x)
    want = R.logits(gpt, R.gpt2_hidden(gpt, tiny.CONFIG["gpt2"], x))
    torch.testing.assert_close(want, got, rtol=1e-5, atol=1e-5)


def test_teacher_forced_logits_match_a_cached_decode(trees):
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    mp, gpt, _ = trees
    emb = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    cfg = H.port_configs(tiny.CONFIG)
    tokens = C.generate({"mapping": mp}, {"gpt": gpt}, cfg, emb, max_length=6, temperature=0.0,
                        use_kernels=False)
    lg = R.caption_logits(mp, gpt, tiny.CONFIG, emb, tokens)
    # the port's greedy tokens are the reference's argmax at every position
    assert torch.equal(lg.argmax(dim=-1).int(), tokens)


def test_clip_tower_matches_the_port(trees):
    from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS
    from gpt2_image_captioning_tpu_torch.models import clip

    _, _, tower = trees
    px = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(4))
    got = clip.encode_image_u8(tower, H.vision_config(tiny.CONFIG), px, SPECS["clip"],
                               use_kernels=False)
    want = R.clip_image_embeddings(tower, tiny.CONFIG["vision"], px)
    torch.testing.assert_close(want, got, rtol=1e-5, atol=1e-5)


def test_caption_loss_and_gradients_match_the_port(trees):
    from gpt2_image_captioning_tpu_torch.models import captioner as C

    from h100_bench.drivers.train import batches

    mp, gpt, _ = trees
    batch = next(batches(tiny.TRAFFIC["train"], tiny.CONFIG, torch.Generator().manual_seed(5),
                         CPU))
    leaves = [p.detach().clone().requires_grad_(True) for p in weights.tree_leaves(mp)]
    from h100_bench.drivers.train import unflatten

    port = C.mean_loss({"mapping": unflatten(mp, leaves)}, {"gpt": gpt},
                       H.port_configs(tiny.CONFIG), batch, use_kernels=False)
    g_port = torch.autograd.grad(port, leaves)
    ref_leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    ref = R.caption_loss(unflatten(mp, ref_leaves), gpt, tiny.CONFIG, batch)
    g_ref = torch.autograd.grad(ref, ref_leaves)
    torch.testing.assert_close(ref, port, rtol=1e-6, atol=1e-6)
    for a, b in zip(g_ref, g_port):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(6)
    params = [torch.randn(4, 3, generator=g), torch.randn(5, generator=g)]
    mine = [p.clone() for p in params]
    theirs = [p.clone().requires_grad_(True) for p in params]
    opt = torch.optim.AdamW(theirs, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    state = {}
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in params]
        for t, gr in zip(theirs, grads):
            t.grad = gr.clone()
        clipped = R.clip_gradients(grads, 1.0)
        torch.nn.utils.clip_grad_norm_(theirs, 1.0)
        opt.step()
        R.adamw_update(mine, clipped, state, 1e-2, 0.9, 0.999, 1e-8, 0.01)
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.14159265])
    got = R.round_tf32(x)
    # 10 mantissa bits, to nearest even: the halfway cases go to even
    assert got.tolist()[:3] == [1.0, 1.0 + 2 * 2 ** -10, 1.0 + 2 ** -10]
    assert abs(got[3] + 3.14159265) <= 2 ** -10 * 2
    y = torch.linspace(-3, 3, 101)
    f8 = R.round_fp8(y)
    assert (f8 - y).abs().max() <= 3 * 2 ** -4  # e4m3: 3 mantissa bits
    assert torch.equal(R.Precision("exact").mm(y[None], y[:, None]), y[None] @ y[:, None])
