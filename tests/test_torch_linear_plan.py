"""The split of ``csrc/fused_linear.cu``'s route in bf16, int8 and float32
(``ops/decode_step.py::linear_plan``): which columns, rows and K indices
each block owns, and what the kernel's launch needs of it.  The kernel
itself runs only on the card (``chip_smoke.py`` holds it to its twin)."""

import pytest

from gpt2_image_captioning_tpu_torch.ops import decode_step as DS


def roles(d: int):
    """(name, K, N) of a GPT-2 layer's four projections at width d."""
    return (("qkv", d, 3 * d), ("attn_proj", d, d), ("mlp_fc", d, 4 * d), ("mlp_proj", 4 * d, d))


def covered_once(size: int, spans) -> bool:
    """Whether the half-open ``spans`` cover [0, size) with each index once."""
    seen = [0] * size
    for lo, hi in spans:
        for i in range(max(lo, 0), min(hi, size)):
            seen[i] += 1
    return all(c == 1 for c in seen)


@pytest.mark.parametrize("element_size", [2, 1, 4], ids=["bf16", "int8", "f32"])
@pytest.mark.parametrize("d", [768, 1024, 1280, 1600])
@pytest.mark.parametrize("m", [1, 3, 128, 512, 120, 1920])
def test_linear_plan_covers_every_output_and_k_once(m, d, element_size):
    """Every role's (column tile, K-slice) items cover each output column and
    each K index exactly once; each slice is whole 128-byte boxes, a
    multiple of the wgmma depth (16 bf16, 32 int8, 8 float32), except the
    last slice's tail past K, which TMA zero-fills; at most 8 slices (a
    portable cluster); bf16 and int8: at least one block an SM at M 128
    (and 120, an admission of 8 images to the prefill; 1,920 rows is a
    request of 128), the ring and the partial tile fit two blocks an SM;
    float32 (a block an SM): a stage of the row pair and W's two slots, and
    the ring, fit the SM's 227 KB, and a K-slice takes at most
    LINEAR_TF32_BOXES boxes (GPT-2 XL's K 6,400 too); >= 3 stages where
    the slice has them."""
    depth = 32 // element_size
    box = DS.LINEAR_BOX_BYTES // element_size
    parts = 2 if element_size == 4 else 1  # float32: each box's TF32 hi and lo
    for name, k, n in roles(d):
        plan = DS.linear_plan(m, k, n, element_size)
        assert plan.bn in DS.LINEAR_BN, (name, plan)
        tiles = [(t * plan.bn, (t + 1) * plan.bn) for t in range(plan.n_tiles)]
        slices = [(s * plan.k_slice, min((s + 1) * plan.k_slice, k)) for s in range(plan.splits)]
        assert covered_once(n, tiles) and covered_once(k, slices), (name, plan)
        assert all(lo < hi for lo, hi in slices), (name, plan)  # no empty slice
        # the items: every (tile, slice) pair once, so each (column, k) once
        items = {(t, s) for t in range(plan.n_tiles) for s in range(plan.splits)}
        assert len(items) == plan.n_tiles * plan.splits
        assert plan.k_slice % box == 0 and plan.k_slice % depth == 0, (name, plan)
        tail = slices[-1][1] - slices[-1][0]
        assert tail % depth == 0 or slices[-1][1] == k, (name, plan)
        assert plan.splits in DS.LINEAR_SPLITS and plan.splits <= 8, (name, plan)
        rows = 64 * plan.consumers
        assert (plan.row_tiles - 1) * rows < m <= plan.row_tiles * rows
        assert plan.consumers == (1 if m <= 64 else 2)
        if m in (120, 128, 1920) and parts == 1:
            assert plan.blocks >= DS.SMS, (name, plan)
        assert plan.smem <= 227 * 1024
        per_sm = 1 if parts == 2 else 2
        assert per_sm * (plan.smem + 1024) <= 228 * 1024, (name, plan)
        assert plan.stages >= min(3, plan.k_slice // box), (name, plan)
        assert plan.smem >= 1024 + plan.stages * (rows + plan.bn) * parts * DS.LINEAR_BOX_BYTES
        if parts == 2:  # float32: a short accumulator chain a slice
            assert plan.k_slice // box <= DS.LINEAR_TF32_BOXES, (name, plan)
        assert plan.smem >= 1024 + rows * (plan.bn + DS.LINEAR_PAD) * 4  # the partial tile


@pytest.mark.parametrize("m", [128, 512, 1920, 120])
def test_linear_plan_f32_sizes_the_ring_as_the_kernel(m):
    """float32 at the decode step's 128 and 512 rows and the prefill's 1,920
    and 120: every option's ring mirrors ``lin_stages`` / ``lin_smem`` with
    a stage of (2 rows + 2 bn) x 128 bytes (the row pair, W's two slots) in
    the one-block-an-SM budget, and the plan is among the options with the
    fewest waves of one block an SM (in clusters a GPC holds) times a
    block's products and a wave's cost."""
    for name, k, n in roles(768):
        options = DS.linear_plan_options(m, k, n, 4)
        for p in options:
            rows = 64 * p.consumers
            stage = (2 * rows + 2 * p.bn) * DS.LINEAR_BOX_BYTES
            boxes = p.k_slice * 4 // DS.LINEAR_BOX_BYTES
            stages = max(1, min(boxes, DS.LINEAR_RING_BUDGET_ONE // stage, DS.LINEAR_MAX_STAGES))
            assert p.stages == stages, (name, p)
            assert p.smem == 1024 + max(stages * stage, rows * (p.bn + DS.LINEAR_PAD) * 4)
        plan = DS.linear_plan(m, k, n, 4)
        assert plan in options

        def work(p):
            wave = DS.SMS if p.splits == 1 else 8 * (16 // p.splits) * p.splits
            return -(-p.blocks // wave) * (64 * p.consumers * p.bn * p.k_slice
                                           + DS.LINEAR_WAVE_PRODUCTS)

        assert work(plan) == min(work(p) for p in options), (name, plan)


# (bn, splits, k_slice) of qkv, attn_proj, mlp_fc, mlp_proj at D 768 in
# float32: the fastest split of each role that scripts/linear_plan_sweep.py
# timed on an H100 at the decode step's 128 and 512 rows and the prefill's
# 1,920 and 120
PICKS_F32 = {
    128: ((64, 3, 256), (64, 8, 96), (128, 4, 192), (64, 8, 384)),
    512: ((128, 3, 256), (128, 4, 192), (128, 1, 768), (128, 4, 768)),
    1920: ((128, 2, 384), (128, 1, 768), (128, 1, 768), (128, 4, 768)),
    120: ((64, 3, 256), (64, 8, 96), (128, 4, 192), (64, 8, 384)),
}


@pytest.mark.parametrize("m", sorted(PICKS_F32))
def test_linear_plan_f32_keeps_the_timed_picks(m):
    """float32: the rule picks the split the card timed fastest, in every
    role at every row count of the paths."""
    got = tuple(tuple(DS.linear_plan(m, k, n, 4)[:3]) for _, k, n in roles(768))
    assert got == PICKS_F32[m]


def test_linear_plan_is_cached_per_shape():
    """The wrapper reads the plan once per shape (lru_cache), not per call."""
    assert DS.linear_plan(128, 768, 2304, 2) is DS.linear_plan(128, 768, 2304, 2)


# (bn, splits, k_slice) of qkv, attn_proj, mlp_fc, mlp_proj at D 768: the
# decode step's picks, timed on the card when the rule was fitted
PICKS = {
    (128, 2): ((32, 3, 256), (32, 6, 128), (64, 4, 192), (32, 8, 384)),
    (128, 1): ((32, 3, 256), (32, 6, 128), (32, 2, 384), (32, 8, 384)),
    (512, 2): ((128, 3, 256), (64, 4, 192), (128, 2, 384), (128, 8, 384)),
    (512, 1): ((128, 3, 256), (32, 2, 384), (64, 1, 768), (64, 4, 768)),
}


@pytest.mark.parametrize("m, element_size", sorted(PICKS), ids=lambda v: str(v))
def test_linear_plan_keeps_the_decode_picks(m, element_size):
    """At the decode step's 128 and 512 rows the rule keeps the splits the
    card timed for each GPT-2 124M role, bf16 and int8 (with the rows
    quantized by the row quantizer first, the LayerNorm roles')."""
    got = tuple(tuple(DS.linear_plan(m, k, n, element_size)[:3]) for _, k, n in roles(768))
    assert got == PICKS[(m, element_size)]


@pytest.mark.parametrize("row_bytes", [2, 4], ids=["bf16_rows", "f32_rows"])
@pytest.mark.parametrize("m", [1, 64, 65, 128, 512])
def test_linear_plan_fits_rows_quantized_in_the_product(m, row_bytes):
    """int8 weights whose rows arrive in bf16 or float32 and are quantized
    inside the product: a ring stage holds row_bytes row boxes and one weight
    box; the block fits two an SM, or, where the grid has no more blocks
    than SMs, one (its ring then holds the whole K-slice where it can);
    every output and K index is covered once."""
    box = DS.LINEAR_BOX_BYTES
    for name, k, n in roles(768):
        plan = DS.linear_plan(m, k, n, 1, row_bytes)
        rows = 64 * plan.consumers
        slices = [(s * plan.k_slice, min((s + 1) * plan.k_slice, k)) for s in range(plan.splits)]
        assert covered_once(k, slices) and plan.k_slice % box == 0, (name, plan)
        assert 1 <= plan.stages <= plan.k_slice // box, (name, plan)
        assert plan.smem >= 1024 + plan.stages * (rows * row_bytes + plan.bn) * box
        assert plan.smem >= 1024 + rows * (plan.bn + DS.LINEAR_PAD) * 4
        per_sm = 1 if plan.blocks <= DS.SMS else 2
        assert per_sm * (plan.smem + 1024) <= 228 * 1024, (name, plan)
        stage = (rows * row_bytes + plan.bn) * box
        if per_sm == 1 and plan.k_slice // box * stage <= DS.LINEAR_RING_BUDGET_ONE:
            assert plan.stages == plan.k_slice // box, (name, plan)
        assert plan in DS.linear_plan_options(m, k, n, 1, row_bytes)
