"""The grid of the vocabulary walk (``csrc/vocab_walk.cuh``,
``ops/decode_step.py::vocab_plan``), its ring (``vocab_ring``), the scratch
the four vocabulary wrappers size from them, and the wrappers' argument
checks.  The kernels themselves run only on the card (``chip_smoke.py
--only vocab`` holds them to their twins)."""

import pytest
import torch

from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

VOCABS = (1, 31, 32, 33, 50257)
ROWS = (1, 3, 63, 64, 65, 127, 128, 129, 255, 512)


def covers_once(tiles: int, ranges: int, v: int) -> bool:
    """Whether ``ranges`` ranges of ``tiles`` tiles, as the kernels cut them,
    cover [0, tiles) once each in order, each holding a tile, their sizes
    apart by at most one, and the tiles' columns below V are [0, V)."""
    spans = [DS.VocabPlan.span(tiles, ranges, r) for r in range(ranges)]
    sizes = [hi - lo for lo, hi in spans]
    columns = [c for lo, hi in spans for c in range(lo * DS.VOCAB_BN, hi * DS.VOCAB_BN) if c < v]
    return (spans[0][0] == 0 and spans[-1][1] == tiles
            and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1 and columns == list(range(v)))


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("m", ROWS)
def test_vocab_plan_covers_each_column_once_balanced_to_one_tile(m, v):
    """A full pass's ranges and the sampler's rare passes' cover the V
    columns once each, balanced to one tile (the last tile reaching past V,
    which the kernels mask); the row tiles cover the M rows; a full pass
    puts a block on every SM at most once, and a rare pass spreads a row
    tile over as many blocks as a full pass has."""
    plan = DS.vocab_plan(m, v)
    assert plan.tiles == -(-v // DS.VOCAB_BN)
    assert covers_once(plan.tiles, plan.ranges, v)
    assert covers_once(plan.tiles, plan.rare_ranges, v)
    assert plan.rows == (64 if m <= 64 else 128)
    assert (plan.row_tiles - 1) * plan.rows < m <= plan.row_tiles * plan.rows
    assert plan.row_tiles * plan.ranges <= max(DS.SMS, plan.row_tiles)
    if plan.tiles >= DS.SMS:  # the full vocabulary: every SM gets a block
        assert plan.row_tiles * plan.ranges > DS.SMS - plan.row_tiles
    assert plan.rare_ranges == min(plan.tiles, plan.row_tiles * plan.ranges)
    assert plan.ranges <= plan.rare_ranges <= plan.tiles


# The card's shared memory a block may take (227 KB) less the walk's static
# barriers; the ring's budget and its alignment slack must fit under it.
SMEM_LIMIT = 232448 - 3 * 8 * 8
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory, of which a block may take SMEM_LIMIT


@pytest.mark.parametrize("kernel", ["topk", "sample", "argmax"])
@pytest.mark.parametrize("el", [1, 2, 4], ids=["int8", "bf16", "float32"])
@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("m", (1, 65, 512))
def test_vocab_partials_hold_every_row_block(kernel, el, m, v):
    """The wrappers size their partials as M x the partials ``vocab_partials``
    gives, in every operand type: that holds one slot for every (row, block)
    any pass writes — the walk's (row, range), and the sampler's rare
    passes' (row, rare range) — and each slot lands inside.  The plan
    counts on a block an SM: at every operand size a block's ring takes
    more than half an SM's shared memory, so a full pass's blocks, no more
    than the SMs, run in one wave."""
    blocks, parts = DS.vocab_partials(kernel, m, v)
    plan = DS.vocab_plan(m, v)
    passes = [plan.ranges] + ([plan.rare_ranges] if kernel == "sample" else [])
    assert blocks == passes[0]
    for n in passes:  # a pass's slot of (row, block) is row * n + block
        slots = {row * n + blk for row in range(m) for blk in range(n)}
        assert len(slots) == m * n and max(slots) < m * parts
    _, smem = DS.vocab_ring(plan.rows, el, store=False)
    assert 2 * smem > SMEM_PER_SM
    assert plan.row_tiles * plan.ranges <= max(DS.SMS, plan.row_tiles)


@pytest.mark.parametrize("el", [1, 2, 4], ids=["int8", "bf16", "float32"])
@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("m", ROWS)
def test_vocab_ring_holds_whole_stages_within_shared_memory(m, v, el):
    """The ring of a plan's block: every stage holds the rows' 128-byte box
    and wte's 128-row box (twice each in float32: the TF32 hi and lo), the
    stages fill the 192 KB budget as far as whole stages go (8 at most), and
    with the 1,024 bytes of alignment slack fit the card's shared memory.
    The float32 walk keeps 3 stages at 128 rows and 4 at 64, bf16 and int8
    their 6 and 8."""
    plan = DS.vocab_plan(m, v)
    stages, smem = DS.vocab_ring(plan.rows, el)
    stage = (plan.rows + DS.VOCAB_BN) * 128 * (2 if el == 4 else 1)
    assert smem == 1024 + stages * stage <= SMEM_LIMIT
    assert stages == 8 or (stages + 1) * stage > 192 * 1024 >= stages * stage
    assert stages == {(128, 4): 3, (64, 4): 4, (128, 2): 6, (64, 2): 8,
                      (128, 1): 6, (64, 1): 8}[(plan.rows, el)]
    assert stages >= 2  # a box lands while another is multiplied


def test_vocab_plan_is_cached_per_shape():
    assert DS.vocab_plan(512, 50257) is DS.vocab_plan(512, 50257)
    assert DS.vocab_plan(512, 50257).ranges == DS.SMS // 4


def vocab_args(b=4, d=16, v=40, wdtype=torch.bfloat16):
    x32 = torch.zeros(b, d)
    lnf = torch.zeros(2, d)
    wte = torch.zeros(v, d, dtype=wdtype)
    return x32, lnf, wte


TOPK_REFUSALS = {
    "k_zero": (dict(), dict(k=0), "k must be in"),
    "k_above_16": (dict(v=40), dict(k=17), "k must be in"),
    "k_above_v": (dict(v=3), dict(k=4), r"k must be in \[1, 3\]"),
    "wte_float64": (dict(wdtype=torch.float64), dict(k=2), "unsupported compute dtype"),
    "int8_without_scale": (dict(wdtype=torch.int8), dict(k=2, compute_dtype=torch.bfloat16),
                           "wte must be int8 with wte_scale"),
    "width_apart": (dict(), dict(k=2, wte=torch.zeros(40, 24, dtype=torch.bfloat16)),
                    r"wte must be contiguous \(V, D\)"),
    "lnf_shape": (dict(), dict(k=2, lnf=torch.zeros(3, 16)), r"lnf must be contiguous"),
    "x32_bf16": (dict(), dict(k=2, x32=torch.zeros(4, 16, dtype=torch.bfloat16)),
                 "x32 must be contiguous float32"),
    "cpu_tensors": (dict(), dict(k=2), "CUDA tensor"),
}


@pytest.mark.parametrize("case", list(TOPK_REFUSALS))
def test_logits_topk_cuda_refuses_bad_arguments_on_the_cpu(case):
    """Every check short of the device shows on CPU tensors; valid CPU
    tensors are refused for lying on the CPU (no fallback to the twin)."""
    shape, kw, match = TOPK_REFUSALS[case]
    x32, lnf, wte = vocab_args(**shape)
    args = {"x32": x32, "lnf": lnf, "wte": wte, **kw}
    with pytest.raises(ValueError, match=match):
        DS.logits_topk_cuda(args["x32"], args["lnf"], args["wte"], args["k"],
                            compute_dtype=args.get("compute_dtype"))


SAMPLE_REFUSALS = {
    "k_zero": (dict(k=0), "k must be in"),
    "k_above_4": (dict(k=5), "k must be in"),
    "rounds_negative": (dict(rounds=-1), "rounds must be >= 0"),
    "temp_shape": (dict(temp=torch.ones(3)), "temp and top_p must be"),
    "top_p_float64": (dict(top_p=torch.ones(4, dtype=torch.float64)), "temp and top_p must be"),
    "wte_float16": (dict(wte=torch.zeros(40, 16, dtype=torch.float16)),
                    "unsupported compute dtype"),
    "scale_shape": (dict(wte=torch.zeros(40, 16, dtype=torch.int8),
                         wte_scale=torch.ones(39), compute_dtype=torch.bfloat16),
                    "wte_scale must be"),
    "cpu_tensors": (dict(), "CUDA tensor"),
}


@pytest.mark.parametrize("case", list(SAMPLE_REFUSALS))
def test_logits_sample_cuda_refuses_bad_arguments_on_the_cpu(case):
    kw, match = SAMPLE_REFUSALS[case]
    x32, lnf, wte = vocab_args()
    args = {"wte": wte, "temp": torch.ones(4), "top_p": torch.ones(4), "k": 3, "rounds": 6,
            "wte_scale": None, "compute_dtype": None, **kw}
    with pytest.raises(ValueError, match=match):
        DS.logits_sample_cuda(x32, lnf, args["wte"], args["temp"], args["top_p"], 0, args["k"],
                              args["rounds"], wte_scale=args["wte_scale"],
                              compute_dtype=args["compute_dtype"])


VOCAB_REFUSALS = {
    "wte_float64": (dict(wte=torch.zeros(40, 16, dtype=torch.float64)),
                    "unsupported compute dtype"),
    "wte_float16": (dict(wte=torch.zeros(40, 16, dtype=torch.float16)),
                    "unsupported compute dtype"),
    "int8_without_scale": (dict(wte=torch.zeros(40, 16, dtype=torch.int8),
                                compute_dtype=torch.bfloat16), "wte must be int8 with wte_scale"),
    "scale_without_int8": (dict(wte_scale=torch.ones(40)), "wte must be int8 with wte_scale"),
    "scale_shape": (dict(wte=torch.zeros(40, 16, dtype=torch.int8), wte_scale=torch.ones(39),
                         compute_dtype=torch.bfloat16), "wte_scale must be"),
    "width_apart": (dict(wte=torch.zeros(40, 24, dtype=torch.bfloat16)),
                    r"wte must be contiguous \(V, D\)"),
    "width_unaligned": (dict(x32=torch.zeros(4, 12), lnf=torch.zeros(2, 12),
                             wte=torch.zeros(40, 12, dtype=torch.bfloat16)),
                        "D must be a multiple of 16"),
    "lnf_shape": (dict(lnf=torch.zeros(3, 16)), r"lnf must be contiguous"),
    "x32_bf16": (dict(x32=torch.zeros(4, 16, dtype=torch.bfloat16)),
                 "x32 must be contiguous float32"),
    "cpu_tensors": (dict(), "CUDA tensor"),
    "cpu_tensors_float32": (dict(wte=torch.zeros(40, 16)), "CUDA tensor"),
    "cpu_tensors_int8": (dict(wte=torch.zeros(40, 16, dtype=torch.int8), wte_scale=torch.ones(40),
                              compute_dtype=torch.bfloat16), "CUDA tensor"),
}


@pytest.mark.parametrize("wrapper", ["logits_argmax_cuda", "logits_cuda"])
@pytest.mark.parametrize("case", list(VOCAB_REFUSALS))
def test_argmax_and_logits_cuda_refuse_bad_arguments_on_the_cpu(wrapper, case):
    """The argmax's and the store's wrappers (the walk in every operand type)
    check dtype, shape and alignment before the device, so the refusals show
    on CPU tensors; valid CPU tensors are refused for lying on the CPU (no
    fallback to the twin)."""
    kw, match = VOCAB_REFUSALS[case]
    x32, lnf, wte = vocab_args()
    args = {"x32": x32, "lnf": lnf, "wte": wte, "wte_scale": None, "compute_dtype": None, **kw}
    with pytest.raises(ValueError, match=match):
        getattr(DS, wrapper)(args["x32"], args["lnf"], args["wte"], wte_scale=args["wte_scale"],
                             compute_dtype=args["compute_dtype"])
