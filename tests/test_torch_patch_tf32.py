"""The float32 route of the patch embedding (``csrc/patch_embed.cu``: wgmma
TF32, the three-term split), emulated in torch on the CPU, and the two rules
that only the card shows a breach of.

The kernel normalises each pixel as ``patch_embed_plain`` does (float32,
step by step), splits it into its TF32 pair (hi = tf32(x), lo = tf32(x -
hi), rounded as ``cvt.rna``), splits W alike, and walks K in stages of 32
pixels of one channel, a pixel group's three channels in turn; each k8 step
adds xl wh, xh wl, xh wh (an exact 8-term sum each) into a fresh float32
accumulator, which after at most ``PE_TF32_CHAIN`` k8 steps is added into
the float32 running tile (warpgroup 1, the tile's output columns 64-127,
ends its chains one stage before warpgroup 0); then the bias.  The emulation rounds
each accumulation toward zero (the tensor core may truncate) or to nearest,
at the three towers' K (3,072, 768, 768) on the inputs ``chip_smoke.py``
gives the kernel (uniform pixels, W of std 0.02, a bias of std 0.1), made
here with numpy.  The header's bound: within 2^-20 sum_k |x_k w_k| of the
float64 product plus 2^-23 of every running sum (each accumulation and each
fold), far inside PATCH_TOL.  A chain over the whole of CLIP's K would take
more than a tenth of PATCH_TOL: the short chains are the rule that keeps
the drift of the card's float32 accumulation off the twin.  The other rule
is the register trade's, which hung flash attention's first calls on the
card (a release in one of the SM's four sub-partitions, the .inc waiting in
another): the route trades no registers, since its consumers' two
accumulator sets fit what ptxas gives every thread, and it waits on every
mbarrier with a bounded wait; both are read from the mirrored layout and the
source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS
from gpt2_image_captioning_tpu_torch.ops import attention as A
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.ops import patch_embed as PE
from test_torch_tf32_split import K8, SPLIT_BOUND, STEP_BOUND, round_toward_zero, split

CSRC = Path(PE.__file__).resolve().parent.parent / "csrc"
STAGE_PIXELS = 32  # csrc/patch_embed.cu PF_BK: a stage's K, 32 pixels of one channel
TOWERS = {name: (p, d, bias) for name, _, p, d, bias in chip_smoke.TOWERS}
IMAGES = {"clip": 2, "vit": 1, "dino": 1}  # 98, 196 and 196 patches


def tower_inputs(name: str, seed: int):
    """One tower's kernel inputs as chip_smoke.py makes them, from numpy: uint8
    pixels at 224 px, W (3 p^2, D) of std 0.02, the bias or None, and the
    spec's mean / inv_std vectors."""
    p, d, with_bias = TOWERS[name]
    rng = np.random.default_rng(seed)
    px = torch.from_numpy(rng.integers(0, 256, size=(IMAGES[name], 224, 224, 3), dtype=np.uint8))
    w = torch.tensor(0.02 * rng.standard_normal((3 * p * p, d)), dtype=torch.float32)
    bias = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32) if with_bias else None
    mean, inv = PE.normalization_vectors(SPECS[name], p)
    return px, w, bias, mean, inv, p


def normalised_rows(px, mean, inv, p) -> torch.Tensor:
    """The (M, K) float32 values the producer writes, in W's row order:
    x * (1/255), then (x - mean) * inv_std, each step rounded."""
    x = PE._unfold_u8(px, p).float() * (1.0 / 255.0)
    return (x - mean) * inv


def route_sums(x: torch.Tensor, w: torch.Tensor, chain: int, truncate: bool,
               warpgroup: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 route's sums of x @ w before the bias, as ``warpgroup``
    folds its chains (the stages' K order: pixel groups, each group's three
    channels), and the sum over its roundings of |running sum| (the
    accumulation bound's measure)."""
    k, pp = x.shape[1], x.shape[1] // 3
    order = [c * pp + STAGE_PIXELS * g + j for g in range(pp // STAGE_PIXELS)
             for c in range(3) for j in range(STAGE_PIXELS)]
    (xh, xl), (wh, wl) = split(x[:, order]), split(w[order])
    chain_stages = chain // (STAGE_PIXELS // K8)
    run = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    acc, seen = torch.zeros_like(run), torch.zeros_like(run, dtype=torch.float64)
    for step, k0 in enumerate(range(0, k, K8)):
        ks = slice(k0, k0 + K8)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            exact = acc.double() + a[:, ks].double() @ b[ks].double()
            acc = round_toward_zero(exact) if truncate else exact.to(torch.float32)
            seen += acc.double().abs()
        stage, last = step // (STAGE_PIXELS // K8), k0 + K8 >= k
        if (step + 1) % (STAGE_PIXELS // K8) == 0 and (
                (stage + warpgroup) % chain_stages == chain_stages - 1 or last):
            run = run + acc
            seen += run.double().abs()
            acc = torch.zeros_like(acc)
    return run, seen


def kernel_sums(x, w, chain: int, truncate: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """route_sums for each output column as its warpgroup folds it: columns
    64-127 of every 128-column tile are warpgroup 1's."""
    (s0, n0), (s1, n1) = (route_sums(x, w, chain, truncate, g) for g in (0, 1))
    second = ((torch.arange(w.shape[1]) % 128) >= 64)[None, :]
    return torch.where(second, s1, s0), torch.where(second, n1, n0)


def entry_registers(threads: int) -> int:
    """ptxas's registers a thread for one block of ``threads`` an SM: each of
    the SM's four sub-partitions holds 16,384 and a quarter of the warps,
    rounded down to 8."""
    return 16384 // 32 // -(-threads // 32 // 4) // 8 * 8


def patch_tol(want: torch.Tensor) -> torch.Tensor:
    atol, rtol = chip_smoke.PATCH_TOL
    return atol + rtol * want.abs()


@pytest.mark.parametrize("truncate", [True, False], ids=["toward_zero", "to_nearest"])
@pytest.mark.parametrize("name", list(TOWERS))
def test_float32_route_within_its_header_bound_and_a_tenth_of_patch_tol(name, truncate):
    """Each tower's float32 route at PE_TF32_CHAIN: the sums within the
    header's bound of float64; after the bias within PATCH_TOL / 10 of the
    float64 result and within PATCH_TOL of ``patch_embed_plain``."""
    px, w, bias, mean, inv, p = tower_inputs(name, 11)
    x = normalised_rows(px, mean, inv, p)
    sums, seen = kernel_sums(x, w, PE.PE_TF32_CHAIN, truncate)
    exact = x.double() @ w.double()
    bound = SPLIT_BOUND * (x.double().abs() @ w.double().abs()) + STEP_BOUND * seen
    assert bool(((sums.double() - exact).abs() <= bound).all())
    got = sums if bias is None else sums + bias
    if bias is not None:
        exact = exact + bias.double()
    assert bool(((got.double() - exact).abs() <= patch_tol(exact) / 10).all())
    want = PE.patch_embed_plain(px, w, mean, inv, p, bias)
    assert bool(((got - want).abs() <= patch_tol(want)).all())


def test_a_chain_over_clips_whole_k_takes_more_than_a_tenth_of_patch_tol():
    """The rule the short chains keep: one accumulator over CLIP's K 3,072
    (384 k8 steps, 1,152 instructions), rounded toward zero, drifts past a
    tenth of PATCH_TOL on these inputs, where PE_TF32_CHAIN stays within it
    (the test above)."""
    px, w, _, mean, inv, p = tower_inputs("clip", 11)
    x = normalised_rows(px, mean, inv, p)
    sums, _ = route_sums(x, w, x.shape[1] // K8, True, 0)
    exact = x.double() @ w.double()
    assert float(((sums.double() - exact).abs() / patch_tol(exact)).max()) > 0.1


@pytest.mark.parametrize("dtype, want", [(torch.float32, 0.359), (torch.bfloat16, 0.0598)],
                         ids=["float32", "bf16"])
def test_patch_embed_bound_at_clip_b256(dtype, want):
    """CLIP B/32 at b 256: 59.2 GFLOP, bound by operations, float32 at the
    TF32 split's 165 TFLOP/s, bf16 at 989."""
    got = chip_smoke.patch_embed_bound(256, 224, 32, 768, dtype)
    assert got["operations"] == 2 * 12_544 * 3_072 * 768
    assert got["bound_by"] == "operations"
    assert abs(got["bound_ms"] - want) <= 0.01 * want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
def test_patch_layout_fits_the_block_and_its_chain_fits_the_drift_rule(dtype):
    """Each route's mirrored layout: two consumer warpgroups beside one
    producer warpgroup, a producer thread a row (a patch); its shared memory,
    with 1 KB for the barriers beside it, within 227 KB; float32 chains
    whole stages long and within LINEAR_TF32_BOXES' 300 instructions."""
    lay = PE.patch_layout(dtype)
    assert lay.rows == 128 and lay.threads == 3 * 128
    assert lay.smem_bytes + 1024 <= A.SMEM_LIMIT
    if dtype == torch.float32:
        assert lay.chain == PE.PE_TF32_CHAIN and lay.chain % (lay.k_stage // K8) == 0
        assert 3 * lay.chain <= 3 * 4 * DS.LINEAR_TF32_BOXES
        stage = 2 * lay.rows * lay.k_stage * 4 + lay.cols * lay.k_stage * 4
        assert lay.smem_bytes == 1024 + lay.stages * stage


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
def test_accumulators_fit_without_a_register_trade(dtype):
    """No setmaxnreg, so no sub-partition can wait for registers another
    released: a consumer thread's accumulators (bf16: one m64n256 set, 128
    registers; float32: the chain's and the running tile's of m64n128, 128,
    and a k8 step's TF32 fragment pair, 8) and 24 more fit the registers
    ptxas gives every thread of the block (the SM's 16,384 a sub-partition
    over its quarter of the warps)."""
    lay = PE.patch_layout(dtype)
    need = 128 + 8 if dtype == torch.float32 else lay.cols // 2
    assert need + 24 <= entry_registers(lay.threads)


def test_patch_embed_source_keeps_the_card_only_rules():
    """No mma.sync and no per-thread cp.async left (TMA's bulk tensor copies
    excepted) in patch_embed.cu or common.cuh; patch_embed.cu trades no
    registers (no setmaxnreg), and its float32 kernel waits on every
    mbarrier with wait_or_trap."""
    pe = (CSRC / "patch_embed.cu").read_text()
    common = (CSRC / "common.cuh").read_text()
    for text in (pe, common):
        assert "mma.sync" not in text and "mma_tf32" not in text
        assert re.findall(r"cp\.async(?!\.bulk)|cp_async", text) == []
    assert "setmaxnreg_" not in pe
    tf32 = pe[pe.index("patch_embed_kernel_tf32(const uint8_t"):pe.index("static int w_map(")]
    assert "mbar_wait(" not in tf32 and tf32.count("wait_or_trap(") == 3


def test_chain_length_is_mirrored_by_the_kernel():
    """ops/patch_embed.py::PE_TF32_CHAIN is the constant the kernel folds by."""
    pe = (CSRC / "patch_embed.cu").read_text()
    got = re.findall(r"constexpr int PE_TF32_CHAIN = (\d+);", pe)
    assert got == [str(PE.PE_TF32_CHAIN)]
