"""The three-term TF32 split of the float32 vocabulary walk
(``csrc/vocab_walk.cuh``) and of the float32 projections
(``csrc/fused_linear.cu``), emulated in torch on the CPU.

The walk multiplies float32 operands on ``wgmma`` TF32: each operand x is
split as xh = tf32(x) (``cvt.rna``: to nearest, ties away from zero) and
xl = tf32(x - xh); a logit accumulates xl wh + xh wl + xh wh into float32,
one k8 step of each product at a time.  The header states two bounds: the
split leaves a logit within 2^-20 sum_k |x_k w_k| of the exact sum, and the
float32 accumulation adds at most 2^-23 of the running sum each product
instruction (3 a k8 step).  The walk's converter warps round wte by the
same integer operations as ``tf32_rna`` below (``tf32_rna_bits``); the
known answers pin that to ``cvt.rna``'s rounding.  Here the rounding is
done on an int32 view, the products in float64 (a TF32 x TF32 product is
exact there), and the accumulator is rounded to float32 toward zero (the
tensor core may truncate) and to nearest, at D 768 with LN-scale rows and
wte of std 0.02 over V 1,025.  The four vocabulary kernels select from the
walk's logits in float32 as in every operand type: the emulated walk fed
to the top-k's and the sampler's selections is held to their float32
twins and to float64.  The projections run the same products a K-slice of
``linear_plan``'s float32 split each, the slices' partial sums added in
rank order by the cluster, then the bias and the epilogue: emulated for
the four roles of a GPT-2 layer at D 768 and 128 rows.
"""

import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.sampling import topk_small

D, V, B = 768, 1025, 16
K8 = 8  # wgmma m64n128k8: K a product instruction
SPLIT_BOUND = 2.0 ** -20  # of sum_k |x_k w_k|: the split alone
STEP_BOUND = 2.0 ** -23   # of the running sum: one float32 rounding a product instruction
TF_TOL_F32 = 1e-3         # chip_smoke.py: the float32 greedy path's teacher-forced bound


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 explicit significand bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``: half a TF32 ulp (bit 12)
    added to the magnitude bits, the low 13 bits dropped; the sign bit
    stays (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``common.cuh::split_tf32``: hi = tf32(x), lo = tf32(x - hi), the
    difference exact in float32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def operands(seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """LN-scale rows (as LN_f gives them: N(0, 1) times a scale near 1 plus
    a small bias) and a wte of std 0.02, float32, from numpy."""
    rng = np.random.default_rng(seed)
    scale = 1 + 0.1 * rng.standard_normal(D)
    bias = 0.1 * rng.standard_normal(D)
    x = rng.standard_normal((B, D)) * scale + bias
    w = 0.02 * rng.standard_normal((V, D))
    return torch.tensor(x, dtype=torch.float32), torch.tensor(w, dtype=torch.float32)


def step_inputs(seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The vocabulary kernels' inputs as the step gives them, from numpy: the
    float32 residual stream, LN_f's (2, D) scale and bias, wte (V, D)."""
    rng = np.random.default_rng(seed)
    x32 = torch.tensor(3.0 * rng.standard_normal((B, D)), dtype=torch.float32)
    lnf = torch.tensor(np.stack([1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D)]),
                       dtype=torch.float32)
    wte = torch.tensor(0.02 * rng.standard_normal((V, D)), dtype=torch.float32)
    return x32, lnf, wte


def round_toward_zero(exact: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to float32 toward zero."""
    near = exact.to(torch.float32)
    away = near.double().abs() > exact.abs()
    return torch.where(away, torch.nextafter(near, torch.zeros_like(near)), near)


def walk_logits(x: torch.Tensor, w: torch.Tensor, truncate: bool) -> tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """The walk's float32 logits of x @ w^T, and the sum over its product
    instructions of |running sum| (the accumulation bound's measure): for
    each k8 step the three products xl wh, xh wl, xh wh, each an exact
    8-term sum added to the float32 accumulator with one rounding."""
    (xh, xl), (wh, wl) = split(x), split(w)
    acc = torch.zeros(x.shape[0], w.shape[0], dtype=torch.float32)
    seen = torch.zeros_like(acc, dtype=torch.float64)
    for k0 in range(0, x.shape[1], K8):
        ks = slice(k0, k0 + K8)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            exact = acc.double() + a[:, ks].double() @ b[:, ks].double().t()
            acc = round_toward_zero(exact) if truncate else exact.to(torch.float32)
            seen += acc.double().abs()
    return acc, seen


@pytest.mark.parametrize("value, want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # just below the tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),     # a tie above an odd TF32 value: away
    (2.0 - 2.0 ** -23, 2.0),                     # the carry into the exponent
    (0.0, 0.0),
])
def test_tf32_rna_rounds_to_nearest_ties_away(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == want


def test_split_parts_are_tf32_and_recover_x_to_2_pow_22():
    """hi and lo have no bits below TF32's, and hi + lo is x within 2^-22 |x|."""
    x = torch.tensor(np.random.default_rng(1).standard_normal(100_000) * 10.0 ** np.arange(
        -3, 3, 6 / 100_000), dtype=torch.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_split_product_within_the_header_bound_of_float64():
    """The three products summed exactly: within 2^-20 sum_k |x_k w_k| of the
    float64 product; the dropped xl wl term is what is left."""
    x, w = operands()
    (xh, xl), (wh, wl) = split(x), split(w)
    exact = x.double() @ w.double().t()
    three = xl.double() @ wh.double().t() + xh.double() @ wl.double().t() + \
        xh.double() @ wh.double().t()
    mass = x.double().abs() @ w.double().abs().t()
    err = (three - exact).abs()
    assert bool((err <= SPLIT_BOUND * mass).all())
    # the split keeps float32's precision: far tighter than TF32 alone
    tf32_alone = (xh.double() @ wh.double().t() - exact).abs()
    assert float(err.max()) < float(tf32_alone.max()) / 100


@pytest.mark.parametrize("truncate", [True, False], ids=["toward_zero", "to_nearest"])
def test_walk_accumulation_within_the_header_bound_far_inside_tf_tol(truncate):
    """The walk's order with a float32 accumulator: within the split bound
    plus 2^-23 of every running sum, and that bound far inside TF_TOL_F32
    (the float32 greedy path's) and the kernel checks' 1e-4 + 1e-4 |logit|."""
    x, w = operands(2)
    got, seen = walk_logits(x, w, truncate)
    exact = x.double() @ w.double().t()
    mass = x.double().abs() @ w.double().abs().t()
    bound = SPLIT_BOUND * mass + STEP_BOUND * seen
    err = (got.double() - exact).abs()
    assert bool((err <= bound).all())
    assert float(bound.max()) < TF_TOL_F32 / 10
    assert bool((err <= 1e-4 + 1e-4 * exact.abs()).all())


def test_walk_emulation_matches_the_float32_twin():
    """The emulated walk (LN_f's rows as the pre-pass writes them) against
    ``logits_plain`` in float32, the twin the card's kernel is held to, at
    the kernel checks' float32 tolerance."""
    x32, lnf, wte = step_inputs(3)
    rows = nn.layer_norm_rows(lnf[0], lnf[1], x32, 1e-5)
    got, _ = walk_logits(rows, wte, truncate=True)
    want = DS.logits_plain(x32, lnf, wte)
    assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


def walk_step(seed: int):
    """The emulated walk of LN_f's rows (as the pre-pass writes them) over
    wte: (inputs, rows, the walk's float32 logits, the float64 product, and
    each logit's bound from the header's two terms)."""
    x32, lnf, wte = step_inputs(seed)
    rows = nn.layer_norm_rows(lnf[0], lnf[1], x32, 1e-5)
    got, seen = walk_logits(rows, wte, truncate=True)
    exact = rows.double() @ wte.double().t()
    bound = SPLIT_BOUND * (rows.double().abs() @ wte.double().abs().t()) + STEP_BOUND * seen
    return (x32, lnf, wte), got, exact, bound


@pytest.mark.parametrize("k", [1, 4, 16])
def test_walk_fed_to_the_topk_selection_within_tf_tol_of_its_twin(k):
    """The top-k's selection (k largest, ties to the lowest id, and the
    logsumexp) of the emulated walk's logits against ``logits_topk_plain``
    in float32: values and logsumexp within TF_TOL_F32, and the ids equal on
    every row whose top-(k+1) float64 logits lie further apart than twice
    the walk's bound and the twin's measured error — most rows here."""
    (x32, lnf, wte), got, exact, bound = walk_step(4)
    vals, ids = topk_small(got, k)
    lse = torch.logsumexp(got, dim=-1, keepdim=True)
    want_v, want_i, want_l = DS.logits_topk_plain(x32, lnf, wte, k)
    assert float((vals - want_v).abs().max()) <= TF_TOL_F32
    assert float((lse - want_l).abs().max()) <= TF_TOL_F32
    twin_err = (DS.logits_plain(x32, lnf, wte).double() - exact).abs().amax(dim=1)
    slack = 2 * (bound.amax(dim=1) + twin_err)
    top, _ = torch.sort(exact, dim=-1, descending=True)
    clear = ((top[:, :k] - top[:, 1:k + 1]) > slack[:, None]).all(dim=1)
    assert int(clear.sum()) >= B * 3 // 4
    assert torch.equal(ids[clear], want_i[clear])


def keep_sets(lq: torch.Tensor, top_p: torch.Tensor, delta: torch.Tensor | None = None):
    """The sampler's acceptance rule on float64 scaled logits (B, V): token i
    is accepted iff the mass of the tokens whose logit is strictly above its
    own is <= top_p.  With ``delta`` (B,), also whether each row's rule is
    stable: for logits anywhere within delta of these, every token's mass
    above stays on its side of top_p (the tokens more than 2 delta above
    it, each mass down by e^-2delta, to the tokens within 2 delta of it or
    above, each up by e^2delta)."""
    prob = torch.softmax(lq, dim=-1)
    s, order = torch.sort(lq, dim=-1)
    tail = torch.cat([prob.gather(-1, order).flip(-1).cumsum(-1).flip(-1),
                      torch.zeros(lq.shape[0], 1, dtype=lq.dtype)], dim=-1)

    def mass_above(at):  # the mass of the logits strictly above ``at``
        return tail.gather(-1, torch.searchsorted(s, at.contiguous(), right=True))

    keep = mass_above(lq) <= top_p[:, None]
    if delta is None:
        return keep
    d = 2 * delta[:, None]
    low = torch.exp(-d) * mass_above(lq + d)
    high = torch.exp(d) * (mass_above(lq - d) - prob)
    return keep, ((low <= top_p[:, None]) == (high <= top_p[:, None])).all(dim=1)


@pytest.mark.parametrize("temperature, top_p", [(1.0, 0.9), (0.5, 0.5)])
def test_walk_fed_to_the_sampler_keeps_the_float64_nucleus(temperature, top_p):
    """The sampler's nucleus (its acceptance rule, from the scaled logits and
    their logsumexp) on the emulated walk's logits is the nucleus of the
    float64 logits on every row whose boundary clears the walk's bound —
    most rows here; the others may part by a token at the boundary."""
    _, got, exact, bound = walk_step(5)
    tp = torch.full((B,), top_p, dtype=torch.float64)
    want, stable = keep_sets(exact / temperature, tp, bound.amax(dim=1) / temperature)
    keep = keep_sets(got.double() / temperature, tp)
    assert int(stable.sum()) >= B * 3 // 4
    assert torch.equal(keep[stable], want[stable])
    assert bool((want.sum(dim=1) < V).all()) and bool((want.sum(dim=1) > 1).all())


# ---------------------------------------------------------------------------
# The float32 projections (csrc/fused_linear.cu's TF32 route)
# ---------------------------------------------------------------------------

M_ROWS = 128  # the decode step's batch
ROLES = {  # K, N, LayerNorm prologue, epilogue: a GPT-2 layer at D 768
    "qkv": (D, 3 * D, True, "cast"), "attn_proj": (D, D, False, "residual"),
    "mlp_fc": (D, 4 * D, True, "gelu"), "mlp_proj": (4 * D, D, False, "residual"),
}


def role_inputs(role: str, seed: int):
    """One role's inputs as the step gives them, from numpy: x (the float32
    residual stream with the LN, else LN-scale rows: the attention output,
    gelu(h) for mlp_proj), W (N, K) of std 0.02, the bias, the LN's scale
    and bias or None, the residual stream or None."""
    k, n, ln, epi = ROLES[role]
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32)

    x = t((3.0 if ln else 1.0) * rng.standard_normal((M_ROWS, k)))
    if role == "mlp_proj":
        x = DS._gelu_new(x)
    w, bias = t(0.02 * rng.standard_normal((n, k))), t(0.02 * rng.standard_normal(n))
    lnp = (t(1 + 0.1 * rng.standard_normal(k)), t(0.1 * rng.standard_normal(k))) if ln else None
    res = t(rng.standard_normal((M_ROWS, n))) if epi == "residual" else None
    return x, w, bias, lnp, res


def projection_sums(rows: torch.Tensor, w: torch.Tensor, k_slice: int, truncate: bool):
    """The TF32 route's float32 sums of rows @ w^T before the bias: each
    K-slice of ``k_slice`` accumulated as the walk's k8 steps (xl wh, xh wl,
    xh wh, each an exact 8-term sum added with one rounding), the slices'
    partials added in rank order (float32 adds, to nearest: the cluster's
    reduction), and the sum over its additions of |running sum| (the
    accumulation bound's measure)."""
    (xh, xl), (wh, wl) = split(rows), split(w)
    total, seen = None, torch.zeros(rows.shape[0], w.shape[0], dtype=torch.float64)
    for lo in range(0, rows.shape[1], k_slice):
        acc = torch.zeros(rows.shape[0], w.shape[0], dtype=torch.float32)
        for k0 in range(lo, min(lo + k_slice, rows.shape[1]), K8):
            ks = slice(k0, k0 + K8)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                exact = acc.double() + a[:, ks].double() @ b[:, ks].double().t()
                acc = round_toward_zero(exact) if truncate else exact.to(torch.float32)
                seen += acc.double().abs()
        total = acc if total is None else total + acc
        seen += total.double().abs()
    return total, seen


@pytest.mark.parametrize("truncate", [True, False], ids=["toward_zero", "to_nearest"])
@pytest.mark.parametrize("role", list(ROLES))
def test_projection_route_within_the_header_bound_and_tf_tol_of_its_twin(role, truncate):
    """Each role at D 768 and 128 rows in linear_plan's float32 split: the
    sums within the header bound of float64 (the split's 2^-20 of sum |x w|
    and 2^-23 of every running sum, the slices' additions among them), and
    after the bias and the epilogue (cast, gelu_new, the residual add)
    within TF_TOL_F32 of ``fused_linear_plain`` and the kernel checks'
    1e-4 + 1e-4 |y|."""
    k, n, ln, epi = ROLES[role]
    x, w, bias, lnp, res = role_inputs(role, 6)
    plan = DS.linear_plan(M_ROWS, k, n, 4)
    assert plan.splits * plan.k_slice >= k > (plan.splits - 1) * plan.k_slice
    rows = x if lnp is None else nn.layer_norm_rows(lnp[0], lnp[1], x, 1e-5)  # the pre-pass's
    sums, seen = projection_sums(rows, w, plan.k_slice, truncate)
    exact = rows.double() @ w.double().t()
    mass = rows.double().abs() @ w.double().abs().t()
    bound = SPLIT_BOUND * mass + STEP_BOUND * seen
    assert bool(((sums.double() - exact).abs() <= bound).all())
    assert float(bound.max()) < TF_TOL_F32 / 10
    y = bias + sums  # the kernel's order: the bias, then each epilogue
    got = {"cast": lambda: y, "gelu": lambda: DS._gelu_new(y),
           "residual": lambda: res + y}[epi]()
    want = DS.fused_linear_plain(x, w, bias, epilogue=epi, ln=lnp,
                                 residual=None if res is None else res.clone())
    assert float((got - want).abs().max()) <= TF_TOL_F32
    assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
