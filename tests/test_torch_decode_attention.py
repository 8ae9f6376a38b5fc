"""The port's decode attention (plain twin) against the JAX package's kernel
in interpret mode and its XLA path, at chunk boundaries and extremes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.ops import decode_attention as JDA
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu_torch.ops import decode_attention as TDA

B, N_HEAD, TK, D = 5, 4, 48, 32


def _inputs(idx, seed=0):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(3))
    kc = rng.normal(size=(TK, B, D)).astype(np.float32)
    vc = rng.normal(size=(TK, B, D)).astype(np.float32)
    # rows >= idx are garbage that must never be attended
    kc[idx:] = 1e6
    vc[idx:] = -1e6
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax_kernel", "jax_xla"])
@pytest.mark.parametrize("idx", [0, 1, 15, 16, 17, 47])
def test_decode_attention_plain_matches_jax(idx, use_pallas):
    q, kn, vn, kc, vc = _inputs(idx)
    want, kc_w, vc_w = JDA.decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(idx), n_head=N_HEAD,
        use_pallas=use_pallas, interpret=use_pallas,
    )
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, kc_g, vc_g = TDA.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tkc, tvc, idx,
        n_head=N_HEAD,
    )
    assert kc_g is tkc and vc_g is tvc  # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(kc_g.numpy(), np.asarray(kc_w))
    np.testing.assert_array_equal(vc_g.numpy(), np.asarray(vc_w))


def test_decode_attention_accepts_qkv_column_slices():
    """The step passes q/k/v as column slices of one (B, 3D) tensor."""
    q, kn, vn, kc, vc = _inputs(9)
    qkv = torch.from_numpy(np.concatenate([q, kn, vn], axis=1))
    want, _, _ = TDA.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), 9, n_head=N_HEAD,
    )
    got, _, _ = TDA.decode_attention(
        qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :], torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), 9, n_head=N_HEAD,
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("gather_start", [0, 5, 20])
def test_origin_reads_the_rows_it_names(gather_start):
    """With an ancestry map, position t in [gather_start, idx) of row r is
    cache row origin[t, r]: the same as attending an explicitly gathered
    cache; positions below gather_start and the appended row are the row's
    own, whatever the map holds there."""
    idx = 17
    q, kn, vn, kc, vc = _inputs(idx, seed=4)
    origin = np.random.default_rng(5).integers(0, B, size=(TK, B)).astype(np.int32)
    kg, vg = kc.copy(), vc.copy()
    t = np.arange(gather_start, idx)
    kg[t], vg[t] = kc[t[:, None], origin[t]], vc[t[:, None], origin[t]]
    want, _, _ = TDA.decode_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn, kg, vg)), idx, n_head=N_HEAD)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, _, _ = TDA.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tkc, tvc, idx,
        n_head=N_HEAD, origin=torch.from_numpy(origin), gather_start=gather_start)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the cache itself is not gathered: only row idx changed
    np.testing.assert_array_equal(np.delete(tkc.numpy(), idx, axis=0), np.delete(kc, idx, axis=0))
    np.testing.assert_array_equal(tkc.numpy()[idx], kn)
    if gather_start < idx:
        plain, _, _ = TDA.decode_attention(
            *(torch.from_numpy(a.copy()) for a in (q, kn, vn, kc, vc)), idx, n_head=N_HEAD)
        assert not torch.allclose(plain, got, atol=1e-3)


# csrc/decode_attention.cu walks a window in warp loads of 2, 4 or 8
# positions (float32, bf16, int8 rows at hd 64; half that at hd 128; one
# at hd 42, whose head rows miss the load vector) and block passes of 8, 32
# or 64 positions; these idx sit on each side of those boundaries and at
# the cache's last row.
WALK_IDX = [3, 4, 5, 31, 32, 33, 63, 64, 65, 79]


@pytest.mark.parametrize("idx", WALK_IDX)
@pytest.mark.parametrize("d, n_head", [(192, 3), (256, 2), (126, 3)],
                         ids=["hd64", "hd128", "hd42"])
def test_plain_matches_jax_at_the_kernels_walk_boundaries(d, n_head, idx):
    """The twin the card holds the kernel to, against the JAX package's XLA
    formula at B 3 (not a multiple of anything the kernel tiles), hd 64, 128
    and 42, T 80: 1e-5 (the JAX side sums in float32, the twin in
    float64)."""
    b, tk = 3, 80
    rng = np.random.default_rng(idx + d)
    q, kn, vn = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.normal(size=(tk, b, d)).astype(np.float32) for _ in range(2))
    kc[idx:], vc[idx:] = 1e6, -1e6  # never attended
    want, kc_w, vc_w = JDA.decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(idx), n_head=n_head,
        use_pallas=False)
    got, kc_g, vc_g = TDA.decode_attention(
        *(torch.from_numpy(a.copy()) for a in (q, kn, vn, kc, vc)), idx, n_head=n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(kc_g.numpy(), np.asarray(kc_w))
    np.testing.assert_array_equal(vc_g.numpy(), np.asarray(vc_w))


def test_start_windows_on_the_walk_boundaries_match_a_float64_softmax():
    """Each row attends [start_r, idx) and its new row: a dead row (start_r
    == idx) and windows starting at 0, inside a warp load, on a pass's edge
    and one short of idx, at hd 128 — the twin against a float64 numpy
    softmax over each row's own window, 1e-6."""
    b, tk, d, n_head, idx = 6, 80, 256, 2, 65
    start = np.array([idx, 0, 1, 31, 32, idx - 1], dtype=np.int32)
    rng = np.random.default_rng(3)
    q, kn, vn = (rng.normal(size=(b, d)) for _ in range(3))
    kc, vc = (rng.normal(size=(tk, b, d)) for _ in range(2))
    got, _, _ = TDA.decode_attention(
        *(torch.from_numpy(a.astype(np.float32)) for a in (q, kn, vn, kc, vc)), idx,
        n_head=n_head, start=torch.from_numpy(start))
    hd = d // n_head
    want = np.zeros((b, d))
    for r in range(b):
        for h in range(n_head):
            cols = slice(h * hd, (h + 1) * hd)
            keys = np.concatenate([kc[start[r]:idx, r, cols], kn[None, r, cols]])
            vals = np.concatenate([vc[start[r]:idx, r, cols], vn[None, r, cols]])
            s = keys.astype(np.float32).astype(np.float64) @ q[r, cols].astype(np.float32)
            p = np.exp(s / np.sqrt(hd) - (s / np.sqrt(hd)).max())
            want[r, cols] = p @ vals.astype(np.float32) / p.sum()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[0], vn[0].astype(np.float32), atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_append_is_the_row_quantizer(dtype):
    """The twin's int8 append (which the kernel does inside its own launch)
    writes row idx as the JAX package's ``quantize_cache`` quantizes a row
    (the scale over the row's whole D, q = round(v / scale)), an all-zero
    row included (scale 1e-12, zeros), and touches no other row: int8 rows
    and scales equal."""
    from gpt2_image_captioning_tpu_torch.ops import quant as Q

    b, tk, d, idx = 3, 32, 64, 17
    rng = np.random.default_rng(8)
    q, kn, vn = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dtype)
                 for _ in range(3))
    kn[1] = 0.0
    kq, vq, ks, vs = Q.quantize_cache(
        *(torch.from_numpy(rng.normal(size=(tk, b, d)).astype(np.float32)).to(dtype)
          for _ in range(2)))
    before = [t.clone() for t in (kq, vq, ks, vs)]
    TDA.decode_attention(q, kn, vn, kq, vq, idx, n_head=4, k_scale=ks, v_scale=vs)
    want_kq, want_vq, want_ks, want_vs = JDS.quantize_cache(
        *(jnp.asarray(x.float().numpy())[None, None] for x in (kn, vn)))
    np.testing.assert_array_equal(kq[idx].numpy(), np.asarray(want_kq)[0, 0])
    np.testing.assert_array_equal(vq[idx].numpy(), np.asarray(want_vq)[0, 0])
    np.testing.assert_array_equal(ks[idx].numpy(), np.asarray(want_ks)[0, 0])
    np.testing.assert_array_equal(vs[idx].numpy(), np.asarray(want_vs)[0, 0])
    assert float(ks[idx, 1]) == np.float32(1e-12) and not kq[idx, 1].any()
    for t, old in zip((kq, vq, ks, vs), before):
        rows = [i for i in range(tk) if i != idx]
        assert torch.equal(t[rows], old[rows])
