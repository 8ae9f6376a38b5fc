"""The port's decode attention (plain twin) against the JAX package's kernel
in interpret mode and its XLA path, at chunk boundaries and extremes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.ops import decode_attention as JDA
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
