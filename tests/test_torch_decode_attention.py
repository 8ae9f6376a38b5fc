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
