"""K2 / K3 (SAM windowed and global attention): the port against the JAX
Pallas kernels run in interpret mode.

On the CPU the port's wrappers run their plain versions (the bias
materialised); ``sam_window_attention_v3`` and ``sam_global_attention``
(which dispatches to v4) run through Pallas interpret.  Tolerance 1e-5:
the Pallas kernels add the bias through augmented operands, in another
order than the plain sum.  The CUDA kernels are checked against the plain
versions by tests/test_torch_kernels_cuda.py (card only) and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lameness_tpu.ops import sam_attention as jsa
from lameness_tpu_torch.ops import sam_attention as tsa


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bw,win,nh,hd", [(2, 14, 2, 16), (1, 14, 1, 64),
                                          (3, 4, 2, 32)])
def test_window_attention_matches_pallas_interpret(bw, win, nh, hd):
    rng = np.random.default_rng(0)
    n = win * win
    q4, k4, v4 = (_randn(rng, bw, n, nh, hd) for _ in range(3))
    rel_h, rel_w = (_randn(rng, 2 * win - 1, hd, scale=0.2)
                    for _ in range(2))
    jrh, jrw = jsa.project_rel_tables_hl(jnp.asarray(q4), jnp.asarray(rel_h),
                                         jnp.asarray(rel_w), win)
    want = jsa.sam_window_attention_v3(
        jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4), jrh, jrw,
        interpret=True)
    tq = torch.from_numpy(q4)
    trh, trw = tsa.project_rel_tables_hl(tq, torch.from_numpy(rel_h),
                                         torch.from_numpy(rel_w), win)
    np.testing.assert_allclose(trh.numpy(), np.asarray(jrh), atol=1e-5)
    np.testing.assert_allclose(trw.numpy(), np.asarray(jrw), atol=1e-5)
    got = tsa.sam_window_attention_v3(tq, torch.from_numpy(k4),
                                      torch.from_numpy(v4), trh, trw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_window_pad_tokens_stay_unmasked():
    """Pad tokens of an edge window (zero features before the qkv
    projection, so they carry its bias) take part in the attention
    unmasked, as in the reference ViTDet: K2 must not mask them."""
    from lameness_tpu_torch.ops.attention import reference_attention
    rng = np.random.default_rng(3)
    win, hd = 4, 16
    n = win * win
    q4, k4, v4 = (torch.from_numpy(_randn(rng, 1, n, 1, hd))
                  for _ in range(3))
    k4[:, 8:] = 0.5                      # the two bottom pad rows
    v4[:, 8:] = -0.25
    zero = torch.zeros(1, n, 1, win)
    got = tsa.sam_window_attention_v3(q4, k4, v4, zero, zero)[0]
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q4, k4, v4))
    pad_masked = torch.zeros(1, 1, n, n)
    pad_masked[..., 8:] = float("-inf")
    unmasked = reference_attention(q, k, v)[0, 0]
    masked = reference_attention(q, k, v, bias=pad_masked)[0, 0]
    torch.testing.assert_close(got, unmasked, atol=1e-6, rtol=0)
    assert (got - masked).abs().max() > 1e-2


@pytest.mark.parametrize("bh,gh,gw,d", [(3, 8, 8, 16), (2, 6, 10, 32)])
def test_global_attention_matches_pallas_interpret(bh, gh, gw, d):
    rng = np.random.default_rng(1)
    n = gh * gw
    q, k, v = (_randn(rng, bh, n, d) for _ in range(3))
    rel_h = _randn(rng, 2 * gh - 1, d, scale=0.2)
    rel_w = _randn(rng, 2 * gw - 1, d, scale=0.2)
    jrh, jrw = jsa.project_rel_tables(jnp.asarray(q), jnp.asarray(rel_h),
                                      jnp.asarray(rel_w), gh, gw)
    want = jsa.sam_global_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jrh, jrw, interpret=True)
    tq = torch.from_numpy(q)
    trh, trw = tsa.project_rel_tables(tq, torch.from_numpy(rel_h),
                                      torch.from_numpy(rel_w), gh, gw)
    np.testing.assert_allclose(trh.numpy(), np.asarray(jrh), atol=1e-5)
    np.testing.assert_allclose(trw.numpy(), np.asarray(jrw), atol=1e-5)
    got = tsa.sam_global_attention(tq, torch.from_numpy(k),
                                   torch.from_numpy(v), trh, trw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ref = jsa.sam_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jrh, jrw)
    np.testing.assert_allclose(
        tsa.sam_attention_reference(tq, torch.from_numpy(k),
                                    torch.from_numpy(v), trh, trw).numpy(),
        np.asarray(ref), atol=1e-5)
