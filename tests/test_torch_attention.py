"""K1 (DINO attention): the port against the JAX Pallas kernel.

On the CPU ``lameness_tpu_torch.ops.attention.flash_attention`` runs its
plain version; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_ops.py does.  The CUDA kernel itself is checked against the
plain version by tests/test_torch_kernels_cuda.py (on the card only) and
by chip_smoke.py.  Tolerance 1e-5: both sum 257 f32 products in other orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lameness_tpu.ops import attention as jax_attention
from lameness_tpu_torch.ops import attention as torch_attention


@pytest.mark.parametrize("shape", [(2, 3, 257, 64), (1, 2, 70, 32)])
def test_flash_attention_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = jax_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True,
        interpret=True)
    got = torch_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_head_last_views_give_the_same_result():
    """DINO hands the kernel (B, H, S, D) views of (B, S, H, D) tensors."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 257, 3, 4, 16)
                                             ).astype(np.float32))
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    got = torch_attention.flash_attention(q, k, v)
    ref = torch_attention.reference_attention(
        q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_kernel_argument_checks():
    """The CUDA wrappers refuse what the kernels do not take."""
    from lameness_tpu_torch.ops._cuda import check_head_dim, check_operands
    with pytest.raises(ValueError, match="CUDA"):
        check_operands("flash_attention", (torch.zeros(1, 1, 8, 64),))
    with pytest.raises(ValueError, match="head dim"):
        check_head_dim("flash_attention", 48)
    check_head_dim("flash_attention", 16)


def test_bf16_rows_must_allow_16_byte_copies():
    """The bf16 kernel copies q/k/v rows in 16-byte chunks: a view whose
    address or outer strides break that is refused; the head-last views of
    a fused qkv output pass."""
    from lameness_tpu_torch.ops._cuda import check_chunked_rows
    qkv = torch.zeros(2, 196, 3, 4, 64, dtype=torch.bfloat16)
    check_chunked_rows("sam_window_attention_v3", qkv.unbind(2))
    odd = torch.zeros(2, 4, 16, 65, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        check_chunked_rows("flash_attention", (odd,))
    check_chunked_rows("flash_attention", (odd.float(),))   # f32: any rows
