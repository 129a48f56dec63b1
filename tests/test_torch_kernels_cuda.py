"""The port's CUDA kernels K1-K3 against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on a machine with only PyTorch;
tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, |kernel - plain| <= atol + rtol·|plain|: f32 1e-4 (sums in
other orders), bf16 2e-2 (bf16 output rounding; both round the softmax
weights to bf16 before PV, the kernel before normalising, the plain version
after).
"""
import pytest
import torch

from lameness_tpu_torch.ops import attention as at
from lameness_tpu_torch.ops import sam_attention as sa

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rnd(dev, dtype, *shape, seed=0, s=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("seq,hd", [(257, 64), (70, 16), (33, 128)])
def test_attention_kernel(dev, dtype, tol, seq, hd):
    x = _rnd(dev, dtype, 3, seq, 3, 4, hd)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    before = at.KERNEL.launches
    got = at.flash_attention(q, k, v)
    assert at.KERNEL.launches == before + 1
    ref = at.reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("win,hd", [(14, 64), (7, 32)])
def test_window_kernel(dev, dtype, tol, win, hd):
    qkv = _rnd(dev, dtype, 5, win * win, 3, 3, hd)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 2 * win - 1, hd, seed=1, s=0.1),
        _rnd(dev, dtype, 2 * win - 1, hd, seed=2, s=0.1), win)
    before = sa.WINDOW_KERNEL.launches
    got = sa.sam_window_attention_v3(q4, k4, v4, rh4, rw4)
    assert sa.WINDOW_KERNEL.launches == before + 1
    ref = sa.window_attention_reference(q4, k4, v4, rh4, rw4)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("gh,gw", [(64, 64), (24, 40)])
def test_global_kernel(dev, dtype, tol, gh, gw):
    q, k, v = (_rnd(dev, dtype, 3, gh * gw, 64, seed=i) for i in range(3))
    rh, rw = sa.project_rel_tables(
        q, _rnd(dev, dtype, 2 * gh - 1, 64, seed=3, s=0.1),
        _rnd(dev, dtype, 2 * gw - 1, 64, seed=4, s=0.1), gh, gw)
    before = sa.GLOBAL_KERNEL.launches
    got = sa.sam_global_attention(q, k, v, rh, rw)
    assert sa.GLOBAL_KERNEL.launches == before + 1
    ref = sa.sam_attention_reference(q, k, v, rh, rw)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_cuda_wrappers_reject_bad_operands(dev):
    q = torch.zeros(2, 4, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        at.flash_attention(q, q, q)
    q = torch.zeros(2, 4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        at.flash_attention(q, q, q)
    q = torch.zeros(2, 4, 16, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        at.flash_attention(q, q, q)
