"""Attention for the ViT encoders: kernel K1 and its plain version.

Port of ``lameness_tpu/ops/attention.py``.  ``flash_attention`` is
softmax(q·kᵀ·scale)·v over (B, H, S, D) with f32 scores and accumulation and
the output in q's dtype.  On a CUDA tensor it launches the hand-written
kernel ``csrc/attention.cu`` (which masks keys past S itself: no padding);
on a CPU tensor it runs :func:`reference_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda import (DTYPE_CODES, CudaKernel, check_chunked_rows,
                    check_head_dim, check_operands, strides_array)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "attention", "attention", "lameness_attention",
    [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _vp, ctypes.c_float, _ci])


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention over (B, H, S, D), f32 accumulation; the
    weights are rounded to q's dtype before PV, as in the JAX reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_args(q, k, v, out, scale: float):
    """C arguments of ``lameness_attention`` (all but the stream)."""
    b, h, s, d = q.shape
    st = strides_array(*(t.stride()[:3] for t in (q, k, v, out)))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, s, d, st, float(scale), DTYPE_CODES[q.dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over (B, H, S, D) views whose last axis is
    contiguous.  CPU tensors take :func:`reference_attention`; CUDA tensors
    launch kernel K1 or raise.  The CUDA result is a (B, H, S, D) view of a
    (B, S, H, D) buffer, so ``out.transpose(1, 2).reshape(B, S, H·D)`` is
    free."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale=scale)
    check_operands("flash_attention", (q, k, v))
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    check_head_dim("flash_attention", d)
    check_chunked_rows("flash_attention", (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    KERNEL(*attention_args(q, k, v, out, scale))
    return out
