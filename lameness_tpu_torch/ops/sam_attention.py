"""SAM ViTDet attention with the decomposed rel-pos bias: kernels K2, K3.

Port of ``lameness_tpu/ops/sam_attention.py`` (its default paths).  The
bias of a score is bias[t, kh·GW + kw] = rh[t, kh] + rw[t, kw], from the
q-projected tables of :func:`project_rel_tables` /
:func:`project_rel_tables_hl`.

- :func:`sam_window_attention_v3` (K2, ``csrc/sam_window_attention.cu``):
  head-last (BW, N, nH, hd) windows, pad tokens unmasked.
- :func:`sam_global_attention` (K3, ``csrc/sam_global_attention.cu``):
  (BH, N, D) over the whole grid, the (N, N) bias never materialised.

On a CPU tensor each runs its plain version (:func:`window_attention_reference`,
:func:`sam_attention_reference`); on a CUDA tensor it launches its kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ._cuda import (DTYPE_CODES, CudaKernel, check_chunked_rows,
                    check_head_dim, check_operands, strides_array)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
WINDOW_KERNEL = CudaKernel(
    "sam_window_attention", "sam_window_attention",
    "lameness_sam_window_attention",
    [_vp] * 6 + [_ci] * 5 + [_vp, _ci])
GLOBAL_KERNEL = CudaKernel(
    "sam_global_attention", "sam_global_attention",
    "lameness_sam_global_attention",
    [_vp] * 6 + [_ci] * 4 + [_vp, _ci])


def _rel_index(g: int) -> torch.Tensor:
    i = np.arange(g)
    return torch.from_numpy((i[:, None] - i[None, :]) + (g - 1))


def project_rel_tables(q: torch.Tensor, rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor, g: int,
                       gw: Optional[int] = None):
    """q (BH, GH·GW, D); tables (2GH-1, D) / (2GW-1, D) -> rel_h
    (BH, GH, GW, GH) and rel_w (BH, GH, GW, GW):
    rel_h[b, qh, qw, kh] = Σ_d q[b, qh·GW+qw, d] · Rh[qh-kh+GH-1, d]."""
    gh = g
    gw = gh if gw is None else gw
    rh = rel_pos_h[_rel_index(gh).to(rel_pos_h.device)]   # (GH, GH, D)
    rw = rel_pos_w[_rel_index(gw).to(rel_pos_w.device)]   # (GW, GW, D)
    qg = q.reshape(q.shape[0], gh, gw, -1)
    rel_h = torch.einsum("bhwd,hkd->bhwk", qg, rh.to(q.dtype))
    rel_w = torch.einsum("bhwd,wkd->bhwk", qg, rw.to(q.dtype))
    return rel_h, rel_w


def project_rel_tables_hl(q4: torch.Tensor, rel_pos_h: torch.Tensor,
                          rel_pos_w: torch.Tensor, gh: int,
                          gw: Optional[int] = None):
    """Head-last projection: q4 (BW, N, nH, hd) -> rh4 (BW, N, nH, GH),
    rw4 (BW, N, nH, GW), token t = qh·GW + qw."""
    gw = gh if gw is None else gw
    rh = rel_pos_h[_rel_index(gh).to(rel_pos_h.device)]
    rw = rel_pos_w[_rel_index(gw).to(rel_pos_w.device)]
    rh_tok = rh.repeat_interleave(gw, dim=0).to(q4.dtype)  # (N, GH, D)
    rw_tok = rw.repeat(gh, 1, 1).to(q4.dtype)              # (N, GW, D)
    rh4 = torch.einsum("bthd,tkd->bthk", q4, rh_tok)
    rw4 = torch.einsum("bthd,tkd->bthk", q4, rw_tok)
    return rh4, rw4


def _biased_softmax_pv(s: torch.Tensor, bias: torch.Tensor, v: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    p = torch.softmax(s + bias, dim=-1).to(dtype).float()
    return p @ v


def window_attention_reference(q4, k4, v4, rh4, rw4) -> torch.Tensor:
    """Plain K2: per window and head, the (N, N) bias materialised."""
    bw, n, nh, hd = q4.shape
    win = rh4.shape[-1]
    q, k, v = (t.permute(0, 2, 1, 3).float() for t in (q4, k4, v4))
    rh = rh4.permute(0, 2, 1, 3).float()
    rw = rw4.permute(0, 2, 1, 3).float()
    bias = (rh[..., :, None] + rw[..., None, :]).reshape(bw, nh, n, win * win)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    out = _biased_softmax_pv(s, bias, v, q4.dtype)         # (BW, nH, N, hd)
    return out.permute(0, 2, 1, 3).reshape(bw, n, nh * hd).to(q4.dtype)


def sam_attention_reference(q, k, v, rel_h, rel_w) -> torch.Tensor:
    """Plain K3: materialises the full (BH, N, N) bias."""
    bh, n, d = q.shape
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
            ).reshape(bh, n, n)
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    return _biased_softmax_pv(s, bias, v.float(), q.dtype).to(q.dtype)


def window_args(q4, k4, v4, rh4, rw4, out):
    """C arguments of ``lameness_sam_window_attention`` (but the stream);
    ``out`` is (BW, N, nH·hd)."""
    bw, n, nh, hd = q4.shape
    win = rh4.shape[-1]
    hl = [(t.stride(0), t.stride(2), t.stride(1))
          for t in (q4, k4, v4, rh4, rw4)]
    o_strides = (out.stride(0), hd, out.stride(1))
    st = strides_array(*hl, o_strides)
    return (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), rh4.data_ptr(),
            rw4.data_ptr(), out.data_ptr(), bw, nh, n, hd, win, st,
            DTYPE_CODES[q4.dtype])


def sam_window_attention_v3(q4: torch.Tensor, k4: torch.Tensor,
                            v4: torch.Tensor, rh4: torch.Tensor,
                            rw4: torch.Tensor) -> torch.Tensor:
    """Windowed attention over head-last layouts.

    q4/k4/v4: (BW, N, nH, hd) — slices of the qkv projection, read in place
    (innermost axis contiguous); rh4/rw4: (BW, N, nH, win) from
    :func:`project_rel_tables_hl`.  Returns (BW, N, nH·hd).  Pad tokens of
    edge windows attend and are attended to, unmasked (reference ViTDet)."""
    if q4.device.type == "cpu":
        return window_attention_reference(q4, k4, v4, rh4, rw4)
    rh4, rw4 = rh4.to(q4.dtype), rw4.to(q4.dtype)
    check_operands("sam_window_attention_v3", (q4, k4, v4, rh4, rw4))
    bw, n, nh, hd = q4.shape
    win = rh4.shape[-1]
    if (k4.shape != q4.shape or v4.shape != q4.shape or n != win * win
            or rh4.shape != (bw, n, nh, win) or rw4.shape != rh4.shape):
        raise ValueError(
            f"sam_window_attention_v3: shapes q {tuple(q4.shape)}, "
            f"rh {tuple(rh4.shape)}, rw {tuple(rw4.shape)}")
    check_head_dim("sam_window_attention_v3", hd)
    check_chunked_rows("sam_window_attention_v3", (q4, k4, v4))
    out = torch.empty((bw, n, nh * hd), dtype=q4.dtype, device=q4.device)
    WINDOW_KERNEL(*window_args(q4, k4, v4, rh4, rw4, out))
    return out


def global_args(q, k, v, rel_h, rel_w, out):
    """C arguments of ``lameness_sam_global_attention`` (but the stream)."""
    bh, n, d = q.shape
    gh, gw = rel_h.shape[1], rel_w.shape[3]
    rh = rel_h.reshape(bh, n, gh)
    rw = rel_w.reshape(bh, n, gw)
    st = strides_array(*((t.stride(0), 0, t.stride(1))
                         for t in (q, k, v, rh, rw, out)))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
            rw.data_ptr(), out.data_ptr(), bh, n, d, gw, st,
            DTYPE_CODES[q.dtype])


def sam_global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor
                         ) -> torch.Tensor:
    """Biased attention over the whole (GH, GW) token grid.

    q, k, v: (BH, GH·GW, D); rel_h (BH, GH, GW, GH), rel_w (BH, GH, GW, GW)
    from :func:`project_rel_tables`.  Returns (BH, GH·GW, D).  Square grids
    (the 1024² canvas) and rectangular ones take the same path."""
    if q.device.type == "cpu":
        return sam_attention_reference(q, k, v, rel_h, rel_w)
    rel_h, rel_w = rel_h.to(q.dtype), rel_w.to(q.dtype)
    bh, n, d = q.shape
    gh, gw = rel_h.shape[1], rel_w.shape[3]
    if (k.shape != q.shape or v.shape != q.shape or n != gh * gw
            or rel_h.shape != (bh, gh, gw, gh)
            or rel_w.shape != (bh, gh, gw, gw)):
        raise ValueError(
            f"sam_global_attention: shapes q {tuple(q.shape)}, rel_h "
            f"{tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)}")
    rel_h, rel_w = rel_h.contiguous(), rel_w.contiguous()
    check_operands("sam_global_attention", (q, k, v, rel_h, rel_w))
    check_head_dim("sam_global_attention", d)
    check_chunked_rows("sam_global_attention", (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    GLOBAL_KERNEL(*global_args(q, k, v, rel_h, rel_w, out))
    return out
