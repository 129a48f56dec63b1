"""SAM ViTDet attention with the decomposed rel-pos bias: kernels K2-K9.

Port of ``lameness_tpu/ops/sam_attention.py``, every entry with its JAX
namesake's signature, layout and switch.  The bias of a score is
bias[t, kh·GW + kw] = rh[t, kh] + rw[t, kw], from the q-projected tables of
:func:`project_rel_tables` / :func:`project_rel_tables_hl`.

Windows (pad tokens of edge windows take part unmasked, as in ViTDet):
- head-last (BW, N, nH, hd) -> (BW, N, nH·hd): :func:`sam_window_attention_v3`
  (K2) and :func:`sam_window_attention_v5` (K9);
- head-major (BW, nH, N, hd) -> (BW, nH, N, hd): :func:`sam_window_attention`,
  which sends ``LAMENESS_WIN_KERNEL=v2`` to :func:`sam_window_attention_v2`
  (K8) and anything else to :func:`sam_window_attention_v1` (K7).

Global attention over the whole (GH, GW) grid:
- (BH, N, D): :func:`sam_global_attention`, which sends
  ``LAMENESS_GLB_KERNEL`` unset or ``v4`` to :func:`sam_global_attention_v4`
  (K3), ``v1`` to :func:`sam_global_attention_v1` (K4) and anything else to
  :func:`sam_global_attention_v2` (K5);
- head-last (B, N, nH, hd) -> (B, N, nH·hd): :func:`sam_global_attention_v3`
  (K6).

The switches are read at each call, as the JAX package reads them at each
trace.  The JAX entries of K5, K6, K8 and K9 compute on augmented operands
that they build in HLO: q·scale and the tables rounded to the compute
dtype, exact one-hot selector columns on the k side, so that qa·kaᵀ carries
the bias.  The plain versions of those four run on such operands, built
here as the JAX entries build them (the width zero-padded to a multiple of
8), but their kernels take the arguments of K3 (K5), K2 (K6, K9) and K7
(K8) and build nothing.  K3, K4, K5 and K6 run one device routine
(``csrc/global_attention.cuh``), K2, K7, K8 and K9 another
(``window_entry`` in ``csrc/window_attention.cuh``, which forms the
augmented columns in shared memory), both on q, k, v and the tables as the
qkv Linear and the rel-pos einsum leave them: their entries copy nothing.

On a CPU tensor each entry runs its plain version; on a CUDA tensor it
launches its kernel (``csrc/<entry>.cu``) or raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional

import numpy as np
import torch

from ._cuda import (DTYPE_CODES, CudaKernel, check_chunked_rows,
                    check_head_dim, check_operands, strides_array)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_HEADS_ARGS = [_vp] * 6 + [_ci] * 5 + [_vp, _ci]
_GLOBAL_ARGS = [_vp] * 6 + [_ci] * 4 + [_vp, _ci]
WINDOW_KERNEL = CudaKernel(                                      # K2
    "sam_window_attention_v3", "sam_window_attention",
    "lameness_sam_window_attention", _HEADS_ARGS)
GLOBAL_KERNEL = CudaKernel(                                      # K3
    "sam_global_attention_v4", "sam_global_attention",
    "lameness_sam_global_attention", _GLOBAL_ARGS)
GLOBAL_V1_KERNEL = CudaKernel(                                   # K4
    "sam_global_attention_v1", "sam_global_attention_v1",
    "lameness_sam_global_attention_v1", _GLOBAL_ARGS)
GLOBAL_V2_KERNEL = CudaKernel(                                   # K5
    "sam_global_attention_v2", "sam_global_attention_v2",
    "lameness_sam_global_attention_v2", _GLOBAL_ARGS)
GLOBAL_V3_KERNEL = CudaKernel(                                   # K6
    "sam_global_attention_v3", "sam_global_attention_v3",
    "lameness_sam_global_attention_v3", _HEADS_ARGS)
WINDOW_V1_KERNEL = CudaKernel(                                   # K7
    "sam_window_attention_v1", "sam_window_attention_v1",
    "lameness_sam_window_attention_v1", _HEADS_ARGS)
WINDOW_V2_KERNEL = CudaKernel(                                   # K8
    "sam_window_attention_v2", "sam_window_attention_v2",
    "lameness_sam_window_attention_v2", _HEADS_ARGS)
WINDOW_V5_KERNEL = CudaKernel(                                   # K9
    "sam_window_attention_v5", "sam_window_attention_v5",
    "lameness_sam_window_attention_v5", _HEADS_ARGS)


@functools.lru_cache(maxsize=None)
def _rel_index(g: int, device: torch.device) -> torch.Tensor:
    """The (g, g) table index q - k + g - 1, made once per device (copied
    to the card at each call it would synchronise the stream)."""
    i = np.arange(g)
    return torch.from_numpy((i[:, None] - i[None, :]) + (g - 1)).to(device)


def project_rel_tables(q: torch.Tensor, rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor, g: int,
                       gw: Optional[int] = None):
    """q (BH, GH·GW, D); tables (2GH-1, D) / (2GW-1, D) -> rel_h
    (BH, GH, GW, GH) and rel_w (BH, GH, GW, GW):
    rel_h[b, qh, qw, kh] = Σ_d q[b, qh·GW+qw, d] · Rh[qh-kh+GH-1, d]."""
    gh = g
    gw = gh if gw is None else gw
    rh = rel_pos_h[_rel_index(gh, rel_pos_h.device)]   # (GH, GH, D)
    rw = rel_pos_w[_rel_index(gw, rel_pos_w.device)]   # (GW, GW, D)
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
    rh = rel_pos_h[_rel_index(gh, rel_pos_h.device)]
    rw = rel_pos_w[_rel_index(gw, rel_pos_w.device)]
    rh_tok = rh.repeat_interleave(gw, dim=0).to(q4.dtype)  # (N, GH, D)
    rw_tok = rw.repeat(gh, 1, 1).to(q4.dtype)              # (N, GW, D)
    rh4 = torch.einsum("bthd,tkd->bthk", q4, rh_tok)
    rw4 = torch.einsum("bthd,tkd->bthk", q4, rw_tok)
    return rh4, rw4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
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
    """Plain K3 and K4: materialises the full (BH, N, N) bias."""
    bh, n, d = q.shape
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
            ).reshape(bh, n, n)
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    return _biased_softmax_pv(s, bias, v.float(), q.dtype).to(q.dtype)


def window_attention_hm_reference(q, k, v, rel_h, rel_w) -> torch.Tensor:
    """Plain K7: head-major windows (BW, nH, N, D), each (window, head) a
    grid of win x win tokens for :func:`sam_attention_reference`."""
    bw, nh, n, d = q.shape
    win = rel_h.shape[-1]

    def flat(t):
        return t.reshape(bw * nh, n, t.shape[-1])
    tables = (t.reshape(bw * nh, win, win, win) for t in (rel_h, rel_w))
    out = sam_attention_reference(flat(q), flat(k), flat(v), *tables)
    return out.reshape(bw, nh, n, d)


def augmented_attention_reference(qa, ka, v, rw=None, fold: bool = False
                                  ) -> torch.Tensor:
    """Plain K5, K6, K8, K9 over (..., N, ·) operands:
    softmax(qa·kaᵀ (+ rw[t, j mod GW])) @ v with f32 scores, the weights
    rounded to v's dtype before PV.  They are normalised before PV as the
    TPU kernels of K5, K6 and K8 do, or with ``fold`` after it (K9)."""
    s = qa.float() @ ka.float().transpose(-1, -2)
    if rw is not None:
        reps = s.shape[-1] // rw.shape[-1]
        s = s + rw.float().repeat(*([1] * (rw.dim() - 1)), reps)
    if not fold:
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        return (p @ v.float()).to(v.dtype)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p.to(v.dtype).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# augmented operands
# ---------------------------------------------------------------------------
def _selectors(n: int, g: int, rows: int, mod: bool, like: torch.Tensor
               ) -> torch.Tensor:
    """(N, rows) one-hot in like's dtype: [j, r] = 1 iff j // g == r (the
    spreadᵀ of the kh index), or with ``mod`` iff j % g == r (modᵀ)."""
    j = torch.arange(n, device=like.device)[:, None]
    key = j % g if mod else j // g
    return (key == torch.arange(rows, device=like.device)).to(like.dtype)


def _augment(parts: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate along the last axis, zero-padded to a multiple of 8."""
    pad = -sum(p.shape[-1] for p in parts) % 8
    if pad:
        parts = parts + [parts[0].new_zeros(*parts[0].shape[:-1], pad)]
    return torch.cat(parts, dim=-1)


def global_v2_operands(q, k, rel_h, rel_w):
    """K5's operands, as sam_global_attention_v2 builds them in HLO:
    qa = [q·scale | rel_h] and ka = [k | spreadᵀ] (BH, N, A), and rw
    (BH, N, GW) in q's dtype (the kernel takes one dtype; the projected
    tables are in it already)."""
    bh, n, d = q.shape
    gh, gw = rel_h.shape[1], rel_w.shape[3]
    spread = _selectors(n, gw, gh, False, q).expand(bh, n, gh)
    qa = _augment([q * d ** -0.5, rel_h.reshape(bh, n, gh).to(q.dtype)])
    ka = _augment([k, spread])
    return qa, ka, rel_w.reshape(bh, n, gw).to(q.dtype)


def global_v3_operands(q4, k4, rh4, rw4):
    """The operands of K6's plain version, head-last as the JAX entry
    sam_global_attention_v3 builds them: qa = [q4·scale | rh4], ka =
    [k4 | spreadᵀ] (B, N, nH, A), and rw4 in the compute dtype."""
    b, n, nh, hd = q4.shape
    gh, gw = rh4.shape[-1], rw4.shape[-1]
    spread = _selectors(n, gw, gh, False, q4)[:, None].expand(b, n, nh, gh)
    qa = _augment([q4 * hd ** -0.5, rh4.to(q4.dtype)])
    ka = _augment([k4, spread])
    return qa, ka, rw4.to(q4.dtype)


def _window_selectors(n: int, win: int, like: torch.Tensor) -> torch.Tensor:
    """(N, 2·win): [spreadᵀ | modᵀ] of a win x win window."""
    return torch.cat([_selectors(n, win, win, False, like),
                      _selectors(n, win, win, True, like)], dim=-1)


def window_v2_operands(q, k, rel_h, rel_w):
    """K8's operands, as sam_window_attention_v2 builds them: qa =
    [q·scale | rh | rw], ka = [k | spreadᵀ | modᵀ] (BW, nH, N, A)."""
    bw, nh, n, d = q.shape
    win = rel_h.shape[-1]
    sel = _window_selectors(n, win, q).expand(bw, nh, n, 2 * win)
    qa = _augment([q * d ** -0.5, rel_h.to(q.dtype), rel_w.to(q.dtype)])
    ka = _augment([k, sel])
    return qa, ka


def window_v5_operands(q4, k4, rh4, rw4):
    """K9's operands, head-last as sam_window_attention_v5 builds them:
    qa = [q4·scale | rh4 | rw4], ka = [k4 | spreadᵀ | modᵀ]
    (BW, N, nH, A)."""
    bw, n, nh, hd = q4.shape
    win = rh4.shape[-1]
    sel = _window_selectors(n, win, q4)[:, None].expand(bw, n, nh, 2 * win)
    qa = _augment([q4 * hd ** -0.5, rh4.to(q4.dtype), rw4.to(q4.dtype)])
    ka = _augment([k4, sel])
    return qa, ka


# ---------------------------------------------------------------------------
# C arguments (all but the stream)
# ---------------------------------------------------------------------------
def bias_args(q, k, v, rh, rw, out):
    """Of the entries with per-head strides (K2, K6-K9): (O, H, N, ·)
    views of q, k, v, the tables and the output, with any strides but a
    contiguous last axis; GW is rw's width."""
    o, h, n, d = q.shape
    st = strides_array(*(t.stride()[:3] for t in (q, k, v, rh, rw, out)))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
            rw.data_ptr(), out.data_ptr(), o, h, n, d, rw.shape[-1], st,
            DTYPE_CODES[q.dtype])


def window_args(q4, k4, v4, rh4, rw4, out):
    """Of ``lameness_sam_window_attention`` (K2) and its ``_v5`` twin (K9)
    on head-last operands; ``out`` is (BW, N, nH·hd)."""
    bw, n, nh, hd = q4.shape
    return bias_args(*(t.transpose(1, 2) for t in (q4, k4, v4, rh4, rw4)),
                     out.view(bw, n, nh, hd).transpose(1, 2))


# Of ``lameness_sam_global_attention_v3`` (K6): q4, k4, v4 (B, N, nH, hd),
# rh4 (B, N, nH, GH) and rw4 (B, N, nH, GW) where the qkv Linear and
# project_rel_tables_hl leave them, and out (B, N, nH·hd), all at
# {image, head, token} element strides: K2's arguments.
global_hl_args = window_args


def global_args(q, k, v, rel_h, rel_w, out):
    """Of ``lameness_sam_global_attention`` (K3), its v1 twin (K4) and
    ``lameness_sam_global_attention_v2`` (K5): q, k, v and out (BH, N, ·)
    at {head, 0, token} element strides; the (BH, GH, GW, ·) tables where
    they lie, at {head, grid row, grid column} (what project_rel_tables'
    einsum leaves is no (BH, N, ·) view)."""
    bh, n, d = q.shape
    st = strides_array(*((t.stride(0), 0, t.stride(1)) for t in (q, k, v)),
                       rel_h.stride()[:3], rel_w.stride()[:3],
                       (out.stride(0), 0, out.stride(1)))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), out.data_ptr(), bh, n, d, rel_w.shape[3], st,
            DTYPE_CODES[q.dtype])


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def _check_windows(name, q, k, v, rh, rw) -> None:
    """(O, H, N, hd) q, k, v and (O, H, N, win) tables with N = win²."""
    o, h, n, d = q.shape
    win = rh.shape[-1]
    if (k.shape != q.shape or v.shape != q.shape or n != win * win
            or rh.shape != (o, h, n, win) or rw.shape != rh.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, rh "
                         f"{tuple(rh.shape)}, rw {tuple(rw.shape)}")
    check_operands(name, (q, k, v, rh, rw))
    check_head_dim(name, d)
    check_chunked_rows(name, (q, k, v))


def _head_last_window(name: str, kernel: CudaKernel, q4, k4, v4, rh4, rw4
                      ) -> torch.Tensor:
    """K2 and K9 on the card: head-last q4, k4, v4 and tables read where
    they lie, the tables in q4's dtype; (BW, N, nH·hd) out."""
    rh4, rw4 = rh4.to(q4.dtype), rw4.to(q4.dtype)
    _check_windows(name, *(t.transpose(1, 2) for t in (q4, k4, v4, rh4, rw4)))
    bw, n, nh, hd = q4.shape
    out = torch.empty((bw, n, nh * hd), dtype=q4.dtype, device=q4.device)
    kernel(*window_args(q4, k4, v4, rh4, rw4, out))
    return out


def _head_major_window(name: str, kernel: CudaKernel, q, k, v, rel_h, rel_w
                       ) -> torch.Tensor:
    """K7 and K8 on the card: head-major q, k, v and tables read where they
    lie, the tables in q's dtype; (BW, nH, N, D) out."""
    rel_h, rel_w = rel_h.to(q.dtype), rel_w.to(q.dtype)
    _check_windows(name, q, k, v, rel_h, rel_w)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel(*bias_args(q, k, v, rel_h, rel_w, out))
    return out


def sam_window_attention_v3(q4: torch.Tensor, k4: torch.Tensor,
                            v4: torch.Tensor, rh4: torch.Tensor,
                            rw4: torch.Tensor) -> torch.Tensor:
    """K2: windowed attention over head-last layouts.

    q4/k4/v4: (BW, N, nH, hd) — slices of the qkv projection, read in place
    (innermost axis contiguous); rh4/rw4: (BW, N, nH, win) from
    :func:`project_rel_tables_hl`.  Returns (BW, N, nH·hd)."""
    if q4.device.type == "cpu":
        return window_attention_reference(q4, k4, v4, rh4, rw4)
    return _head_last_window("sam_window_attention_v3", WINDOW_KERNEL, q4, k4,
                             v4, rh4, rw4)


def sam_window_attention_v1(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rel_h: torch.Tensor,
                            rel_w: torch.Tensor) -> torch.Tensor:
    """K7: windowed attention over head-major layouts.

    q, k, v: (BW, nH, N, D), any strides but the last (the head-major view
    of the qkv output is read in place); rel_h, rel_w: (BW, nH, N, win).
    Returns (BW, nH, N, D)."""
    if q.device.type == "cpu":
        return window_attention_hm_reference(q, k, v, rel_h, rel_w)
    return _head_major_window("sam_window_attention_v1", WINDOW_V1_KERNEL, q,
                              k, v, rel_h, rel_w)


def sam_window_attention_v2(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rel_h: torch.Tensor,
                            rel_w: torch.Tensor) -> torch.Tensor:
    """K8: K7's function, signature and layout.  The plain version runs on
    the augmented operands of the JAX entry (:func:`window_v2_operands`);
    the kernel takes K7's arguments (:func:`bias_args`) and builds
    nothing."""
    if q.device.type == "cpu":
        qa, ka = window_v2_operands(q, k, rel_h, rel_w)
        return augmented_attention_reference(qa, ka, v)
    return _head_major_window("sam_window_attention_v2", WINDOW_V2_KERNEL, q,
                              k, v, rel_h, rel_w)


def sam_window_attention_v5(q4: torch.Tensor, k4: torch.Tensor,
                            v4: torch.Tensor, rh4: torch.Tensor,
                            rw4: torch.Tensor) -> torch.Tensor:
    """K9: K2's function, signature and layout.  The plain version runs on
    the head-last augmented operands of the JAX entry
    (:func:`window_v5_operands`), the softmax denominator applied after PV;
    the kernel takes K2's arguments (:func:`window_args`) and builds
    nothing."""
    if q4.device.type == "cpu":
        bw, n, nh, hd = q4.shape
        qa, ka = window_v5_operands(q4, k4, rh4, rw4)
        out = augmented_attention_reference(
            *(t.transpose(1, 2) for t in (qa, ka, v4)), fold=True)
        return out.transpose(1, 2).reshape(bw, n, nh * hd)
    return _head_last_window("sam_window_attention_v5", WINDOW_V5_KERNEL, q4,
                             k4, v4, rh4, rw4)


def sam_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor
                         ) -> torch.Tensor:
    """Head-major windowed attention: (BW, nH, N, D) and (BW, nH, N, win)
    tables -> (BW, nH, N, D).  ``LAMENESS_WIN_KERNEL=v2`` takes K8, any
    other value (default ``v1``) K7, as in the JAX entry."""
    if os.environ.get("LAMENESS_WIN_KERNEL", "v1") == "v2":
        return sam_window_attention_v2(q, k, v, rel_h, rel_w)
    return sam_window_attention_v1(q, k, v, rel_h, rel_w)


def _check_global(name: str, q, k, v, rel_h, rel_w) -> None:
    bh, n, d = q.shape
    gh, gw = rel_h.shape[1], rel_w.shape[3]
    if (k.shape != q.shape or v.shape != q.shape or n != gh * gw
            or rel_h.shape != (bh, gh, gw, gh)
            or rel_w.shape != (bh, gh, gw, gw)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, rel_h "
            f"{tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)}")


def _biased_global(name: str, kernel: CudaKernel, q, k, v, rel_h, rel_w
                   ) -> torch.Tensor:
    """K3, K4 and K5 on the card (K3's and K4's plain version on the CPU):
    the tables in q's dtype, read where they lie."""
    if q.device.type == "cpu":
        return sam_attention_reference(q, k, v, rel_h, rel_w)
    rel_h, rel_w = rel_h.to(q.dtype), rel_w.to(q.dtype)
    _check_global(name, q, k, v, rel_h, rel_w)
    check_operands(name, (q, k, v, rel_h, rel_w))
    check_head_dim(name, q.shape[-1])
    check_chunked_rows(name, (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel(*global_args(q, k, v, rel_h, rel_w, out))
    return out


def sam_global_attention_v4(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rel_h: torch.Tensor,
                            rel_w: torch.Tensor) -> torch.Tensor:
    """K3: biased attention over the whole (GH, GW) token grid.

    q, k, v: (BH, GH·GW, D); rel_h (BH, GH, GW, GH), rel_w (BH, GH, GW, GW)
    from :func:`project_rel_tables`.  Returns (BH, GH·GW, D).  Square grids
    (the 1024² canvas) and rectangular ones take the same path."""
    return _biased_global("sam_global_attention_v4", GLOBAL_KERNEL, q, k, v,
                          rel_h, rel_w)


def sam_global_attention_v1(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rel_h: torch.Tensor,
                            rel_w: torch.Tensor) -> torch.Tensor:
    """K4 (``LAMENESS_GLB_KERNEL=v1``): K3's function and signature."""
    return _biased_global("sam_global_attention_v1", GLOBAL_V1_KERNEL, q, k,
                          v, rel_h, rel_w)


def sam_global_attention_v2(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rel_h: torch.Tensor,
                            rel_w: torch.Tensor) -> torch.Tensor:
    """K5: K3's function and signature.  The plain version runs on the
    augmented operands of the JAX entry (:func:`global_v2_operands`); the
    kernel is K3's (:func:`global_args`) and builds no augmented operand."""
    if q.device.type == "cpu":
        qa, ka, rw = global_v2_operands(q, k, rel_h, rel_w)
        return augmented_attention_reference(qa, ka, v, rw)
    return _biased_global("sam_global_attention_v2", GLOBAL_V2_KERNEL, q, k,
                          v, rel_h, rel_w)


def sam_global_attention_v3(q4: torch.Tensor, k4: torch.Tensor,
                            v4: torch.Tensor, rh4: torch.Tensor,
                            rw4: torch.Tensor) -> torch.Tensor:
    """K6: K3's function over head-last layouts.

    q4/k4/v4: (B, N, nH, hd) slices of the qkv projection; rh4 (B, N, nH,
    GH), rw4 (B, N, nH, GW) from :func:`project_rel_tables_hl`.  Returns
    (B, N, nH·hd).  The plain version runs on the augmented operands of the
    JAX entry (:func:`global_v3_operands`); the kernel reads all five where
    they lie (:func:`global_hl_args`) and builds nothing."""
    b, n, nh, hd = q4.shape
    if q4.device.type == "cpu":
        qa, ka, rw = global_v3_operands(q4, k4, rh4, rw4)
        out = augmented_attention_reference(
            *(t.transpose(1, 2) for t in (qa, ka, v4, rw)))
        return out.transpose(1, 2).reshape(b, n, nh * hd)
    name = "sam_global_attention_v3"
    rh4, rw4 = rh4.to(q4.dtype), rw4.to(q4.dtype)
    gh, gw = rh4.shape[-1], rw4.shape[-1]
    if (k4.shape != q4.shape or v4.shape != q4.shape or n != gh * gw
            or rh4.shape[:3] != (b, n, nh) or rw4.shape[:3] != (b, n, nh)):
        raise ValueError(f"{name}: shapes q4 {tuple(q4.shape)}, rh4 "
                         f"{tuple(rh4.shape)}, rw4 {tuple(rw4.shape)}")
    check_operands(name, (q4, k4, v4, rh4, rw4))
    check_head_dim(name, hd)
    check_chunked_rows(name, (q4, k4, v4))
    out = torch.empty((b, n, nh * hd), dtype=q4.dtype, device=q4.device)
    GLOBAL_V3_KERNEL(*global_hl_args(q4, k4, v4, rh4, rw4, out))
    return out


def sam_global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor
                         ) -> torch.Tensor:
    """Global attention, (BH, N, D) -> (BH, N, D), with the JAX entry's
    switch: ``LAMENESS_GLB_KERNEL`` unset or ``v4`` takes K3, ``v1`` K4,
    any other value K5."""
    glb = os.environ.get("LAMENESS_GLB_KERNEL", "v4")
    if glb == "v4":
        return sam_global_attention_v4(q, k, v, rel_h, rel_w)
    if glb != "v1":
        return sam_global_attention_v2(q, k, v, rel_h, rel_w)
    return sam_global_attention_v1(q, k, v, rel_h, rel_w)
