"""YUV420 (I420) transfer format (port of ``lameness_tpu/video/yuv.py``).

The I420 planes carry 1.5 bytes a pixel where RGB carries 3: the host
converts packed RGB frames to I420, the whole batch crosses to the device
as one flat buffer, and the device rebuilds RGB.  Over a mesh the batch
travels as rows (``pack_i420_rows``): each data shard's clips as one block
of rows to its own device.

Layout: standard I420 in one (..., H*3//2, W) uint8 plane -- Y rows
[0, H), then the U plane (H/2 x W/2) and the V plane as one byte stream
after them (two chroma rows per buffer row; the planes do not align to
buffer rows when H/2 is odd).

Conversion is ITU-R BT.601 limited range.  The port has no OpenCV:
``rgb_to_i420`` is cv2's ``COLOR_RGB2YUV_I420`` fixed-point arithmetic (20
fraction bits; U and V from the top-left pixel of each 2x2 block), equal
to it byte for byte.  ``i420_to_rgb_device`` replicates chroma and rounds
half to even, as the JAX package's XLA program does on the CPU (the
engine's I420 ingest).  The decoder's conversion is another one:
``i420_to_rgb`` is cv2's ``COLOR_YUV2RGB_I420`` (20 fraction bits, nearest
chroma), and ``rgb_to_gray`` cv2's 8-bit ``COLOR_RGB2GRAY`` (15 fraction
bits), each equal to cv2 over every input (tests/test_torch_decode.py).
Both are integer tensor arithmetic on the tensor's device.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

__all__ = ["i420_shape", "rgb_to_i420", "pack_i420_flat", "flat_views",
           "i420_flat_to_rgb_device", "pack_i420_rows",
           "i420_rows_to_rgb_device", "i420_to_rgb_device", "i420_to_rgb",
           "rgb_to_gray"]

# cv2's BT.601 RGB -> YUV coefficients, fixed point with 20 fraction bits
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_Y = (269484, 528482, 102760)
_U = (-155188, -305135, 460324)
_V = (460324, -385875, -74448)
# cv2's BT.601 YUV -> RGB coefficients (ITUR_BT_601_*), 20 fraction bits
_CY, _CUB, _CUG, _CVG, _CVR = 1220542, 2116026, -409993, -852492, 1673527
# cv2's 8-bit RGB -> gray coefficients, 15 fraction bits
_GRAY = (9798, 19235, 3735)


def i420_shape(h: int, w: int) -> tuple:
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dims, got {h}x{w}")
    return (h * 3 // 2, w)


def _plane(r, g, b, coef, offset: int, out: torch.Tensor) -> None:
    acc = r * coef[0]
    acc.add_(g, alpha=coef[1]).add_(b, alpha=coef[2])
    acc.add_(_HALF + (offset << _SHIFT)).bitwise_right_shift_(_SHIFT)
    out.copy_(acc.reshape(out.shape))


def rgb_to_i420(frames):
    """(..., H, W, 3) uint8 RGB -> (..., H*3//2, W) uint8 I420.  A numpy
    array is converted on the host, frame by frame in int32; a tensor as
    a whole on its device (a tensor back)."""
    if isinstance(frames, torch.Tensor):
        h, w = frames.shape[-3], frames.shape[-2]
        lead = tuple(frames.shape[:-3])
        src = frames.reshape((-1, h, w, 3))
        out = torch.empty((src.shape[0],) + i420_shape(h, w),
                          dtype=torch.uint8, device=frames.device)
        _i420_planes(src, out.view(src.shape[0], -1), h, w)
        return out.reshape(lead + i420_shape(h, w))
    frames = np.asarray(frames)
    h, w = frames.shape[-3], frames.shape[-2]
    lead = frames.shape[:-3]
    src = torch.from_numpy(np.ascontiguousarray(frames).reshape(-1, h, w, 3))
    out = np.empty((src.shape[0],) + i420_shape(h, w), np.uint8)
    dst = torch.from_numpy(out).view(src.shape[0], -1)
    for i in range(src.shape[0]):
        _i420_planes(src[i:i + 1], dst[i:i + 1], h, w)
    return out.reshape(lead + i420_shape(h, w))


def _i420_planes(src: torch.Tensor, dst: torch.Tensor, h: int, w: int):
    """(N, H, W, 3) uint8 RGB -> the rows of ``dst`` (N, H*W*3//2)."""
    n, q = h * w, h * w // 4
    r, g, b = src.to(torch.int32).unbind(-1)
    _plane(r, g, b, _Y, 16, dst[:, :n])
    r2, g2, b2 = (c[:, ::2, ::2] for c in (r, g, b))
    _plane(r2, g2, b2, _U, 128, dst[:, n:n + q])
    _plane(r2, g2, b2, _V, 128, dst[:, n + q:])


def i420_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(..., H*3//2, W) uint8 I420 -> (..., H, W, 3) uint8 RGB on the
    tensor's device, as ``cv2.cvtColor(.., COLOR_YUV2RGB_I420)``: Y below
    16 taken as 16, each chroma sample over its 2x2 block, every channel
    (C_Y (Y - 16) + C (chroma - 128) + 2^19) >> 20, saturated."""
    h15, w = yuv.shape[-2], yuv.shape[-1]
    h = h15 * 2 // 3
    lead = tuple(yuv.shape[:-2])
    y = (yuv[..., :h, :].to(torch.int32) - 16).clamp_(min=0).mul_(_CY)
    chroma = yuv[..., h:, :].reshape(lead + (h * w // 2,))
    q = h * w // 4
    u = chroma[..., :q].to(torch.int32) - 128
    v = chroma[..., q:].to(torch.int32) - 128

    def up(c):
        c = c.add_(1 << (_SHIFT - 1)).reshape(lead + (h // 2, 1, w // 2, 1))
        return c.expand(lead + (h // 2, 2, w // 2, 2)).reshape(lead + (h, w))
    out = []
    for c in (v * _CVR, v * _CVG + u * _CUG, u * _CUB):
        out.append(up(c).add_(y).bitwise_right_shift_(_SHIFT)
                   .clamp_(0, 255).to(torch.uint8))
    return torch.stack(out, dim=-1)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 gray on the tensor's device, as
    ``cv2.cvtColor(.., COLOR_RGB2GRAY)``: (9798 R + 19235 G + 3735 B +
    2^14) >> 15."""
    r, g, b = rgb.to(torch.int32).unbind(-1)
    acc = r * _GRAY[0]
    acc.add_(g * _GRAY[1]).add_(b * _GRAY[2]).add_(1 << 14)
    return acc.bitwise_right_shift_(15).to(torch.uint8)


def pack_i420_flat(tree: Union[np.ndarray, Dict[str, np.ndarray]]):
    """Host-side: an I420 array (or a dict of them, e.g. split ingest's
    hi/lo) -> one contiguous 1-D uint8 buffer and its layout, a tuple of
    (key, shape) in sorted-key order.  A bare array gets the key ""."""
    if not isinstance(tree, dict):
        arr = np.ascontiguousarray(tree)
        return arr.reshape(-1), (("", arr.shape),)
    keys = sorted(tree)
    layout = tuple((k, tuple(tree[k].shape)) for k in keys)
    flat = np.concatenate(
        [np.ascontiguousarray(tree[k]).reshape(-1) for k in keys])
    return flat, layout


def flat_views(flat, layout: Tuple):
    """The arrays of a flat buffer (numpy or torch) laid out as ``layout``
    ((key, shape), ...), as views: a dict by key, or the bare array for
    the "" layout."""
    out = {}
    off = 0
    for key, shape in layout:
        n = int(np.prod(shape))
        out[key] = flat[off:off + n].reshape(shape)
        off += n
    if len(layout) == 1 and layout[0][0] == "":
        return out[""]
    return out


def i420_flat_to_rgb_device(flat: torch.Tensor, layout: Tuple):
    """The flat buffer of :func:`pack_i420_flat` (on any device) -> the RGB
    frame tree: a dict by key, or the bare array for the "" layout."""
    tree = flat_views(flat, layout)
    if isinstance(tree, dict):
        return {k: i420_to_rgb_device(v) for k, v in tree.items()}
    return i420_to_rgb_device(tree)


def pack_i420_rows(tree: Union[np.ndarray, Dict[str, np.ndarray]]):
    """Host-side, the batch-major sibling of :func:`pack_i420_flat` for
    sharded ingest: an I420 array (or dict) with (B, T, H*3//2, W) leaves ->
    one (B, row_bytes) uint8 buffer whose row b holds every byte of clip b
    (each leaf's, in sorted-key order), and its layout ((key, shape), ...).
    A data shard's clips are then one contiguous block of rows, copied to
    its device alone."""
    if not isinstance(tree, dict):
        tree = {"": np.asarray(tree)}
    keys = sorted(tree)
    b = next(iter(tree.values())).shape[0]
    layout = tuple((k, tuple(tree[k].shape)) for k in keys)
    rows = np.concatenate(
        [np.ascontiguousarray(tree[k]).reshape(b, -1) for k in keys], axis=1)
    return rows, layout


def i420_rows_to_rgb_device(rows: torch.Tensor, layout: Tuple):
    """The inverse of :func:`pack_i420_rows` on any block of its rows (on
    any device): column slices per leaf, each rebuilt by
    :func:`i420_to_rgb_device`; the batch is ``rows.shape[0]``."""
    out = {}
    off = 0
    for key, shape in layout:
        n = int(np.prod(shape[1:]))
        out[key] = i420_to_rgb_device(
            rows[:, off:off + n].reshape((rows.shape[0],) + tuple(shape[1:])))
        off += n
    if len(layout) == 1 and layout[0][0] == "":
        return out[""]
    return out


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·x + c rounded once to float32, as a fused multiply-add would: the
    product of two float32 values is exact in float64."""
    return (x.double() * a + c.double()).float()


_K = (1.164383, 1.596027, 0.391762, 0.812968, 2.017232)
_KY, _KR, _KGU, _KGV, _KB = (float(np.float32(k)) for k in _K)


def i420_to_rgb_device(yuv: torch.Tensor) -> torch.Tensor:
    """(..., H*3//2, W) uint8 I420 -> (..., H, W, 3) uint8 RGB on the
    tensor's device: BT.601 limited range in float32, chroma replicated
    over each 2x2 block, rounded half to even and clamped to [0, 255].

    XLA's CPU backend contracts G's two products into fused multiply-adds,
    and over every (Y, U, V) triple that changes 44 of G's 16.8 million
    values against plain float32 (R and B round the same either way); G
    takes them so here, and the result equals the JAX program's bit for
    bit (tests/test_torch_ingest.py)."""
    h15, w = yuv.shape[-2], yuv.shape[-1]
    h = h15 * 2 // 3
    lead = tuple(yuv.shape[:-2])
    y16 = yuv[..., :h, :].float() - 16.0
    chroma = yuv[..., h:, :].reshape(lead + (h * w // 2,))

    def up(plane):
        p = plane.reshape(lead + (h // 2, 1, w // 2, 1))
        p = p.expand(lead + (h // 2, 2, w // 2, 2)).reshape(lead + (h, w))
        return p.float() - 128.0
    d, e = up(chroma[..., :h * w // 4]), up(chroma[..., h * w // 4:])
    c = _KY * y16
    g = _fma(-_KGV, e, _fma(_KY, y16, -(_KGU * d)))
    rgb = torch.stack([c + _KR * e, g, c + _KB * d], dim=-1)
    return rgb.round().clamp(0.0, 255.0).to(torch.uint8)
