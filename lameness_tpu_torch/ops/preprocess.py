"""On-device letterbox / pad / crop / normalize (port of
``ops/preprocess.py``).

Frames are channels-last (N, H, W, 3), as in the JAX package.  Every
linear or bicubic resize passes ``antialias=True``: ``jax.image.resize``
antialiases on downscale, and with ``antialias=True`` torch also switches
bicubic to the a=-0.5 cubic JAX uses and renormalises edge taps the way
JAX does (without it the two differ by up to 156 on 0-255 data).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.device import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(frames: torch.Tensor) -> torch.Tensor:
    if frames.dtype == torch.uint8:
        return frames.float() / 255.0
    return frames.float()


def resize_nhwc(x: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear") -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C), jax.image.resize semantics
    ("linear"/"bicubic", half-pixel centres, antialiased downscale)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode,
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def normalize(frames: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    m = constant(mean, frames.dtype, frames.device)
    s = constant(std, frames.dtype, frames.device)
    return (frames - m) / s


def letterbox(frames: torch.Tensor, out_size: int = 640,
              pad_value: float = 114.0 / 255.0):
    """Aspect-preserving resize + centred pad to (out_size, out_size) (the
    YOLO convention) for a batch of same-size frames (N, H, W, C).
    Returns (canvases (N, S, S, C) f32, ratio (N,), pad (N, 2) = (x, y))."""
    frames = to_float(frames)
    n, h, w, c = frames.shape
    r = min(out_size / h, out_size / w)
    new_h, new_w = int(round(h * r)), int(round(w * r))
    resized = resize_nhwc(frames, (new_h, new_w))
    pad_y = (out_size - new_h) // 2
    pad_x = (out_size - new_w) // 2
    canvas = torch.full((n, out_size, out_size, c), pad_value,
                        dtype=frames.dtype, device=frames.device)
    canvas[:, pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
    ratio = torch.full((n,), r, dtype=torch.float32, device=frames.device)
    pad = constant([pad_x, pad_y], torch.float32, frames.device).expand(n, 2)
    return canvas, ratio, pad


def unletterbox_boxes(boxes_xyxy: torch.Tensor, ratio: torch.Tensor,
                      pad_xy: torch.Tensor) -> torch.Tensor:
    """boxes (N, K, 4) in canvas pixels -> source pixels."""
    shift = torch.cat([pad_xy, pad_xy], dim=-1)[:, None, :]
    return (boxes_xyxy - shift) / ratio[:, None, None]


def pad_to_rect(frames: torch.Tensor, out_hw: Tuple[int, int],
                long_side: int, pad_value: float = 0.0):
    """Scale the longest side to ``long_side`` and pad bottom/right into an
    (out_h, out_w) canvas (segment-anything convention).  Returns
    (canvases (N, out_h, out_w, C) f32, ratio)."""
    frames = to_float(frames)
    n, h, w, c = frames.shape
    r = long_side / max(h, w)
    new_h, new_w = int(round(h * r)), int(round(w * r))
    resized = resize_nhwc(frames, (new_h, new_w))
    canvas = torch.full((n, out_hw[0], out_hw[1], c), pad_value,
                        dtype=frames.dtype, device=frames.device)
    canvas[:, :new_h, :new_w] = resized
    return canvas, r


def pad_to_square(frames: torch.Tensor, out_size: int,
                  pad_value: float = 0.0):
    """SAM-style preprocessing: scale the longest side to ``out_size`` and
    pad bottom/right (segment-anything convention), for a batch of frames
    (N, H, W, C) as ``pad_to_rect``.  Returns (canvases, ratio)."""
    return pad_to_rect(frames, (out_size, out_size), out_size, pad_value)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x).clamp(min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_RESIZE_KERNELS = {"linear": _triangle, "bilinear": _triangle,
                   "triangle": _triangle, "cubic": _keys_cubic,
                   "bicubic": _keys_cubic}


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor, kernel) -> torch.Tensor:
    """``jax.image.scale_and_translate``'s antialiased weights along one
    axis, for a batch of (scale, translation) (N,) -> (N, in, out): the
    kernel widened by 1/scale when it shrinks, each output's taps
    normalised to sum 1, outputs whose sample falls outside the input
    zero."""
    inv = 1.0 / scale
    kscale = inv.clamp(min=1.0)
    dev, dt = scale.device, scale.dtype
    sample = ((torch.arange(out_size, dtype=dt, device=dev)[None] + 0.5)
              * inv[:, None] - translation[:, None] * inv[:, None] - 0.5)
    x = (sample[:, None, :] - torch.arange(in_size, dtype=dt, device=dev
                                           )[None, :, None]).abs() \
        / kscale[:, None, None]
    w = kernel(x)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def crop_resize(frame: torch.Tensor, box_xyxy: torch.Tensor,
                out_hw: Tuple[int, int], method: str = "linear"
                ) -> torch.Tensor:
    """Crop ``box_xyxy`` out of ``frame`` and resize to ``out_hw`` in one
    op (``jax.image.scale_and_translate``: the box a tensor, antialiased
    when it shrinks).  frame (H, W, C) with box (4,), or a batch (N, H, W,
    C) with boxes (N, 4); uint8 is scaled to [0, 1].  ``method``: linear
    or cubic (Keys, a = -0.5)."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"crop_resize: method {method!r} not supported "
                         f"({sorted(_RESIZE_KERNELS)})")
    if frame.dim() == 3:
        return crop_resize(frame[None], box_xyxy[None], out_hw, method)[0]
    frames = to_float(frame)
    out_h, out_w = out_hw
    box = box_xyxy.to(frames.dtype)
    x1, y1, x2, y2 = box.unbind(-1)
    bw = (x2 - x1).clamp(min=1e-3)
    bh = (y2 - y1).clamp(min=1e-3)
    kernel = _RESIZE_KERNELS[method]
    wy = _weight_mat(frames.shape[1], out_h, out_h / bh, -y1 * out_h / bh,
                     kernel)
    wx = _weight_mat(frames.shape[2], out_w, out_w / bw, -x1 * out_w / bw,
                     kernel)
    return torch.einsum("nhwc,nhy,nwx->nyxc", frames, wy, wx)


def crop_resize_normalize(frame: torch.Tensor, box_xyxy: torch.Tensor,
                          out_hw: Tuple[int, int],
                          mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The fused view: crop -> bilinear resize -> normalize -> cast."""
    return normalize(crop_resize(frame, box_xyxy, out_hw), mean, std
                     ).to(dtype)


def clip_views(frames: torch.Tensor, primary_box=None, yolo_size: int = 640,
               dino_size: int = 224, dtype: torch.dtype = torch.float32):
    """A clip's per-model views: frames (T, H, W, 3) uint8 and the primary
    boxes (T, 4) xyxy (None: the full frame) -> (YOLO's letterboxed frames
    (T, S, S, 3), DINO's normalised crops of the boxes (T, d, d, 3)), both
    in ``dtype``."""
    t, h, w = frames.shape[:3]
    if primary_box is None:
        primary_box = constant([0.0, 0.0, float(w), float(h)],
                               torch.float32, frames.device).expand(t, 4)
    yolo_view = letterbox(frames, yolo_size)[0]
    dino_view = crop_resize_normalize(frames, primary_box,
                                      (dino_size, dino_size), dtype=dtype)
    return yolo_view.to(dtype), dino_view
