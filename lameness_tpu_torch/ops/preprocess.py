"""On-device letterbox / pad / normalize (port of ``ops/preprocess.py``).

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
