"""YOLOv8 detector (port of ``lameness_tpu/models/yolo.py``, detect path).

Public functions take and return channels-last tensors, as the JAX package
does: ``YoloV8`` maps (B, S, S, 3) to per-level {"box": (B, h, w, 4·16),
"cls": (B, h, w, nc)}; convolutions run NCHW inside.  Parameter names
mirror the flax module tree (``stem.conv.weight``, ``c2f1.m0.cv1.bn.var``),
so ``weights.from_jax_params`` converts one to one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.nms import nms_batched

VARIANTS = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}


def _make_div(x: float, div: int = 8) -> int:
    return max(div, int(x + div / 2) // div * div)


class BN(nn.Module):
    """Inference batch norm, eps 1e-3: folded in the stats' (f32) precision,
    the output cast back to the input dtype (the bf16 policy keeps the
    stats f32 without promoting the next conv)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def forward(self, x):                            # NCHW
        sh = (1, -1, 1, 1)
        y = (x - self.mean.view(sh)) * torch.rsqrt(self.var.view(sh)
                                                   + self.eps) \
            * self.scale.view(sh) + self.bias.view(sh)
        return y.to(x.dtype)


class ConvBnSiLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, cout, 3)
        self.cv2 = ConvBnSiLU(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        self.c = c = cout // 2
        self.n = n
        self.cv1 = ConvBnSiLU(cin, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut))
        self.cv2 = ConvBnSiLU((2 + n) * c, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, pool: int = 5):
        super().__init__()
        c = cin // 2
        self.pool = pool
        self.cv1 = ConvBnSiLU(cin, c, 1)
        self.cv2 = ConvBnSiLU(4 * c, cout, 1)

    def forward(self, x):
        x = self.cv1(x)
        p = self.pool
        y1 = F.max_pool2d(x, p, 1, p // 2)
        y2 = F.max_pool2d(y1, p, 1, p // 2)
        y3 = F.max_pool2d(y2, p, 1, p // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class DetectBranch(nn.Module):
    """One level of the decoupled Detect head (box DFL + cls)."""

    def __init__(self, cin: int, c2: int, c3: int, reg_max: int, nc: int):
        super().__init__()
        self.box0 = ConvBnSiLU(cin, c2, 3)
        self.box1 = ConvBnSiLU(c2, c2, 3)
        self.box2 = nn.Conv2d(c2, 4 * reg_max, 1)
        self.cls0 = ConvBnSiLU(cin, c3, 3)
        self.cls1 = ConvBnSiLU(c3, c3, 3)
        self.cls2 = nn.Conv2d(c3, nc, 1)

    def forward(self, x):
        box = self.box2(self.box1(self.box0(x)))
        cls = self.cls2(self.cls1(self.cls0(x)))
        return box, cls


class YoloV8(nn.Module):
    """Backbone + PAN neck + detect head; forward(images (B, S, S, 3))
    -> {"levels": [{"box", "cls"} x 3]} channels-last."""

    def __init__(self, variant: str = "n", num_classes: int = 80,
                 reg_max: int = 16, device=None):
        super().__init__()
        d, w, mc = VARIANTS[variant]
        chs = [_make_div(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)]
        n2 = max(1, round(3 * d))
        n3 = max(1, round(6 * d))
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.stem = ConvBnSiLU(3, chs[0], 3, 2)
        self.down1 = ConvBnSiLU(chs[0], chs[1], 3, 2)
        self.c2f1 = C2f(chs[1], chs[1], n2, True)
        self.down2 = ConvBnSiLU(chs[1], chs[2], 3, 2)
        self.c2f2 = C2f(chs[2], chs[2], n3, True)
        self.down3 = ConvBnSiLU(chs[2], chs[3], 3, 2)
        self.c2f3 = C2f(chs[3], chs[3], n3, True)
        self.down4 = ConvBnSiLU(chs[3], chs[4], 3, 2)
        self.c2f4 = C2f(chs[4], chs[4], n2, True)
        self.sppf = SPPF(chs[4], chs[4], 5)
        self.neck1 = C2f(chs[4] + chs[3], chs[3], n2, False)
        self.neck2 = C2f(chs[3] + chs[2], chs[2], n2, False)
        self.neck_down1 = ConvBnSiLU(chs[2], chs[2], 3, 2)
        self.neck3 = C2f(chs[2] + chs[3], chs[3], n2, False)
        self.neck_down2 = ConvBnSiLU(chs[3], chs[3], 3, 2)
        self.neck4 = C2f(chs[3] + chs[4], chs[4], n2, False)
        c2 = max(16, chs[2] // 4, reg_max * 4)
        c3 = max(chs[2], min(num_classes, 100))
        for i, cin in enumerate((chs[2], chs[3], chs[4])):
            self.add_module(f"detect{i}",
                            DetectBranch(cin, c2, c3, reg_max, num_classes))
        self.to(resolve_device(device))

    def forward(self, images: torch.Tensor) -> Dict[str, List[Dict]]:
        x = images.permute(0, 3, 1, 2)
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        # jax.image.resize "nearest" at an exact 2x == torch "nearest-exact"
        u = F.interpolate(p5, size=p4.shape[-2:], mode="nearest-exact")
        h4 = self.neck1(torch.cat([u, p4], dim=1))
        u = F.interpolate(h4, size=p3.shape[-2:], mode="nearest-exact")
        o3 = self.neck2(torch.cat([u, p3], dim=1))
        o4 = self.neck3(torch.cat([self.neck_down1(o3), h4], dim=1))
        o5 = self.neck4(torch.cat([self.neck_down2(o4), p5], dim=1))
        levels = []
        for i, f in enumerate((o3, o4, o5)):
            box, cls = getattr(self, f"detect{i}")(f)
            levels.append({"box": box.permute(0, 2, 3, 1),
                           "cls": cls.permute(0, 2, 3, 1)})
        return {"levels": levels}


def _anchors_for(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def decode_predictions(levels: List[Dict[str, torch.Tensor]],
                       reg_max: int = 16,
                       strides: Sequence[int] = (8, 16, 32)):
    """Raw per-level maps -> boxes (B, A, 4) xyxy in canvas pixels (DFL
    expectation decode) and class scores (B, A, nc)."""
    all_boxes, all_scores = [], []
    for level, stride in zip(levels, strides):
        box_map, cls_map = level["box"], level["cls"]
        b, h, w, _ = box_map.shape
        anchors = _anchors_for(h, w, box_map.device)
        dist = torch.softmax(box_map.reshape(b, h * w, 4, reg_max), dim=-1)
        bins = torch.arange(reg_max, dtype=dist.dtype, device=dist.device)
        ltrb = (dist * bins).sum(-1)                              # cells
        x1y1 = (anchors[None] - ltrb[..., :2]) * float(stride)
        x2y2 = (anchors[None] + ltrb[..., 2:]) * float(stride)
        all_boxes.append(torch.cat([x1y1, x2y2], dim=-1))
        all_scores.append(torch.sigmoid(cls_map.reshape(b, h * w, -1)))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def detect(levels, conf_threshold: float = 0.25, iou_threshold: float = 0.45,
           max_det: int = 32, reg_max: int = 16,
           strides: Sequence[int] = (8, 16, 32), pre_topk: int = 256):
    """decode -> class argmax -> pre-NMS top-k -> fixed-K NMS.  Returns
    dict(boxes (B,K,4), scores (B,K), classes (B,K) int32, valid (B,K))."""
    boxes, scores = decode_predictions(levels, reg_max, strides)
    cls_score, cls_id = scores.max(dim=-1)
    cls_id = cls_id.to(torch.int32)
    if cls_score.shape[-1] > pre_topk:
        # lax.top_k breaks ties by lowest index; torch.topk promises no
        # order among equal scores (on CUDA in particular), so an exact tie
        # at the cut or inside the set can pick or order candidates
        # differently — the tests compare selected sets, not positions.
        cls_score, top_idx = torch.topk(cls_score, pre_topk, dim=-1)
        boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        cls_id = torch.gather(cls_id, 1, top_idx)
    ob, osc, ocl, valid = nms_batched(
        boxes, cls_score, cls_id, max_out=max_det,
        iou_threshold=iou_threshold, score_threshold=conf_threshold)
    return {"boxes": ob, "scores": osc, "classes": ocl, "valid": valid}
