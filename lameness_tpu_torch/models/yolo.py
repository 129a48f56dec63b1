"""YOLOv8 detector and pose model (port of ``lameness_tpu/models/yolo.py``).

Public functions take and return channels-last tensors, as the JAX package
does: ``YoloV8`` maps (B, S, S, 3) to per-level {"box": (B, h, w, 4·16),
"cls": (B, h, w, nc)}, plus "kpt": (B, h, w, nk·3) with ``num_keypoints``;
convolutions run NCHW inside.  Parameter names mirror the flax module tree
(``stem.conv.weight``, ``c2f1.m0.cv1.bn.var``), so ``weights.from_jax_params``
converts one to one.  ``convert_ultralytics_state_dict`` turns an
ultralytics ``state_dict`` into that flax tree (numpy leaves), as the JAX
converter does; ``export_ultralytics_state_dict`` is its inverse.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
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


class PoseBranch(nn.Module):
    """One level of the pose head: nk = num_keypoints·3 channels."""

    def __init__(self, cin: int, c4: int, nk: int):
        super().__init__()
        self.kpt0 = ConvBnSiLU(cin, c4, 3)
        self.kpt1 = ConvBnSiLU(c4, c4, 3)
        self.kpt2 = nn.Conv2d(c4, nk, 1)

    def forward(self, x):
        return self.kpt2(self.kpt1(self.kpt0(x)))


class YoloV8(nn.Module):
    """Backbone + PAN neck + detect head (and, with ``num_keypoints``, a
    pose head); forward(images (B, S, S, 3)) -> {"levels": [{"box", "cls"[,
    "kpt"]} x 3]} channels-last."""

    def __init__(self, variant: str = "n", num_classes: int = 80,
                 reg_max: int = 16, num_keypoints: int = 0, device=None):
        super().__init__()
        d, w, mc = VARIANTS[variant]
        chs = [_make_div(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)]
        n2 = max(1, round(3 * d))
        n3 = max(1, round(6 * d))
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.num_keypoints = num_keypoints
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
            if num_keypoints:
                c4 = max(chs[2] // 4, num_keypoints * 3)
                self.add_module(f"pose{i}",
                                PoseBranch(cin, c4, num_keypoints * 3))
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
            level = {"box": box.permute(0, 2, 3, 1),
                     "cls": cls.permute(0, 2, 3, 1)}
            if self.num_keypoints:
                level["kpt"] = getattr(self, f"pose{i}")(f).permute(0, 2, 3, 1)
            levels.append(level)
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
    expectation decode), class scores (B, A, nc) and, with a pose head,
    keypoints (B, A, Kp, 3): xy in canvas pixels, sigmoid confidence (None
    without)."""
    all_boxes, all_scores, all_kpts = [], [], []
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
        if "kpt" in level:
            kpt = level["kpt"].reshape(b, h * w, -1, 3)
            xy = (kpt[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) \
                * float(stride)
            all_kpts.append(torch.cat([xy, torch.sigmoid(kpt[..., 2:3])],
                                      dim=-1))
    kpts = torch.cat(all_kpts, dim=1) if all_kpts else None
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1), kpts


def detect(levels, conf_threshold: float = 0.25, iou_threshold: float = 0.45,
           max_det: int = 32, reg_max: int = 16,
           strides: Sequence[int] = (8, 16, 32), pre_topk: int = 256):
    """decode -> class argmax -> pre-NMS top-k -> fixed-K NMS.  Returns
    dict(boxes (B,K,4), scores (B,K), classes (B,K) int32, valid (B,K)), and
    keypoints (B,K,Kp,3) when the model has a pose head."""
    boxes, scores, kpts = decode_predictions(levels, reg_max, strides)
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
        if kpts is not None:
            kpts = torch.gather(kpts, 1, top_idx[..., None, None].expand(
                -1, -1, kpts.shape[2], 3))
    ob, osc, ocl, valid = nms_batched(
        boxes, cls_score, cls_id, max_out=max_det,
        iou_threshold=iou_threshold, score_threshold=conf_threshold)
    out = {"boxes": ob, "scores": osc, "classes": ocl, "valid": valid}
    if kpts is not None:
        # the selected anchors' keypoints, by nearest box: NMS returns the
        # candidates' own boxes, so the L1 distance over all four
        # coordinates is 0 at the source (argmin: first index on ties)
        d = (ob[:, :, None, :] - boxes[:, None, :, :]).abs().sum(-1)
        idx = torch.argmin(d, dim=-1)
        out["keypoints"] = torch.gather(
            kpts, 1, idx[..., None, None].expand(-1, -1, kpts.shape[2], 3))
    return out


# ---------------------------------------------------------------------------
# ultralytics state_dict conversion (a copy of the JAX package's: the same
# numpy flax tree, which ``weights.from_jax_params`` turns into state dicts)
# ---------------------------------------------------------------------------
_BACKBONE_MAP = [
    ("stem", "0"), ("down1", "1"), ("c2f1", "2"), ("down2", "3"),
    ("c2f2", "4"), ("down3", "5"), ("c2f3", "6"), ("down4", "7"),
    ("c2f4", "8"), ("sppf", "9"), ("neck1", "12"), ("neck2", "15"),
    ("neck_down1", "16"), ("neck3", "18"), ("neck_down2", "19"),
    ("neck4", "21"),
]


def _conv_bn(sd, t):
    return {
        "conv": {"kernel": np.transpose(sd[f"{t}.conv.weight"], (2, 3, 1, 0))},
        "bn": {"scale": sd[f"{t}.bn.weight"], "bias": sd[f"{t}.bn.bias"],
               "mean": sd[f"{t}.bn.running_mean"],
               "var": sd[f"{t}.bn.running_var"]},
    }


def _plain_conv(sd, t):
    return {"kernel": np.transpose(sd[f"{t}.weight"], (2, 3, 1, 0)),
            "bias": sd[f"{t}.bias"]}


def _c2f(sd, t, n):
    p = {"cv1": _conv_bn(sd, f"{t}.cv1"), "cv2": _conv_bn(sd, f"{t}.cv2")}
    for i in range(n):
        p[f"m{i}"] = {"cv1": _conv_bn(sd, f"{t}.m.{i}.cv1"),
                      "cv2": _conv_bn(sd, f"{t}.m.{i}.cv2")}
    return p


def export_ultralytics_state_dict(params: Dict, has_pose: bool = False
                                  ) -> Dict[str, Any]:
    """Inverse of :func:`convert_ultralytics_state_dict`: a flax-layout tree
    ({"params": ...}, numpy leaves) under ultralytics YOLOv8 key names
    (``0.conv.weight``, ...), numpy values.  Synthesises checkpoints in the
    real file layout without the downloads."""
    sd: Dict[str, Any] = {}

    def put_conv_bn(t, node):
        sd[f"{t}.conv.weight"] = np.transpose(
            np.asarray(node["conv"]["kernel"]), (3, 2, 0, 1))
        sd[f"{t}.bn.weight"] = np.asarray(node["bn"]["scale"])
        sd[f"{t}.bn.bias"] = np.asarray(node["bn"]["bias"])
        sd[f"{t}.bn.running_mean"] = np.asarray(node["bn"]["mean"])
        sd[f"{t}.bn.running_var"] = np.asarray(node["bn"]["var"])
        sd[f"{t}.bn.num_batches_tracked"] = np.asarray(0)

    def put_plain(t, node):
        sd[f"{t}.weight"] = np.transpose(np.asarray(node["kernel"]),
                                         (3, 2, 0, 1))
        sd[f"{t}.bias"] = np.asarray(node["bias"])

    p = params["params"]
    for ours, idx in _BACKBONE_MAP:
        node = p[ours]
        if "cv1" in node:                               # c2f or sppf
            put_conv_bn(f"{idx}.cv1", node["cv1"])
            put_conv_bn(f"{idx}.cv2", node["cv2"])
            ms = sorted((k for k in node
                         if k.startswith("m") and k[1:].isdigit()),
                        key=lambda k: int(k[1:]))   # m10 after m9
            for k in ms:
                put_conv_bn(f"{idx}.m.{k[1:]}.cv1", node[k]["cv1"])
                put_conv_bn(f"{idx}.m.{k[1:]}.cv2", node[k]["cv2"])
        else:
            put_conv_bn(idx, node)
    for i in range(3):
        d = p[f"detect{i}"]
        put_conv_bn(f"22.cv2.{i}.0", d["box0"])
        put_conv_bn(f"22.cv2.{i}.1", d["box1"])
        put_plain(f"22.cv2.{i}.2", d["box2"])
        put_conv_bn(f"22.cv3.{i}.0", d["cls0"])
        put_conv_bn(f"22.cv3.{i}.1", d["cls1"])
        put_plain(f"22.cv3.{i}.2", d["cls2"])
        if has_pose and f"pose{i}" in p:
            k = p[f"pose{i}"]
            put_conv_bn(f"22.cv4.{i}.0", k["kpt0"])
            put_conv_bn(f"22.cv4.{i}.1", k["kpt1"])
            put_plain(f"22.cv4.{i}.2", k["kpt2"])
    # the DFL bin-expectation conv the converter skips
    sd["22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(
        1, 16, 1, 1)
    return sd


def convert_ultralytics_state_dict(sd: Dict[str, Any], variant: str = "n",
                                   has_pose: bool = False) -> Dict:
    """An ultralytics YOLOv8 ``model.state_dict()`` (keys like
    ``model.0.conv.weight``) -> {"params": flax tree} with numpy leaves.
    The DFL conv (fixed bin-expectation weights) is folded into the softmax
    decode and skipped."""
    sd = {k[len("model."):] if k.startswith("model.") else k:
          (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}
    d_scale = VARIANTS[variant][0]
    n2 = max(1, round(3 * d_scale))
    n3 = max(1, round(6 * d_scale))
    depths = {"c2f1": n2, "c2f2": n3, "c2f3": n3, "c2f4": n2,
              "neck1": n2, "neck2": n2, "neck3": n2, "neck4": n2}
    p: Dict[str, Any] = {}
    for ours, idx in _BACKBONE_MAP:
        if ours.startswith(("c2f", "neck")) and not ours.startswith("neck_"):
            p[ours] = _c2f(sd, idx, depths[ours])
        elif ours == "sppf":
            p[ours] = {"cv1": _conv_bn(sd, f"{idx}.cv1"),
                       "cv2": _conv_bn(sd, f"{idx}.cv2")}
        else:
            p[ours] = _conv_bn(sd, idx)
    head = "22"
    for i in range(3):
        p[f"detect{i}"] = {
            "box0": _conv_bn(sd, f"{head}.cv2.{i}.0"),
            "box1": _conv_bn(sd, f"{head}.cv2.{i}.1"),
            "box2": _plain_conv(sd, f"{head}.cv2.{i}.2"),
            "cls0": _conv_bn(sd, f"{head}.cv3.{i}.0"),
            "cls1": _conv_bn(sd, f"{head}.cv3.{i}.1"),
            "cls2": _plain_conv(sd, f"{head}.cv3.{i}.2"),
        }
        if has_pose:
            p[f"pose{i}"] = {
                "kpt0": _conv_bn(sd, f"{head}.cv4.{i}.0"),
                "kpt1": _conv_bn(sd, f"{head}.cv4.{i}.1"),
                "kpt2": _plain_conv(sd, f"{head}.cv4.{i}.2"),
            }
    return {"params": p}
