"""YOLO detection training: task-aligned assignment + CIoU/DFL/BCE losses
(port of ``lameness_tpu/pipeline/detect_training.py``).

The reference fine-tunes its cow detector with the ultralytics trainer
(yolo_cow_id/train.py): task-aligned assignment (TOOD), a CIoU box loss, a
distribution-focal loss over the ltrb bin distributions, and BCE
classification against the soft task-aligned scores.  These are those
functions over the port's ``YoloV8`` raw head outputs, with the JAX
package's fixed shapes: ground-truth boxes padded to ``max_boxes`` with a
validity mask, a dense (B, M, A) assigner.

Where the JAX package takes ``argmax``/``argmin`` (over booleans and masked
values), the first index of the extreme wins; :func:`_first_true` keeps
that rule on every device.  ``stop_gradient`` is ``.detach()``.  The JAX
step is one ``jax.jit``; here it is an eager chain of launches on the card.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..models.yolo import YoloV8, _anchors_for
from .optim import LearningRate, Optimizer


# ---------------------------------------------------------------------------
# first-index extremes (jnp.argmax / jnp.argmin)
# ---------------------------------------------------------------------------
def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """The first index along ``dim`` where ``mask`` holds, 0 where it holds
    nowhere (``jnp.argmax`` of a boolean array)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape)
    first = torch.where(mask, idx, n).amin(dim)
    return torch.where(first == n, 0, first)


def _argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _first_true(x == x.amax(dim, keepdim=True), dim)


def _argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _first_true(x == x.amin(dim, keepdim=True), dim)


def _one_hot(labels: torch.Tensor, n: int, dtype=torch.float32
             ) -> torch.Tensor:
    """``jax.nn.one_hot``: an out-of-range label gives a zero row."""
    return (labels[..., None] == torch.arange(n, device=labels.device)
            ).to(dtype)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return F.binary_cross_entropy_with_logits(logits, labels,
                                              reduction="none")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
def elementwise_iou(a: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """IoU of aligned box arrays (..., 4) xyxy."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a + area_b - inter + eps)


def ciou(pred: torch.Tensor, target: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU (aligned, (..., 4) xyxy): IoU - center-dist - aspect."""
    iou = elementwise_iou(pred, target, eps)
    c_lt = torch.minimum(pred[..., :2], target[..., :2])
    c_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    c_wh = (c_rb - c_lt).clamp(min=0.0)
    c2 = c_wh[..., 0] ** 2 + c_wh[..., 1] ** 2 + eps
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    tc = (target[..., :2] + target[..., 2:]) / 2
    rho2 = ((pc - tc) ** 2).sum(-1)
    pw = (pred[..., 2] - pred[..., 0]).clamp(min=eps)
    ph = (pred[..., 3] - pred[..., 1]).clamp(min=eps)
    tw = (target[..., 2] - target[..., 0]).clamp(min=eps)
    th = (target[..., 3] - target[..., 1]).clamp(min=eps)
    v = (4 / math.pi ** 2) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    alpha = (v / (v - iou + 1 + eps)).detach()
    return iou - rho2 / c2 - alpha * v


# ---------------------------------------------------------------------------
# flat head views
# ---------------------------------------------------------------------------
class FlatPreds(NamedTuple):
    cls_logits: torch.Tensor    # (B, A, C)
    dist_logits: torch.Tensor   # (B, A, 4, reg_max)
    boxes: torch.Tensor         # (B, A, 4) xyxy pixels (DFL expectation)
    anchors: torch.Tensor       # (A, 2) pixel centers
    strides: torch.Tensor       # (A,)
    kpts: Optional[torch.Tensor]  # (B, A, K, 3): xy pixels + vis logit


def flatten_levels(levels, reg_max: int = 16,
                   strides: Sequence[int] = (8, 16, 32)) -> FlatPreds:
    cls_l, dist_l, box_l, anc_l, str_l, kpt_l = [], [], [], [], [], []
    for level, stride in zip(levels, strides):
        box_map, cls_map = level["box"], level["cls"]
        b, h, w, _ = box_map.shape
        anchors = _anchors_for(h, w, box_map.device)
        stride_v = torch.full((h * w,), float(stride), device=box_map.device)
        dist = box_map.reshape(b, h * w, 4, reg_max)
        prob = torch.softmax(dist, dim=-1)
        bins = torch.arange(reg_max, dtype=prob.dtype, device=prob.device)
        ltrb = torch.einsum("bnkr,r->bnk", prob, bins)
        x1y1 = (anchors[None] - ltrb[..., :2]) * stride_v[None, :, None]
        x2y2 = (anchors[None] + ltrb[..., 2:]) * stride_v[None, :, None]
        box_l.append(torch.cat([x1y1, x2y2], -1))
        cls_l.append(cls_map.reshape(b, h * w, -1))
        dist_l.append(dist)
        anc_l.append(anchors * stride)
        str_l.append(stride_v)
        if "kpt" in level:
            kpt = level["kpt"].reshape(b, h * w, -1, 3)
            xy = (kpt[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) \
                * stride_v[None, :, None, None]
            kpt_l.append(torch.cat([xy, kpt[..., 2:]], -1))
    return FlatPreds(torch.cat(cls_l, 1), torch.cat(dist_l, 1),
                     torch.cat(box_l, 1), torch.cat(anc_l, 0),
                     torch.cat(str_l, 0),
                     torch.cat(kpt_l, 1) if kpt_l else None)


# ---------------------------------------------------------------------------
# task-aligned assigner (dense, fixed shapes)
# ---------------------------------------------------------------------------
@torch.no_grad()
def task_aligned_assign(pd_scores: torch.Tensor, pd_boxes: torch.Tensor,
                        anchors: torch.Tensor, gt_labels: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                        topk: int = 10, alpha: float = 0.5,
                        beta: float = 6.0):
    """TOOD assignment.

    pd_scores (B, A, C) in [0, 1]; pd_boxes (B, A, 4) pixels;
    anchors (A, 2) pixel centers; gt_labels (B, M) int; gt_boxes (B, M, 4)
    xyxy pixels; gt_mask (B, M) bool for padded slots.

    Returns target_labels (B, A), target_boxes (B, A, 4),
    target_scores (B, A, C) soft targets, fg_mask (B, A), and
    gt_idx (B, A) — the winning gt slot per anchor (valid where fg).
    """
    b, a, c = pd_scores.shape
    m = gt_boxes.shape[1]
    dev = pd_scores.device
    inf = float("inf")
    slots = torch.arange(m, device=dev)[None, :, None]

    # anchor center strictly inside the gt box
    ax = anchors[None, None, :, 0]
    ay = anchors[None, None, :, 1]
    in_box = ((ax > gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
              & (ay > gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4]))
    in_box = in_box & gt_mask[..., None]                        # (B, M, A)

    # pairwise IoU pred-anchor-box vs gt  (B, M, A)
    lt = torch.maximum(pd_boxes[:, None, :, :2], gt_boxes[:, :, None, :2])
    rb = torch.minimum(pd_boxes[:, None, :, 2:], gt_boxes[:, :, None, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    pa = (pd_boxes[..., 2] - pd_boxes[..., 0]).clamp(min=0) * \
        (pd_boxes[..., 3] - pd_boxes[..., 1]).clamp(min=0)
    ga = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=0) * \
        (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=0)
    iou = inter / (pa[:, None] + ga[..., None] - inter + 1e-7)

    # class score of each anchor at the gt's label
    lbl = gt_labels.long().clamp(0, c - 1)                      # (B, M)
    sc = torch.gather(pd_scores.transpose(1, 2), 1,
                      lbl[..., None].expand(b, m, a))           # (B, M, A)
    align = (sc ** alpha) * (iou ** beta)
    align = torch.where(in_box, align, 0.0)

    # top-k candidates per gt
    k = min(topk, a)
    kth = torch.topk(align, k, dim=-1).values[..., -1:]         # (B, M, 1)
    cand = in_box & (align >= kth.clamp(min=1e-9)) & (align > 0)

    # anchors claimed by several gts go to the highest-IoU gt
    n_claims = cand.sum(1)                                      # (B, A)
    best_gt = _argmax(torch.where(cand, iou, -1.0), 1)          # (B, A)
    keep = slots == best_gt[:, None, :]
    cand = cand & torch.where(n_claims[:, None] > 1, keep, True)

    # cold-start fallback after dedup (the JAX package's two claim rounds):
    # a gt left with no candidate claims its closest in-box anchor
    # outright; collisions go to the closer gt (ties: lower index), and the
    # loser and any displaced gt claim their nearest still-free in-box
    # anchor in round 2
    gcx = (gt_boxes[..., 0:1] + gt_boxes[..., 2:3]) / 2
    gcy = (gt_boxes[..., 1:2] + gt_boxes[..., 3:4]) / 2
    cdist = torch.where(in_box, (ax - gcx) ** 2 + (ay - gcy) ** 2, inf)
    fb_claimed = torch.zeros_like(cand[:, 0, :])                # (B, A)
    for _ in range(2):
        cdist_r = torch.where(fb_claimed[:, None, :], inf, cdist)
        need = ((~cand.any(-1)) & gt_mask
                & torch.isfinite(cdist_r).any(-1))              # (B, M)
        fb_anchor = _argmin(cdist_r, -1)                        # (B, M)
        fb = (_one_hot(fb_anchor, a, torch.bool)
              & need[..., None])                                # (B, M, A)
        d_at = torch.gather(cdist_r, -1, fb_anchor[..., None])[..., 0]
        winner = _argmin(torch.where(fb, d_at[..., None], inf), 1)
        fb = fb & (slots == winner[:, None, :])
        fb_round = fb.any(dim=1)                                # (B, A)
        cand = (cand & ~fb_round[:, None, :]) | fb
        fb_claimed = fb_claimed | fb_round

    fg_mask = cand.any(dim=1)                                   # (B, A)
    gt_idx = _first_true(cand, 1)                               # (B, A)
    target_boxes = torch.gather(gt_boxes, 1,
                                gt_idx[..., None].expand(b, a, 4))
    target_labels = torch.where(
        fg_mask, torch.gather(gt_labels.long(), 1, gt_idx), 0)

    # soft targets: align metric normalised so max per gt == max IoU per gt
    align_sel = torch.where(cand, align, 0.0)
    pos_iou = torch.where(cand, iou, 0.0)
    norm = align_sel.amax(-1, keepdim=True) + 1e-9              # (B, M, 1)
    soft = (align_sel * pos_iou.amax(-1, keepdim=True) / norm).amax(1)
    # fallback anchors carry zero align; floor their soft target so the
    # classifier gets a pull-up signal out of the dead zone
    soft = torch.where(fb_claimed, soft.clamp(min=0.5), soft)
    onehot = _one_hot(target_labels, c, pd_scores.dtype)
    target_scores = onehot * torch.where(fg_mask, soft, 0.0)[..., None]
    return target_labels, target_boxes, target_scores, fg_mask, gt_idx


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def dfl_loss(dist_logits: torch.Tensor, target_ltrb: torch.Tensor,
             reg_max: int = 16) -> torch.Tensor:
    """Distribution focal loss: CE against the two bins bracketing the
    target.  dist_logits (..., 4, reg_max); target_ltrb (..., 4) cells."""
    t = target_ltrb.clamp(0.0, reg_max - 1 - 1e-3)
    tl = torch.floor(t)
    wr = t - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(dist_logits, dim=-1)
    il = tl.long()
    ll = torch.gather(logp, -1, il[..., None])[..., 0]
    lr = torch.gather(logp, -1, (il + 1)[..., None])[..., 0]
    return -(wl * ll + wr * lr).mean(-1)


def keypoint_loss(pd_kpts: torch.Tensor, gt_kpts: torch.Tensor,
                  gt_area: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OKS-style location loss + visibility BCE, per anchor.

    pd_kpts (B, A, K, 3) xy pixels + vis logit; gt_kpts (B, A, K, 3)
    xy + vis flag (already gathered per anchor); gt_area (B, A).
    """
    vis = gt_kpts[..., 2] > 0                            # (B, A, K)
    d2 = ((pd_kpts[..., :2] - gt_kpts[..., :2]) ** 2).sum(-1)
    e = d2 / (2.0 * (gt_area[..., None] + 1e-9) * 4.0)   # sigma² folded in
    visf = vis.to(pd_kpts.dtype)
    loc = ((1.0 - torch.exp(-e)) * visf).sum(-1) / \
        visf.sum(-1).clamp(min=1.0)
    kobj = sigmoid_bce(pd_kpts[..., 2], visf).mean(-1)
    return loc, kobj


def detection_loss(levels, gt_labels, gt_boxes, gt_mask,
                   num_classes: int, reg_max: int = 16,
                   strides: Sequence[int] = (8, 16, 32),
                   box_w: float = 7.5, cls_w: float = 0.5,
                   dfl_w: float = 1.5, gt_kpts=None,
                   kpt_w: float = 12.0, kobj_w: float = 1.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total = box_w*CIoU + cls_w*BCE + dfl_w*DFL (ultralytics gains);
    with ``gt_kpts`` (B, M, K, 3) adds the pose-branch OKS + vis-BCE
    terms (kpt_w/kobj_w are the ultralytics pose gains)."""
    fp = flatten_levels(levels, reg_max, strides)
    pd_scores = torch.sigmoid(fp.cls_logits)
    # assignment is a no-grad step (TOOD)
    _, tb, ts, fg, gt_idx = task_aligned_assign(
        pd_scores.detach(), fp.boxes.detach(), fp.anchors, gt_labels,
        gt_boxes, gt_mask)

    tsum = ts.sum().clamp(min=1.0)
    cls = sigmoid_bce(fp.cls_logits, ts).sum() / tsum

    fgf = fg.to(ts.dtype)
    w = ts.sum(-1)                                       # (B, A)
    box = ((1.0 - ciou(fp.boxes, tb)) * w * fgf).sum() / tsum

    # DFL targets in cell units relative to each anchor
    anc = fp.anchors / fp.strides[:, None]               # cells
    tb_c = tb / fp.strides[None, :, None]
    ltrb = torch.cat([anc[None] - tb_c[..., :2],
                      tb_c[..., 2:] - anc[None]], -1)
    dfl = (dfl_loss(fp.dist_logits, ltrb, reg_max) * w * fgf).sum() / tsum

    total = box_w * box + cls_w * cls + dfl_w * dfl
    aux = {"box": box, "cls": cls, "dfl": dfl, "n_fg": fg.sum()}

    if gt_kpts is not None and fp.kpts is not None:
        # gather each fg anchor's gt keypoints (same gt as its box target)
        kb, ka = gt_idx.shape
        kk = gt_kpts.shape[2]
        tk = torch.gather(gt_kpts, 1, gt_idx[..., None, None].expand(
            kb, ka, kk, 3))                              # (B, A, K, 3)
        area = (tb[..., 2] - tb[..., 0]).clamp(min=0) * \
            (tb[..., 3] - tb[..., 1]).clamp(min=0)
        loc, kobj = keypoint_loss(fp.kpts, tk, area)
        kpt_l = (loc * w * fgf).sum() / tsum
        kobj_l = (kobj * w * fgf).sum() / tsum
        total = total + kpt_w * kpt_l + kobj_w * kobj_l
        aux.update(kpt=kpt_l, kobj=kobj_l)

    aux["total"] = total
    return total, aux


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
class DetectTrainer:
    """Trainer for YoloV8 detection heads: ``model``'s parameters are
    trained in place on ``device`` (``None``: the card; raises without
    one) with ``clip_by_global_norm(10)`` + ``adamw(lr, weight_decay)``;
    ``lr`` may be a schedule, as optax's (``pipeline/optim.py``).

    Keeps an exponential moving average of the weights (ultralytics
    ramps its EMA decay as ``d * (1 - exp(-step/tau))``); evaluation
    should use ``ema_params`` (a state dict).
    """

    def __init__(self, model: YoloV8, lr: LearningRate = 1e-3,
                 weight_decay: float = 5e-4, ema_decay: float = 0.9999,
                 ema_tau: float = 2000.0, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.ema_decay = ema_decay
        self.ema_tau = ema_tau
        self.opt = Optimizer(model.parameters(), lr,
                             weight_decay=weight_decay, max_norm=10.0)
        self.ema_params = {k: v.detach().clone()
                           for k, v in model.named_parameters()}
        self._ema = list(self.ema_params.values())
        self._n_steps = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.model.named_parameters()}

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return t.to(self.device, dtype)

    def train_step(self, images, gt_labels, gt_boxes, gt_mask,
                   gt_kpts=None) -> Dict[str, float]:
        """One step on (B, S, S, 3) float images and (B, M) / (B, M, 4) /
        (B, M) padded ground truth (arrays or tensors); returns the loss
        parts as floats."""
        images = self._tensor(images, torch.float32)
        gt_labels = self._tensor(gt_labels, torch.long)
        gt_boxes = self._tensor(gt_boxes, torch.float32)
        gt_mask = self._tensor(gt_mask, torch.bool)
        if gt_kpts is not None:
            gt_kpts = self._tensor(gt_kpts, torch.float32)
        out = self.model(images)
        loss, aux = detection_loss(out["levels"], gt_labels, gt_boxes,
                                   gt_mask, self.model.num_classes,
                                   self.model.reg_max, gt_kpts=gt_kpts)
        self.opt.step(loss)
        with torch.no_grad():
            self._n_steps += 1
            d = self.ema_decay * (1.0 - math.exp(-self._n_steps
                                                 / self.ema_tau))
            torch._foreach_mul_(self._ema, d)
            torch._foreach_add_(self._ema, self.opt.params, alpha=1.0 - d)
        # one read-back for all the parts
        vals = torch.stack([v.detach().float() for v in aux.values()])
        return dict(zip(aux, vals.tolist()))
