"""YOLOv8-pose fine-tuning for the 20-keypoint cow model (port of
``lameness_tpu/pipeline/pose_training.py``).

The equivalent of ``scripts/train_cow_pose_model.py`` (which wraps
``YOLO("yolov8n-pose.pt").train``): trains the port's YoloV8 pose variant
with a single-positive-per-target assignment (the anchor whose cell holds
the box centre at the level matching the object's size), BCE objectness,
DFL box loss and an OKS-style keypoint loss, with ``adamw(lr)``.  The
checkpoint lands under ``<models_dir>/pose``, where ``restore_engine``
installs it into an engine with ``pose_pixels``.

``load_coco_pose_dataset`` reads a COCO-keypoints directory with the
port's own image codec (``video/image.py``) where the JAX module uses
OpenCV, which the card's machine lacks.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.yolo import YoloV8
from ..video.image import imread, resize
from ..weights import seeded_state_dict
from .checkpoint import save_params
from .detect_training import sigmoid_bce
from .optim import Optimizer

STRIDES = (8, 16, 32)


def assign_targets(boxes: np.ndarray, kpts: np.ndarray, img_size: int,
                   num_kpts: int = 20) -> Dict[str, np.ndarray]:
    """One ground-truth box+pose per image -> per-level dense targets.

    boxes: (B, 4) xyxy pixels; kpts: (B, K, 3) x,y,visible.
    Returns per-level obj/box/kpt targets and the positive-cell mask.
    """
    b = boxes.shape[0]
    out = {}
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    size = np.maximum(w, h)
    # pick the level whose stride best matches the object size / 8
    level_idx = np.clip(np.round(np.log2(np.maximum(size, 1) / 32)), 0, 2
                        ).astype(int)
    for li, stride in enumerate(STRIDES):
        g = img_size // stride
        obj = np.zeros((b, g, g), np.float32)
        box_t = np.zeros((b, g, g, 4), np.float32)
        kpt_t = np.zeros((b, g, g, num_kpts, 3), np.float32)
        for i in range(b):
            if level_idx[i] != li:
                continue
            cx = (boxes[i, 0] + boxes[i, 2]) / 2 / stride
            cy = (boxes[i, 1] + boxes[i, 3]) / 2 / stride
            gx, gy = int(np.clip(cx, 0, g - 1)), int(np.clip(cy, 0, g - 1))
            obj[i, gy, gx] = 1.0
            # ltrb distances in cell units (DFL target)
            ax, ay = gx + 0.5, gy + 0.5
            box_t[i, gy, gx] = [ax - boxes[i, 0] / stride,
                                ay - boxes[i, 1] / stride,
                                boxes[i, 2] / stride - ax,
                                boxes[i, 3] / stride - ay]
            kpt_t[i, gy, gx] = kpts[i]
        out[f"obj{li}"] = obj
        out[f"box{li}"] = box_t
        out[f"kpt{li}"] = kpt_t
    return out


def pose_loss(model: YoloV8, images: torch.Tensor,
              targets: Dict[str, torch.Tensor], reg_max: int = 16
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The pose loss of ``model`` (its current parameters) on (B, S, S, 3)
    images and ``assign_targets``' tensors: cls + 0.5·box + 2·kpt."""
    out = model(images)
    total_cls = total_box = total_kpt = 0.0
    for li, stride in enumerate(STRIDES):
        level = out["levels"][li]
        obj_t = targets[f"obj{li}"]                    # (B, g, g)
        box_t = targets[f"box{li}"]                    # (B, g, g, 4)
        kpt_t = targets[f"kpt{li}"]                    # (B, g, g, K, 3)
        cls_logits = level["cls"][..., 0]              # single class
        total_cls = total_cls + sigmoid_bce(cls_logits, obj_t).mean()
        pos = obj_t[..., None]
        # DFL: cross-entropy of the distance distribution vs soft 2-bin target
        dist_logits = level["box"].reshape(*obj_t.shape, 4, reg_max)
        t = box_t.clamp(0, reg_max - 1 - 1e-3)
        tl = torch.floor(t)
        wr = t - tl
        tl_i = tl.long()
        logp = torch.log_softmax(dist_logits, dim=-1)
        nll = -(torch.gather(logp, -1, tl_i[..., None])[..., 0] * (1 - wr)
                + torch.gather(logp, -1, (tl_i + 1).clamp(
                    max=reg_max - 1)[..., None])[..., 0] * wr)
        total_box = total_box + (nll.mean(dim=-1) * obj_t).sum() / \
            obj_t.sum().clamp(min=1)
        # keypoints: decode the head's offset parameterisation
        kpt_raw = level["kpt"].reshape(*obj_t.shape, -1, 3)
        g = obj_t.shape[1]
        cell = torch.arange(g, dtype=obj_t.dtype, device=obj_t.device) + 0.5
        ax = cell[None, None, :].expand(obj_t.shape)
        ay = cell[None, :, None].expand(obj_t.shape)
        pred_x = (kpt_raw[..., 0] * 2.0 + (ax[..., None] - 0.5)) * stride
        pred_y = (kpt_raw[..., 1] * 2.0 + (ay[..., None] - 0.5)) * stride
        vis = kpt_t[..., 2]
        scale = (box_t[..., 2] + box_t[..., 0]).clamp(min=1.0)[..., None] \
            * stride
        d2 = ((pred_x - kpt_t[..., 0]) ** 2
              + (pred_y - kpt_t[..., 1]) ** 2) / (scale ** 2)
        oks = 1.0 - torch.exp(-d2 * 4.0)
        kpt_pos = pos * vis
        total_kpt = total_kpt + (oks * kpt_pos).sum() / \
            kpt_pos.sum().clamp(min=1)
        total_kpt = total_kpt + sigmoid_bce(
            kpt_raw[..., 2], vis * obj_t[..., None]).mean()
    loss = total_cls + 0.5 * total_box + 2.0 * total_kpt
    return loss, {"cls": total_cls, "box": total_box, "kpt": total_kpt}


def load_coco_pose_dataset(root: Path, img_size: int = 320,
                           limit: Optional[int] = None, device=None):
    """Minimal COCO-keypoints loader: root/annotations.json + root/images.
    Keeps the first annotation per image (single-cow assumption).  Images
    are decoded on ``device`` (the card unless ``"cpu"``) and resized to
    ``img_size``² on the host as cv2.resize does (within 1); returns
    (N, S, S, 3) uint8 RGB, (N, 4) xyxy boxes and (N, K, 3) keypoints with
    visibility 0/1, all scaled to the resized image."""
    ann = json.load(open(Path(root) / "annotations.json"))
    imgs = {im["id"]: im for im in ann["images"]}
    by_img = {}
    for a in ann["annotations"]:
        by_img.setdefault(a["image_id"], a)
    images, boxes, kpts = [], [], []
    for img_id, a in list(by_img.items())[:limit]:
        meta = imgs[img_id]
        f = Path(root) / "images" / meta["file_name"]
        if not f.exists():
            continue
        im = imread(f, device).cpu().numpy()
        sy = img_size / im.shape[0]
        sx = img_size / im.shape[1]
        im = resize(im, (img_size, img_size))
        x, y, w, h = a["bbox"]
        k = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        k[:, 0] *= sx
        k[:, 1] *= sy
        k[:, 2] = (k[:, 2] > 0).astype(np.float32)
        images.append(im)
        boxes.append([x * sx, y * sy, (x + w) * sx, (y + h) * sy])
        kpts.append(k)
    return (np.stack(images).astype(np.uint8), np.asarray(boxes, np.float32),
            np.stack(kpts))


def train_pose_model(images: np.ndarray, boxes: np.ndarray, kpts: np.ndarray,
                     models_dir: Optional[Path] = None, epochs: int = 30,
                     batch_size: int = 8, lr: float = 1e-3,
                     img_size: int = 320, num_kpts: int = 20,
                     seed: int = 0, device=None) -> Dict[str, Any]:
    """Train the pose variant on ``device`` (``None``: the card; raises
    without one) from weights seeded with ``seed``; checkpoints under
    models_dir/pose.  Returns the loss history and the trained state dict
    (``params``)."""
    dev = resolve_device(device)
    model = YoloV8(variant="n", num_classes=1, num_keypoints=num_kpts,
                   device=dev)
    model.load_state_dict(seeded_state_dict(
        model, torch.Generator().manual_seed(seed)))
    opt = Optimizer(model.parameters(), lr)

    targets_np = assign_targets(boxes, kpts, img_size, num_kpts)
    x_all = torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
    t_all = {k: torch.from_numpy(v).to(dev) for k, v in targets_np.items()}

    n = images.shape[0]
    rng = np.random.default_rng(seed)
    history = []
    for _ in range(epochs):
        order = rng.permutation(n)
        ep_loss, steps = 0.0, 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            tb = {k: v[idx] for k, v in t_all.items()}
            loss, _ = pose_loss(model, x_all[idx], tb)
            opt.step(loss)
            ep_loss += loss.item()
            steps += 1
        history.append(ep_loss / max(1, steps))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if models_dir is not None:
        save_params(models_dir, "pose", params)
    return {"status": "completed", "loss_history": history,
            "final_loss": history[-1], "params": params}
