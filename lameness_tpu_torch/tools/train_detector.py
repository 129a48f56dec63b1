"""Fine-tune the cow detector with the TAL trainer and report mAP (port of
``scripts/train_detector.py``): loads a COCO-detection dataset
(root/annotations.json + root/images, read by the port's codec), trains
``YoloV8`` with task-aligned assignment + CIoU/DFL/BCE on ``--device``,
tracks EMA weights, evaluates COCO mAP each epoch on a held-out split, and
saves the best EMA weights as ``<out>/detector_best/params.torch``:

  python -m lameness_tpu_torch.tools.train_detector --data DIR [--variant n]
      [--img 320] [--epochs 20] [--batch 8] [--out data/models/detector]
  python -m lameness_tpu_torch.tools.train_detector --synthetic   # no dataset
"""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import numpy as np
import torch

from ..video.image import imread, resize
from . import add_device_arg, device_of


def load_coco_detection(root: Path, img_size: int, max_boxes: int = 8,
                        device=None):
    """COCO-detection loader -> padded trainer arrays (images decoded on
    ``device``, the card unless ``"cpu"``)."""
    ann = json.load(open(Path(root) / "annotations.json"))
    imgs = {im["id"]: im for im in ann["images"]}
    by_img = {}
    for a in ann["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    cat_ids = sorted({a["category_id"] for a in ann["annotations"]})
    cat_map = {c: i for i, c in enumerate(cat_ids)}
    images, boxes, labels, masks = [], [], [], []
    for img_id, anns in by_img.items():
        meta = imgs[img_id]
        f = Path(root) / "images" / meta["file_name"]
        if not f.exists():
            continue
        im = imread(f, device).cpu().numpy()
        sy, sx = img_size / im.shape[0], img_size / im.shape[1]
        images.append(resize(im, (img_size, img_size)))
        b = np.zeros((max_boxes, 4), np.float32)
        l = np.zeros((max_boxes,), np.int64)
        m = np.zeros((max_boxes,), bool)
        for j, a in enumerate(anns[:max_boxes]):
            x, y, w, h = a["bbox"]
            b[j] = [x * sx, y * sy, (x + w) * sx, (y + h) * sy]
            l[j] = cat_map[a["category_id"]]
            m[j] = True
        boxes.append(b); labels.append(l); masks.append(m)
    return (np.stack(images).astype(np.float32) / 255.0,
            np.stack(labels), np.stack(boxes), np.stack(masks),
            len(cat_ids))


def synthetic_dataset(n=16, img_size=160, seed=0):
    """Bright-square 'cows' for smoke runs without a dataset."""
    rng = np.random.default_rng(seed)
    images = np.full((n, img_size, img_size, 3), 0.2, np.float32)
    boxes = np.zeros((n, 2, 4), np.float32)
    labels = np.zeros((n, 2), np.int64)
    masks = np.zeros((n, 2), bool)
    for i in range(n):
        x, y = rng.integers(10, img_size - 70, 2)
        w, h = rng.integers(40, 64, 2)
        images[i, y:y + h, x:x + w] = 0.9
        boxes[i, 0] = [x, y, x + w, y + h]
        masks[i, 0] = True
    return images, labels, boxes, masks, 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train_detector")
    ap.add_argument("--data", type=Path)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--variant", default="n")
    ap.add_argument("--img", type=int, default=320)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--val-frac", type=float, default=0.2)
    ap.add_argument("--out", type=Path, default=Path("data/models/detector"))
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..models.yolo import YoloV8, detect
    from ..pipeline.checkpoint import save_params
    from ..pipeline.detect_training import DetectTrainer
    from ..pipeline.evaluation import evaluate_detections
    from ..weights import seeded_state_dict

    if args.synthetic:
        images, labels, boxes, masks, nc = synthetic_dataset(
            img_size=min(args.img, 160))
    else:
        if not args.data:
            ap.error("--data DIR or --synthetic required")
        images, labels, boxes, masks, nc = load_coco_detection(
            args.data, args.img, device=device)
    n = len(images)
    n_val = max(1, int(n * args.val_frac))
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    tr, va = perm[n_val:], perm[:n_val]
    print(f"dataset: {len(tr)} train / {len(va)} val, {nc} classes")

    model = YoloV8(variant=args.variant, num_classes=nc, device=device)
    model.load_state_dict(seeded_state_dict(
        model, torch.Generator().manual_seed(0)))
    trainer = DetectTrainer(model, lr=args.lr, device=device)
    ema_model = copy.deepcopy(model).eval()
    val_images = torch.from_numpy(images[va]).to(device)

    def val_map(ema):
        ema_model.load_state_dict(ema)
        with torch.no_grad():
            d = detect(ema_model(val_images)["levels"], conf_threshold=0.05,
                       max_det=16)
        return evaluate_detections(
            d["boxes"].cpu().numpy(), d["scores"].cpu().numpy(),
            d["classes"].cpu().numpy(), d["valid"].cpu().numpy(),
            boxes[va], labels[va], masks[va], nc)

    best = -1.0
    steps_per_epoch = max(1, len(tr) // args.batch)
    for epoch in range(args.epochs):
        rng.shuffle(tr)
        tot = 0.0
        for s in range(steps_per_epoch):
            idx = tr[s * args.batch:(s + 1) * args.batch]
            if len(idx) < args.batch:      # static shapes: wrap around
                idx = np.concatenate([idx, tr[:args.batch - len(idx)]])
            aux = trainer.train_step(images[idx], labels[idx], boxes[idx],
                                     masks[idx])
            tot += aux["total"]
        m = val_map(trainer.ema_params)
        print(f"epoch {epoch}: loss {tot / steps_per_epoch:.3f} "
              f"mAP50 {m['mAP50']:.3f} mAP50-95 {m['mAP50_95']:.3f}")
        if m["mAP50_95"] > best:
            best = m["mAP50_95"]
            args.out.mkdir(parents=True, exist_ok=True)
            save_params(args.out, "detector_best", trainer.ema_params)
    print(json.dumps({"best_mAP50_95": best}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
