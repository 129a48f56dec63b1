"""Fine-tune the 20-keypoint cow pose model (port of
``scripts/train_pose_model.py``) on a COCO-keypoints directory
(``<root>/annotations.json`` + ``<root>/images/``), read by the port's
codec, trained on ``--device``; the checkpoint goes to
``<models-dir>/pose/params.torch``, where ``restore_engine`` finds it:

  python -m lameness_tpu_torch.tools.train_pose_model DATASET [--epochs 50]
         [--img-size 640] [--models-dir data/models] [--limit N]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from . import add_device_arg, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train_pose_model")
    ap.add_argument("dataset")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--models-dir", default="data/models")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..pipeline.pose_training import (load_coco_pose_dataset,
                                          train_pose_model)
    images, boxes, kpts = load_coco_pose_dataset(
        Path(args.dataset), img_size=args.img_size, limit=args.limit,
        device=device)
    print(f"dataset: {len(images)} images, {kpts.shape[1]} keypoints")
    report = train_pose_model(images, boxes, kpts,
                              models_dir=Path(args.models_dir),
                              epochs=args.epochs,
                              batch_size=args.batch_size,
                              img_size=args.img_size, lr=args.lr,
                              num_kpts=kpts.shape[1], device=device)
    print(f"{report['status']}: final loss {report['final_loss']:.4f}")
    print(f"checkpoint: {args.models_dir}/pose/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
