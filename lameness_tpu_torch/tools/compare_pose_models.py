"""Compare pose estimators on a labeled validation set (port of
``scripts/compare_pose_models.py``): one or more trained checkpoints
(``<models dir>/pose/params.torch``, as ``train_pose_model`` writes them)
and the anatomical heuristic baseline (``models/pose.heuristic_keypoints``).
Reports OKS, PCK@0.1 and PCK@0.2 (normalised by the box diagonal) per
model, and the winner's mean error per keypoint:

  python -m lameness_tpu_torch.tools.compare_pose_models DATASET \\
      --model data/models --model other/models --img-size 320 [--limit N]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import add_device_arg, device_of


def _pose_metrics(pred_xy, gt, boxes):
    """pred_xy/gt: (N, K, 2)/(N, K, 3) pixel coords; boxes (N, 4) xyxy."""
    vis = gt[:, :, 2] > 0
    d = np.linalg.norm(pred_xy - gt[:, :, :2], axis=-1)        # (N, K)
    diag = np.linalg.norm(boxes[:, 2:] - boxes[:, :2], axis=-1)  # (N,)
    dn = d / np.maximum(diag[:, None], 1e-6)
    # OKS with uniform per-keypoint sigma 0.05 (area = box area)
    area = np.prod(np.maximum(boxes[:, 2:] - boxes[:, :2], 1), axis=-1)
    oks_e = np.exp(-d ** 2 / (2 * area[:, None] * (2 * 0.05) ** 2))
    n = np.maximum(vis.sum(), 1)
    return {
        "oks": float((oks_e * vis).sum() / n),
        "pck@0.1": float(((dn < 0.1) & vis).sum() / n),
        "pck@0.2": float(((dn < 0.2) & vis).sum() / n),
        "mean_err_px": float((d * vis).sum() / n),
        "per_kpt_err": (d * vis).sum(0) / np.maximum(vis.sum(0), 1),
    }


def compare(dataset: Path, models: List[str], img_size: int, limit: int,
            device) -> Dict[str, Dict]:
    """{candidate: metrics}: the heuristic, then each models dir with a
    pose checkpoint (run on ``device``)."""
    from ..models import pose as pose_mod
    from ..models.yolo import YoloV8, detect
    from ..pipeline.checkpoint import load_params
    from ..pipeline.pose_training import load_coco_pose_dataset

    images, boxes, kpts = load_coco_pose_dataset(
        dataset, img_size=img_size, limit=limit, device=device)
    print(f"val set: {len(images)} images @ {img_size}²")

    results = {}
    # heuristic baseline (reference tleap:199-265 fallback)
    heur = np.stack([
        np.asarray([[kp["x"], kp["y"]] for kp in
                    pose_mod.heuristic_keypoints(list(b))])
        for b in boxes])
    results["heuristic"] = _pose_metrics(heur, kpts, boxes)

    for mdir in models:
        sd = load_params(Path(mdir), "pose")
        if sd is None:
            print(f"!! no pose checkpoint under {mdir}, skipping")
            continue
        model = YoloV8(variant="n", num_classes=1,
                       num_keypoints=kpts.shape[1], device=device)
        model.load_state_dict(sd)
        model.eval()
        preds = []
        x = torch.from_numpy(images.astype(np.float32) / 255.0).to(device)
        with torch.no_grad():
            for i in range(0, len(x), 16):
                out = detect(model(x[i:i + 16])["levels"],
                             conf_threshold=0.05, max_det=1)
                preds.append(out["keypoints"][:, 0, :, :2].cpu().numpy())
        results[str(mdir)] = _pose_metrics(
            np.concatenate(preds), kpts, boxes)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compare_pose_models")
    ap.add_argument("dataset")
    ap.add_argument("--model", action="append", default=[],
                    help="models dir containing pose/ checkpoint "
                         "(repeatable); heuristic baseline always runs")
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("--limit", type=int, default=64)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    from ..models.pose import OLD_NAMES

    results = compare(Path(args.dataset), args.model, args.img_size,
                      args.limit, device_of(args))
    name_w = max(len(n) for n in results)
    print(f"\n{'model':<{name_w}}  {'OKS':>6}  {'PCK@.1':>7}  "
          f"{'PCK@.2':>7}  {'err px':>7}")
    best = max(results, key=lambda n: results[n]["oks"])
    for n, m in sorted(results.items(), key=lambda kv: -kv[1]["oks"]):
        mark = " *" if n == best else ""
        print(f"{n:<{name_w}}  {m['oks']:6.3f}  {m['pck@0.1']:7.3f}  "
              f"{m['pck@0.2']:7.3f}  {m['mean_err_px']:7.1f}{mark}")
    print(f"\nper-keypoint mean error (px) for {best}:")
    for i, name in enumerate(OLD_NAMES[:len(results[best]["per_kpt_err"])]):
        print(f"  {name:<22} {results[best]['per_kpt_err'][i]:7.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
