"""Prepare a cow pose-training dataset in this framework's format (port of
``scripts/prepare_pose_dataset.py``).

Converts the reference's three dataset layouts (Animal-Pose, COCO-keypoints
such as AP-10K, ultralytics YOLO-pose) into the single COCO-keypoints
``annotations.json`` + ``images/`` directory that
``pipeline/pose_training.load_coco_pose_dataset`` reads:

  python -m lameness_tpu_torch.tools.prepare_pose_dataset animal-pose SRC --out OUT
  python -m lameness_tpu_torch.tools.prepare_pose_dataset coco ann.json IMAGES --out OUT
  python -m lameness_tpu_torch.tools.prepare_pose_dataset yolo-pose DATASET --out OUT

Keypoints are remapped into the 20-slot old-name layout, missing slots
padded with visibility 0; ``--flip-augment`` doubles the set with
horizontal flips and left/right keypoint swaps, each flipped image decoded
and re-encoded by the port's codec (``video/image.py``) on ``--device``.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ..models.pose import OLD_NAMES
from ..video.image import image_size, imread, imwrite
from . import add_device_arg, device_of

NUM_KPTS = 20

# AP-10K 17-keypoint order -> our 20-slot indices (unmatched -> None)
AP10K_NAMES = [
    "left_eye", "right_eye", "nose", "neck", "tail_root",
    "left_shoulder", "left_elbow", "left_front_paw",
    "right_shoulder", "right_elbow", "right_front_paw",
    "left_hip", "left_knee", "left_back_paw",
    "right_hip", "right_knee", "right_back_paw",
]
AP10K_TO_OLD = {
    "left_eye": "left_eye", "right_eye": "right_eye", "nose": "nose",
    "neck": "throat", "tail_root": "tailbase",
    "left_elbow": "left_front_elbow", "right_elbow": "right_front_elbow",
    "left_front_paw": "left_front_paw", "right_front_paw": "right_front_paw",
    "left_knee": "left_back_knee", "right_knee": "right_back_knee",
    "left_back_paw": "left_back_paw", "right_back_paw": "right_back_paw",
    "left_shoulder": "left_front_knee", "right_shoulder": "right_front_knee",
    "left_hip": "left_back_elbow", "right_hip": "right_back_elbow",
}
OLD_IDX = {n: i for i, n in enumerate(OLD_NAMES)}

# left<->right swap pairs for flip augmentation (old-name set)
_FLIP_PAIRS = [(OLD_IDX[l], OLD_IDX[l.replace("left", "right")])
               for l in OLD_NAMES if l.startswith("left")]


def _entry(img_id, fname, w, h):
    return {"id": img_id, "file_name": fname, "width": w, "height": h}


def _ann(ann_id, img_id, bbox_xywh, kpts):
    return {"id": ann_id, "image_id": img_id, "category_id": 1,
            "bbox": [float(v) for v in bbox_xywh],
            "keypoints": [float(v) for v in np.asarray(kpts).ravel()],
            "num_keypoints": int((np.asarray(kpts)[:, 2] > 0).sum())}


def convert_animal_pose(src: Path, out_images: Path, cow_category: int = 5):
    """Animal-Pose part-1 layout: keypoints.json with per-animal entries
    (the reference filters category==cow, prepare_cow_pose_dataset.py)."""
    data = json.load(open(src / "keypoints.json"))
    images = {int(k): v for k, v in data["images"].items()} \
        if isinstance(data["images"], dict) else \
        {im["id"]: im["file_name"] for im in data["images"]}
    entries, anns = [], []
    next_img = 1
    seen = {}
    for a in data["annotations"]:
        if int(a.get("category_id", -1)) != cow_category:
            continue
        fname = images.get(a["image_id"])
        if fname is None:
            continue
        f = src / "images" / fname
        if not f.exists():
            continue
        if fname not in seen:
            w, h = image_size(f)
            seen[fname] = next_img
            entries.append(_entry(next_img, fname, w, h))
            shutil.copy2(f, out_images / fname)
            next_img += 1
        k = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        if k.shape[0] != NUM_KPTS:     # pad/truncate to 20
            padded = np.zeros((NUM_KPTS, 3), np.float32)
            padded[:min(NUM_KPTS, k.shape[0])] = k[:NUM_KPTS]
            k = padded
        x1, y1, x2, y2 = a["bbox"]
        anns.append(_ann(len(anns) + 1, seen[fname],
                         [x1, y1, x2 - x1, y2 - y1], k))
    return entries, anns


def convert_coco(ann_file: Path, images_dir: Path, out_images: Path,
                 names=None):
    """Generic COCO keypoints (AP-10K etc.): remap by keypoint NAME into
    the 20-slot old-name layout, zero-padding missing slots (the
    reference's combined-dataset padding strategy)."""
    data = json.load(open(ann_file))
    cat = data["categories"][0]
    names = names or cat.get("keypoints", AP10K_NAMES)
    mapping = [OLD_IDX.get(AP10K_TO_OLD.get(n, n)) for n in names]
    imgs = {im["id"]: im for im in data["images"]}
    entries, anns, seen = [], [], {}
    for a in data["annotations"]:
        meta = imgs.get(a["image_id"])
        if meta is None:
            continue
        f = Path(images_dir) / meta["file_name"]
        if not f.exists():
            continue
        if a["image_id"] not in seen:
            seen[a["image_id"]] = len(seen) + 1
            entries.append(_entry(seen[a["image_id"]], meta["file_name"],
                                  meta["width"], meta["height"]))
            shutil.copy2(f, out_images / meta["file_name"])
        src_k = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        k = np.zeros((NUM_KPTS, 3), np.float32)
        for si, di in enumerate(mapping):
            if di is not None and si < src_k.shape[0]:
                k[di] = src_k[si]
        anns.append(_ann(len(anns) + 1, seen[a["image_id"]],
                         a["bbox"], k))
    return entries, anns


def convert_yolo_pose(root: Path, out_images: Path):
    """ultralytics YOLO-pose layout (images/ + labels/*.txt with
    normalized cx cy w h + k*(x y v)) -> COCO json."""
    entries, anns = [], []
    img_dir = root / "images"
    lbl_dir = root / "labels"
    for i, f in enumerate(sorted(img_dir.glob("*.*")), start=1):
        lbl = lbl_dir / (f.stem + ".txt")
        if not lbl.exists():
            continue
        w, h = image_size(f)
        entries.append(_entry(i, f.name, w, h))
        shutil.copy2(f, out_images / f.name)
        for line in open(lbl):
            vals = [float(v) for v in line.split()]
            if len(vals) < 5:
                continue
            _, cx, cy, bw, bh = vals[:5]
            kv = np.asarray(vals[5:], np.float32).reshape(-1, 3)
            k = np.zeros((NUM_KPTS, 3), np.float32)
            n = min(NUM_KPTS, kv.shape[0])
            k[:n, 0] = kv[:n, 0] * w
            k[:n, 1] = kv[:n, 1] * h
            k[:n, 2] = (kv[:n, 2] > 0).astype(np.float32)
            anns.append(_ann(len(anns) + 1, i,
                             [(cx - bw / 2) * w, (cy - bh / 2) * h,
                              bw * w, bh * h], k))
    return entries, anns


def flip_augment(entries, anns, images_dir: Path, device=None):
    """Double the dataset with horizontal flips (left/right kp swap); each
    image is decoded, flipped and re-encoded on ``device`` (the card unless
    ``"cpu"``)."""
    img_w = {e["id"]: e["width"] for e in entries}
    new_entries, new_anns = list(entries), list(anns)
    id_map = {}
    next_img = max(e["id"] for e in entries) + 1
    for e in entries:
        src = images_dir / e["file_name"]
        flipped_name = "flip_" + e["file_name"]
        im = imread(src, device)
        imwrite(images_dir / flipped_name, im.flip(1), device=device)
        id_map[e["id"]] = next_img
        new_entries.append(_entry(next_img, flipped_name,
                                  e["width"], e["height"]))
        next_img += 1
    next_ann = max(a["id"] for a in anns) + 1
    for a in anns:
        w = img_w[a["image_id"]]
        k = np.asarray(a["keypoints"], np.float32).reshape(-1, 3).copy()
        vis = k[:, 2] > 0
        k[vis, 0] = w - k[vis, 0]
        for li, ri in _FLIP_PAIRS:
            k[[li, ri]] = k[[ri, li]]
        x, y, bw, bh = a["bbox"]
        new_anns.append(_ann(next_ann, id_map[a["image_id"]],
                             [w - x - bw, y, bw, bh], k))
        next_ann += 1
    return new_entries, new_anns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prepare_pose_dataset")
    ap.add_argument("source", choices=("animal-pose", "coco", "yolo-pose"))
    ap.add_argument("paths", nargs="+",
                    help="animal-pose/yolo-pose: dataset dir; "
                         "coco: annotations.json images_dir")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--flip-augment", action="store_true")
    ap.add_argument("--val-frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    out = args.out
    (out / "images").mkdir(parents=True, exist_ok=True)
    if args.source == "animal-pose":
        entries, anns = convert_animal_pose(Path(args.paths[0]),
                                            out / "images")
    elif args.source == "coco":
        entries, anns = convert_coco(Path(args.paths[0]),
                                     Path(args.paths[1]), out / "images")
    else:
        entries, anns = convert_yolo_pose(Path(args.paths[0]),
                                          out / "images")
    if args.flip_augment and entries:
        entries, anns = flip_augment(entries, anns, out / "images", device)

    rng = np.random.default_rng(args.seed)
    img_ids = [e["id"] for e in entries]
    rng.shuffle(img_ids)
    n_val = int(len(img_ids) * args.val_frac)
    val_ids = set(img_ids[:n_val])
    doc = {"images": entries,
           "annotations": anns,
           "categories": [{"id": 1, "name": "cow",
                           "keypoints": OLD_NAMES,
                           "num_keypoints": NUM_KPTS}],
           "val_image_ids": sorted(val_ids)}
    json.dump(doc, open(out / "annotations.json", "w"))
    print(f"wrote {len(entries)} images / {len(anns)} annotations "
          f"({n_val} val) -> {out}")
    print(f"train with: python -m lameness_tpu_torch.tools.train_pose_model "
          f"{out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
