"""Collect pose-annotation frames from farm videos, headless (port of
``scripts/collect_cow_pose_data.py``):

1. ``extract``: sample frames from the videos under the data root
   (``.y4m`` and mp4v ``.mp4``; other codecs through an ``ffmpeg`` binary),
   find the cow with the motion detector (MOG2 on ``--device``), and write ``frames/*.jpg`` (the
   port's JPEG encoder) plus a ``manifest.json`` with each frame's box and
   a heuristic 20-keypoint prefill, so annotators adjust rather than place.
2. ``import``: read back the hand-corrected manifest and write the
   ``annotations.json`` + ``images/`` directory that
   ``pipeline/pose_training.load_coco_pose_dataset`` reads.

  python -m lameness_tpu_torch.tools.collect_cow_pose_data extract --data DIR --out SESS [--per-video 6]
  python -m lameness_tpu_torch.tools.collect_cow_pose_data import SESS --out DATASET
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from . import add_device_arg, device_of


def extract(args):
    from ..core.config import Config
    from ..models.pose import heuristic_keypoints
    from ..video.curation import motion_detector
    from ..video.decode import VideoReader
    from ..video.image import imwrite

    device = device_of(args)
    cfg = Config.load(data_root=args.data) if args.data else None
    videos_dir = Path(cfg.dirs.videos if cfg else args.data or "data/videos")
    out = Path(args.out)
    (out / "frames").mkdir(parents=True, exist_ok=True)

    detector = motion_detector(device=device)
    manifest = []
    videos = sorted([*videos_dir.glob("*.y4m"),
                     *videos_dir.glob("*.mp4")])[:args.max_videos]
    if not videos:
        print(f"no videos under {videos_dir}")
        return
    for vp in videos:
        with VideoReader(vp, device=device) as reader:
            total = int(reader.info["total_frames"])
            picks = np.linspace(0, max(total - 1, 0), args.per_video,
                                dtype=int)
            frames = reader.read_selected(picks)
        for fi in picks:
            frame = frames.get(int(fi))
            if frame is None:
                continue
            det = detector(frame[..., ::-1])
            if det is None:
                continue
            bbox = [float(v) for v in det["bbox"]]
            name = f"{vp.stem}_{fi:05d}.jpg"
            imwrite(out / "frames" / name, frame, device=device)
            manifest.append({
                "image": name, "video": vp.name, "frame": int(fi),
                "width": frame.shape[1], "height": frame.shape[0],
                "bbox_xyxy": bbox,
                # heuristic prefill — annotators correct, not place
                "keypoints": heuristic_keypoints(bbox),
                "reviewed": False,
            })
    json.dump({"session": out.name, "frames": manifest},
              open(out / "manifest.json", "w"), indent=1)
    print(f"extracted {len(manifest)} frames from {len(videos)} videos "
          f"-> {out}/manifest.json")
    print("annotate by editing keypoint x/y/confidence and setting "
          "reviewed=true, then run the import step")


def import_session(args):
    from ..models.pose import OLD_NAMES
    sess = Path(args.session)
    doc = json.load(open(sess / "manifest.json"))
    out = Path(args.out)
    (out / "images").mkdir(parents=True, exist_ok=True)
    entries, anns = [], []
    for rec in doc["frames"]:
        if args.reviewed_only and not rec.get("reviewed"):
            continue
        src = sess / "frames" / rec["image"]
        if not src.exists():
            continue
        img_id = len(entries) + 1
        shutil.copy2(src, out / "images" / rec["image"])
        entries.append({"id": img_id, "file_name": rec["image"],
                        "width": rec["width"], "height": rec["height"]})
        x1, y1, x2, y2 = rec["bbox_xyxy"]
        kpts = []
        for kp in rec["keypoints"]:
            kpts += [kp["x"], kp["y"],
                     2.0 if kp.get("confidence", 0) > 0 else 0.0]
        anns.append({"id": img_id, "image_id": img_id, "category_id": 1,
                     "bbox": [x1, y1, x2 - x1, y2 - y1],
                     "keypoints": kpts, "num_keypoints": 20})
    json.dump({"images": entries, "annotations": anns,
               "categories": [{"id": 1, "name": "cow",
                               "keypoints": OLD_NAMES}]},
              open(out / "annotations.json", "w"))
    print(f"imported {len(entries)} annotated frames -> {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="collect_cow_pose_data")
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("extract")
    e.add_argument("--data", help="data root (default data/)")
    e.add_argument("--out", required=True)
    e.add_argument("--per-video", dest="per_video", type=int, default=6)
    e.add_argument("--max-videos", dest="max_videos", type=int, default=50)
    add_device_arg(e)
    i = sub.add_parser("import")
    i.add_argument("session")
    i.add_argument("--out", required=True)
    i.add_argument("--reviewed-only", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "extract":
        extract(args)
    else:
        import_session(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
