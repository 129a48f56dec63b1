"""Analyze the walking-direction balance of a pose dataset (port of
``scripts/analyze_training_orientation.py``).

Lameness clips are normalised left -> right (curation flips right -> left
passes), so a pose model trained on one orientation fails on the other.
Each annotation's facing is inferred from head-vs-rear keypoint x
positions; the left/right balance is reported, and ``--fix`` flips copies
of the majority orientation (prepare_pose_dataset's ``flip_augment``, on
``--device``) until the counts meet:

  python -m lameness_tpu_torch.tools.analyze_training_orientation DATASET [--fix]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..models.pose import OLD_NAMES
from . import add_device_arg, device_of

_IDX = {n: i for i, n in enumerate(OLD_NAMES)}
HEAD = [_IDX["nose"], _IDX["throat"], _IDX["left_eye"], _IDX["right_eye"]]
REAR = [_IDX["tailbase"], _IDX["left_back_elbow"], _IDX["right_back_elbow"]]


def facing(kpts: np.ndarray) -> str:
    """'right' if the head is to the right of the rear (walking ->)."""
    k = kpts.reshape(-1, 3)
    head = [k[i, 0] for i in HEAD if i < len(k) and k[i, 2] > 0]
    rear = [k[i, 0] for i in REAR if i < len(k) and k[i, 2] > 0]
    if not head or not rear:
        return "unknown"
    return "right" if np.mean(head) > np.mean(rear) else "left"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="analyze_training_orientation")
    ap.add_argument("dataset")
    ap.add_argument("--fix", action="store_true",
                    help="flip-augment the minority orientation in place")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    root = Path(args.dataset)
    doc = json.load(open(root / "annotations.json"))
    counts = {"left": 0, "right": 0, "unknown": 0}
    by_img = {}
    for a in doc["annotations"]:
        f = facing(np.asarray(a["keypoints"], np.float32))
        counts[f] += 1
        by_img[a["image_id"]] = f

    total = max(counts["left"] + counts["right"], 1)
    print(f"orientation balance over {len(doc['annotations'])} annotations:")
    for k in ("left", "right", "unknown"):
        bar = "#" * int(40 * counts[k] / max(total, 1))
        print(f"  facing {k:<8} {counts[k]:5d}  {bar}")
    minority = "left" if counts["left"] < counts["right"] else "right"
    imbalance = abs(counts["left"] - counts["right"]) / total
    print(f"\nimbalance: {imbalance:.0%} (minority: facing {minority})")
    if imbalance > 0.3:
        print("WARNING: >30% imbalance — the model will generalize poorly "
              "to the minority direction. The canonical-clip pipeline "
              "normalizes to left->right walks (flips right->left passes), "
              "so bias training data the same way or --fix.")
    if not args.fix:
        return 0

    # balance by flipping copies of MAJORITY-facing images until the
    # counts meet: each flip adds one minority-facing sample
    from .prepare_pose_dataset import flip_augment
    majority = "right" if minority == "left" else "left"
    need = counts[majority] - counts[minority]
    keep_ids = set()
    for i, f in by_img.items():
        if f == majority and len(keep_ids) < need:
            keep_ids.add(i)
    entries = [e for e in doc["images"] if e["id"] in keep_ids]
    anns = [a for a in doc["annotations"] if a["image_id"] in keep_ids]
    if not entries:
        print("nothing to flip")
        return 0
    new_entries, new_anns = flip_augment(entries, anns, root / "images",
                                         device)
    added_e = [e for e in new_entries if e not in entries]
    added_a = [a for a in new_anns if a not in anns]
    # re-id against the full doc
    next_img = max(e["id"] for e in doc["images"]) + 1
    next_ann = max(a["id"] for a in doc["annotations"]) + 1
    remap = {}
    for e in added_e:
        remap[e["id"]] = next_img
        e["id"] = next_img
        next_img += 1
    for a in added_a:
        a["image_id"] = remap[a["image_id"]]
        a["id"] = next_ann
        next_ann += 1
    doc["images"] += added_e
    doc["annotations"] += added_a
    json.dump(doc, open(root / "annotations.json", "w"))
    print(f"added {len(added_e)} flipped images; re-run to verify balance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
