#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 9a (DetectTrainer, YOLOv8-n at 640, batch
16, on square cows) several times on one card, and record each run's path.

    python scripts/detector_runs.py '[{"name": "base", "runs": 6}, ...]'

Each arm is a dict: ``name``, ``runs``, and optional ``lr`` (default
``chip_smoke.DET_LR``), ``warmup`` and ``final`` (``chip_smoke.det_schedule``'s
ramp and fall; without them the rate is ``lr`` throughout) and
``deterministic`` (``torch.use_deterministic_algorithms(True,
warn_only=True)`` for the arm).  Every run starts from 9a's seeded weights
and draws 9a's batches (the generator's state after ``square_cows``), so
runs of one arm differ only by the card's unordered sums.  A run records, per step, the loss parts and the number of
foreground anchors the assigner chose (``n_fg``; 16 ground truths a batch),
and every 25 steps the largest cow probability on a fixed batch.  At its end
the EMA weights (what 9a saves) and the live weights are each installed in
the default engine and scored as 9a scores them: the detect frames of a
walking clip whose cow is found.  A line a run is printed; every run's whole
record goes to ``chiprun_out/detector_runs.json``.  The card's name and
power limit come first.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out" / "detector_runs.json"
SPIKE = 30.0        # a step's loss above this is a spike (it starts at 13)


def one_run(cs, eng, data, arm) -> dict:
    import torch
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.pipeline.checkpoint import (restore_engine,
                                                        save_params)
    from lameness_tpu_torch.pipeline.detect_training import (
        DetectTrainer, flatten_levels)
    from lameness_tpu_torch.weights import seeded_state_dict
    images, labels, gt, mask, clip, truth, state = data
    lr = arm.get("lr", cs.DET_LR)
    steps = cs.DET_STEPS
    sched = "warmup" in arm or "final" in arm
    torch.use_deterministic_algorithms(bool(arm.get("deterministic")),
                                       warn_only=True)
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    model = YoloV8("n", num_classes=eng.config.yolo.num_classes)
    model.load_state_dict(seeded_state_dict(
        model, torch.Generator().manual_seed(cs.SEED)))
    cs.detect_bias_init(model)
    trainer = DetectTrainer(model, lr=cs.det_schedule(
        lr, arm.get("warmup", 0), arm.get("final", 1.0)) if sched else lr)
    cow = eng.config.yolo.cow_class_id
    probe = torch.arange(cs.DET_BATCH, device="cuda")
    parts, cow_p = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.from_numpy(rng.permutation(cs.DET_FRAMES)[:cs.DET_BATCH]
                               ).cuda()
        aux = trainer.train_step(images[idx], labels[idx], gt[idx], mask[idx])
        parts.append([aux[k] for k in ("total", "box", "cls", "dfl",
                                       "n_fg")])
        if i % 25 == 0 or i == steps - 1:
            with torch.no_grad():
                fp = flatten_levels(model(images[probe])["levels"])
                cow_p.append(float(torch.sigmoid(fp.cls_logits[..., cow])
                                   .amax(1).min()))
    wall = time.perf_counter() - t0
    bn_var = min(float(p.detach().min()) for n, p in model.named_parameters()
                 if n.endswith(".var"))
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which, sd in (("ema", trainer.ema_params),
                          ("live", trainer.params)):
            save_params(f"{tmp}/{which}", "yolo", sd)
            restore_engine(eng, f"{tmp}/{which}")
            out = eng.process_clip_batch(clip[None])
            found[which] = int(sum(cs.cow_found(eng, out, truth)))
    p = np.asarray(parts)
    return {"arm": arm["name"], "lr": lr, "steps": steps,
            "warmup": arm.get("warmup"), "final": arm.get("final"),
            "deterministic": bool(arm.get("deterministic")),
            "wall_s": wall, "found_ema": found["ema"],
            "found_live": found["live"], "detect_frames": len(eng.spec.det_idx),
            "loss_first10": float(p[:10, 0].mean()),
            "loss_last10": float(p[-10:, 0].mean()),
            "min_bn_var": bn_var, "cow_p_min_over_batch": cow_p,
            "parts": p.tolist()}


def main() -> int:
    import torch
    import chip_smoke as cs
    from lameness_tpu_torch.ops import _cuda
    from lameness_tpu_torch.ops import preprocess as prep
    arms = json.loads(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build(["attention", "sam_window_attention", "sam_global_attention"])
    eng = cs.default_engine()
    rng = np.random.default_rng(cs.SEED + 9)
    frames, boxes = cs.square_cows(rng, cs.DET_FRAMES)
    images, r, pad = prep.letterbox(torch.from_numpy(frames).cuda(),
                                    eng.spec.yolo_size)
    shift = torch.cat([pad, pad], dim=-1)
    gt = torch.zeros((cs.DET_FRAMES, 2, 4), device="cuda")
    gt[:, 0] = torch.from_numpy(boxes).cuda() * r[:, None] + shift
    labels = torch.full((cs.DET_FRAMES, 2), eng.config.yolo.cow_class_id,
                        dtype=torch.long, device="cuda")
    mask = torch.zeros((cs.DET_FRAMES, 2), dtype=torch.bool, device="cuda")
    mask[:, 0] = True
    clip, truth = cs.walking_square_clip()
    data = (images, labels, gt, mask, clip, truth, rng.bit_generator.state)
    runs = []
    for arm in arms:
        for k in range(arm["runs"]):
            rec = one_run(cs, eng, data, arm)
            p = np.asarray(rec["parts"])
            spikes = np.nonzero(p[:, 0] > SPIKE)[0]
            print(f"{arm['name']} run {k}: loss {rec['loss_first10']:.4g} -> "
                  f"{rec['loss_last10']:.4g}; cow found ema "
                  f"{rec['found_ema']}, live {rec['found_live']}; n_fg "
                  f"at steps 0/50/100/200/last "
                  f"{[int(p[i, 4]) for i in (0, 50, 100, 200, -1)]}; "
                  f"cow p (min over batch) every 25 steps "
                  f"{[round(x, 3) for x in rec['cow_p_min_over_batch']]}; "
                  f"steps with loss > {SPIKE:g} {spikes.tolist()} (largest "
                  f"{p[:, 0].max():.4g}); "
                  f"min BN var {rec['min_bn_var']:.3g}; "
                  f"{rec['wall_s']:.1f} s", flush=True)
            runs.append(rec)
            OUT.parent.mkdir(exist_ok=True)
            OUT.write_text(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
