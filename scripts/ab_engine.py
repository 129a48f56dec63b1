#!/usr/bin/env python3
"""Hold the full-width engine's outputs of two checkouts against each other
on one card.

    python scripts/ab_engine.py ROOT_A ROOT_B [SAM_VARIANT]

ROOT_A and ROOT_B are repository roots (e.g. an unpacked ``git archive`` of
the parent commit, and ``.``).  Each root runs, in a process of its own,
the default engine of ``chip_smoke.py`` (``EngineSpec()``, ``Config()``,
weights seeded with 0; SAM_VARIANT, e.g. ``vit_h``, builds SAM at that
variant instead of ViT-B) on the same B = 2 seeded 720p clips of 125 frames,
and saves its outputs under ``lameness_tpu_torch/_build/ab_engine/`` of
this script's checkout.  The script then prints, for B against A: the share
of mask pixels that agree, the relative L2 distance of the DINO embeddings
(``embeddings``), which outputs are equal bit for bit, and the largest
|B - A| of each of the others.  The card's name
and power limit come first.  The roots run in the turns A B B A, each
printing its end-to-end seconds of REPEATS batches after one warm batch
and the device busy ms of one batch (torch.profiler), so that the two are
compared on one card in one call.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

BATCH = 2
SEED = 0
REPEATS = 5
SAVED = Path(__file__).resolve().parents[1] / "lameness_tpu_torch" / \
    "_build" / "ab_engine"


def leaves(tree, prefix=""):
    """The output dict flattened (``locomotion`` is a dict of its own)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(val)


def worker(root: str, saved: str, variant: str) -> None:
    sys.path.insert(0, root)
    import torch
    from lameness_tpu_torch.core.config import Config, SamConfig
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = LamenessEngine(Config(sam=SamConfig(variant=variant)), EngineSpec(),
                         generator=torch.Generator().manual_seed(SEED))
    s = eng.spec
    frames = np.random.default_rng(SEED).integers(
        0, 256, (BATCH, s.clip_frames, s.frame_height, s.frame_width, 3),
        dtype=np.uint8)
    out = eng.process_clip_batch(
        frames, generator=torch.Generator(device="cuda").manual_seed(SEED))
    np.savez(saved, **dict(leaves(out)))
    import time
    from torch.profiler import ProfilerActivity, profile
    e2e = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.process_clip_batch(frames)
        torch.cuda.synchronize()
        e2e.append(round(time.perf_counter() - t0, 4))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.process_clip_batch(frames)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(json.dumps({"e2e_s": e2e, "device_busy_ms": busy}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        return 0
    roots = {"A": sys.argv[1], "B": sys.argv[2]}
    variant = sys.argv[3] if len(sys.argv) > 3 else "vit_b"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"SAM {variant}", flush=True)
    SAVED.mkdir(parents=True, exist_ok=True)
    outs = {}
    for turn in "ABBA":
        path = SAVED / f"{turn}.npz"
        res = subprocess.run([sys.executable, __file__, "--worker",
                              roots[turn], str(path), variant],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(f"turn {turn}: {res.stdout.strip().splitlines()[-1]}",
              flush=True)
        outs.setdefault(turn, dict(np.load(path)))
    a, b = outs["A"], outs["B"]
    if set(a) != set(b):
        print(f"output keys differ: {sorted(set(a) ^ set(b))}")
        return 1
    masks = float((a["masks"] == b["masks"]).mean())
    emb_a, emb_b = (x["embeddings"].astype(np.float64) for x in (a, b))
    rel = float(np.linalg.norm(emb_b - emb_a) / np.linalg.norm(emb_a))
    same = sorted(k for k in a if np.array_equal(a[k], b[k]))
    diff = {k: float(np.abs(b[k].astype(np.float64)
                            - a[k].astype(np.float64)).max())
            for k in sorted(set(a) - set(same))}
    print(f"B against A: mask agreement {masks:.6f}; DINO embeddings "
          f"relative L2 {rel:.3e}; equal bit for bit: {same}; differing, "
          f"max |B - A|: {json.dumps(diff)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
