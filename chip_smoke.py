#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lameness_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing loudly (no exception is swallowed):
  1. setup: card name and power limit, versions, TF32 off, build the
     kernels from csrc/ with nvcc (one process per source, in parallel);
     per library the registers and spills ptxas reports and the HGMMA
     (wgmma) instructions in its SASS -- those of K1 (its Hopper routine)
     and of K3, K4, K5 and K6 (one Hopper routine) must have them -- and
     each instantiation of the Hopper global routine (hd 64 and 80) with
     its registers, spills and whether ptxas serialised its wgmma;
  2. kernels: K1-K9 against their plain PyTorch versions at the engine's
     shapes, in float32 and bfloat16, with device times (torch.profiler)
     beside the bound, the plain version's and a PyTorch library call's as
     yardsticks (the library call timed by the profiler and by CUDA
     events, as is each entry's whole call); the entries of K1-K9 must put
     nothing on the card but their kernel; K3, K4 and K5 must give the
     same bf16 output bit for bit at the engine's shapes (one routine on
     one set of operands), K6 on
     head-last views the same as K3 on head-major copies of the values,
     and K8 the same as K7, K9 the same as K2 (one window routine);
  3. engine: a small engine on the card against the same engine's plain
     path on the CPU (same weights, same frames), under each kernel
     selection; then the full-width engine (YOLOv8-n 640, SAM ViT-B 1024²,
     DINOv2 ViT-B/14 224, TCN + GaitTransformer) on B seeded synthetic 720p
     clips of 125 frames, by default (K1, K2, K3) and under the switches
     LAMENESS_WIN_KERNEL / LAMENESS_GLB_KERNEL = v1/v1 (K7, K4), v2/v2 (K8,
     K5) and v5/v3 (K9, K6).  Each run reports its launch counts (held
     against the expected ones), end-to-end times and a torch.profiler
     breakdown of one batch (device busy share, device time by kernel and
     by launching op); the default run its stage times too, and each other
     selection its agreement with the default run (masks, SAM embeddings,
     and whether its outputs equal the default's bit for bit).
  4. serving modes: the phase-3 default engine through ``with_spec`` (same
     modules, weights and frames) under pose_pixels=False, split ingest
     1280x720+640x360 with pose_pixels=False, LAMENESS_YUV_INGEST=1, the
     rect SAM canvas and sam_encode_chunk=4, each with its launches (held
     against the expected ones), e2e times, transfer (in and out) and
     stage times, device busy of one profiled batch and peak memory, and
     its gate against the default run; the tiny engine, card against CPU,
     under the same modes; K3 at the rect canvas's shape beside its bound
     and an SDPA call.
  5. checkpoints: (a) the phase-3 engine's ``process_clip_batch`` of its
     own ``to_device`` output (packed, and the split dict) bit for bit the
     host path's, with no second transfer; (b) a default engine with a
     seeded trained pose model and its YOLO written as ultralytics ``.pt``
     files and installed by ``restore_engine``: hits and misses, detect,
     SAM and DINO bit for bit the default run's, its record; the tiny
     engine with trained pose, card against CPU, full and split ingest;
     (c) the engine at SAM ViT-H (16 heads of 80) with seeded weights, by
     default (K2, K3) and under v1/v1 (K7, K4), v2/v2 (K8, K5) and v5/v3
     (K9, K5: hd + 64 > 128), each against the default, its record; K2,
     K3, K4, K5, K7, K8 and K9 at ViT-H's shapes, each launching its
     routine alone (K2, K7, K8 and K9 the window routine's hd-80 kernel,
     K3, K4 and K5 the Hopper global routine's, and equal bit for bit),
     against their plain versions beside their bounds and SDPA; and the
     tiny engine with a SAM at head dim 80, card against CPU.
  6. serving: the default engine (phase 3's weights) with YOLO's cow class
     set to find a synthetic cow (``calibrate_yolo``: seeded weights find
     nothing); (a) the batched curation detector over a 125-frame 720p
     clip at chunks 16 and 48 in bf16 (frames/s, copy in a chunk,
     dispatches), and in f32 on the card against the CPU (the None
     pattern; every anchor's box and score before NMS); (b)
     ``PipelineDriver.process_stream`` over 32 jobs of 8 in-memory 720p
     clips at B = 4, 2 and 8 (clips/s, the stage timers, launches = the
     batches times phase 3's, six valid result files a clip, peak GB),
     the serial path at B = 2 (its files byte for byte the stream's) and 4,
     the outputs across batch sizes under phase 3's gates, the writer's
     ms a mask, the host's synchronising calls by source line, and one
     profiled stream at B = 4 (busy share of a batch, copies in and out
     overlapped by kernels), beside the same with the engine's constants
     made at each call; (c) the tiny engine's stream, card against CPU.
  7. analysis (the back half of process_video_file, no kernel of its
     own): (a) the graph heads at full width (GraphGPS 128-d, 8 heads, 4
     layers; Graphormer 128-d, 6 layers, 8 heads, FFN 512; max_nodes 128;
     10 MC-dropout samples a head) over 16 cows x 8 written videos, the
     global graph and a per-cow graph: card against CPU (deterministic
     outputs, dropout-0 result files, two MC runs equal, std > 0) and a
     ``graph record`` each (process_video ms, host parts, each forward's ms
     and launches, device busy share, peak MB); (b) run_tracking (host),
     the graph heads, run_ml and fusion over phase 6's videos and over
     4 cows x 8 written walking videos: every file valid, every fusion
     file with the five automated predictors, the stage timers a clip and
     clips/s; on the walks, which ByteTrack confirms, every video tracked,
     Re-ID naming its cow and a per-cow graph; (c) the device tracker, card against
     CPU over phase 6's clips (ids and states equal, boxes within 1e-4), ms
     and launches a clip, and the same confirmed tracks as the host
     ByteTracker on phase 6's walking block.
  8. upload (the front of process_video_file, no kernel of its own): the
     decoder probe (ffmpeg and ffprobe, av, torchvision.io, torchcodec,
     NVDEC); (a) the default engine's ``process_video_file`` over a written
     1280x720, 25 fps, 250-frame ``.y4m`` upload (phase 6's cow block
     walking over a still noise background), with the motion fallback:
     status success, the window inside the cow's frames and unflipped, the
     crop holding the cow's box, every result file written and valid, K1-K3
     at the default engine's counts; with phase 6's calibrated YOLO as
     curation's detector: the cow found on its frames, the files and
     launches (window and crop reported); each run's stage seconds,
     curation frames/s and bytes on disk; MOG2's and the contours' costs; a
     right-to-left upload's curation flipped; (b) the tiny engine's chain
     card against CPU (outputs under check_small_engine's gates, files key
     by key) and MOG2's masks card against CPU.
  9. training (in a process of its own; no kernel of its own: K1's wrapper
     must refuse operands that require grad): (a) DetectTrainer on YOLOv8-n
     at the 640 canvas, batch 16, over letterboxed synthetic square cows:
     the loss falls, the EMA weights go through save_params and
     restore_engine into the default engine, which must find a walking
     cow on most detect frames; (b) train_heads over labelled tleap files:
     completed, tcn and gait restored, the engine's heads give the
     report's train accuracy; (c) train_pose_model at 320, 20 keypoints,
     batch 8, restored into the default (pose_pixels) engine; (d)
     train_graph_heads at the serving widths over 64 labelled videos; (e)
     TrainingService.run_training(cv_folds=2), whose reference files the
     driver's GBDTEnsemble loads and run_ml uses; each with a ``training
     record`` (ms and launches a step, device busy share, peak GB); (f)
     each trainer's two steps at a tiny size, card against CPU (TF32 off).
The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH = 2                  # clips per engine batch on the full-width run
REPEATS = 3                # timed engine runs after warmup
SEED = 0

# float32 / bfloat16 agreement, elementwise |kernel - plain| <= atol +
# rtol·|plain|.  f32: both sum in f32 in other orders (4096-key rows);
# bf16: the output is rounded to bf16 (eps 2^-7), and both round the
# softmax weights to bf16 before PV, the kernel before normalising them
# (on the tensor cores), the plain version after (as the JAX kernels do).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}

# The switches the engine reads at each call (unset unless a run sets them):
# the kernel selections and the I420 transfer.
SWITCHES = ("LAMENESS_WIN_KERNEL", "LAMENESS_GLB_KERNEL",
            "LAMENESS_YUV_INGEST")
# The kernel selections of phase 3: the switches set, and the launches
# expected in one process_clip_batch of B = 2 (every other kernel 0): 12 DINO
# layers; 8 windowed SAM layers, layers 0-1 split into content and shared pad
# windows (10); 4 global layers.
SELECTIONS = (
    ("default", {}, {"K1": 12, "K2": 10, "K3": 4}),
    ("WIN=v1 GLB=v1", {"LAMENESS_WIN_KERNEL": "v1",
                       "LAMENESS_GLB_KERNEL": "v1"},
     {"K1": 12, "K7": 10, "K4": 4}),
    ("WIN=v2 GLB=v2", {"LAMENESS_WIN_KERNEL": "v2",
                       "LAMENESS_GLB_KERNEL": "v2"},
     {"K1": 12, "K8": 10, "K5": 4}),
    ("WIN=v5 GLB=v3", {"LAMENESS_WIN_KERNEL": "v5",
                       "LAMENESS_GLB_KERNEL": "v3"},
     {"K1": 12, "K9": 10, "K6": 4}),
)
# The serving modes of phase 4, run on the phase-3 default engine through
# with_spec: name, the full-width spec's fields, the tiny engine's, the
# switches, and the launches expected in one process_clip_batch of B = 2.
# The rect canvas (576x1024, grid 36x64) has no pad-row split, so its 8
# windowed layers launch K2 once each; chunks of 4 of the 22 SAM frames are
# 6 encoder calls, each with its own pad-row split.
BASE_LAUNCHES = {"K1": 12, "K2": 10, "K3": 4}
MODES = (
    ("pose_pixels=False", {"pose_pixels": False}, {"pose_pixels": False},
     {}, BASE_LAUNCHES),
    ("split 1280x720+640x360",
     {"pose_pixels": False, "lo_height": 360, "lo_width": 640},
     {"pose_pixels": False, "lo_height": 45, "lo_width": 80}, {},
     BASE_LAUNCHES),
    ("yuv420", {}, {}, {"LAMENESS_YUV_INGEST": "1"}, BASE_LAUNCHES),
    ("sam_rect", {"sam_rect": True}, {"sam_rect": True}, {},
     {"K1": 12, "K2": 8, "K3": 4}),
    ("sam_encode_chunk=4", {"sam_encode_chunk": 4}, {"sam_encode_chunk": 4},
     {}, {"K1": 12, "K2": 60, "K3": 24}),
)
# K3 at the rect canvas's global grid: B·11 frames x 12 heads over 36x64
# tokens
RECT_GRID = (36, 64)

# A selection's SAM image embeddings against the default's, as
# ||a - b||_2 / ||b||_2 over the batch.  Both run in bf16 (eps 2^-8) and
# may round in different places: the head-major and head-last paths project
# the rel-pos tables by different einsums, and every kernel's output is
# rounded to bf16 (kernel-level agreement is within 1.6e-2 relative, TOL);
# 12 encoder layers carry the differences on.  No kernel takes augmented
# operands from HBM: the window kernels share window_entry, the global ones
# global_entry.  A wrong bias or a wrong head would move the embeddings by
# O(1).
EMB_RTOL = 5e-2

# the kernels whose entries put nothing on the card but the kernel: K1
# reads the DINO layer's head-last q, k, v views and writes its (B, S, H, D)
# output in place; the SAM ones read q, k, v and the tables where the qkv
# Linear and the einsum leave them (K2 and K7-K9 form the augmented bias
# columns in shared memory, K3-K6 stage the tables)
ENTRY_ALONE = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")
# the libraries of the wgmma routines: K1 (csrc/dino_attention.cuh) and the
# Hopper global routine of K3, K4, K5, K6 (csrc/hopper_attention.cuh)
HOPPER_SOURCES = ("attention", "sam_global_attention",
                  "sam_global_attention_v1", "sam_global_attention_v2",
                  "sam_global_attention_v3")

# the seeded trained pose model: kernels times POSE_GAIN, the class kernel of
# the level that carries its detections times POSE_SPREAD
# (seeded_pose_tree, calibrate_pose_tree)
POSE_GAIN = 1.55
POSE_SPREAD = 100.0

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}

# output keys of lameness_tpu/pipeline/engine.py::_detect/_sam/_dino/
# _heads_stage with heuristic pose (the JAX engine's default output dict)
ENGINE_KEYS = {
    "det_boxes", "det_scores", "det_classes", "det_valid", "primary_boxes",
    "primary_scores", "primary_valid", "masks", "mask_iou_pred",
    "mask_area_frac", "embeddings", "keypoints", "pose_boxes", "locomotion",
    "seq_features", "seq_mask", "tcn_probability", "tcn_uncertainty",
    "gait_probability", "gait_uncertainty", "gait_saliency"}
# and with trained pose installed (lameness_tpu/pipeline/engine.py:822-828)
POSE_KEYS = {"keypoints_model", "pose_trained_mask"}
# the outputs trained pose leaves as they are: detect, SAM, DINO, pose boxes
UPSTREAM_KEYS = ("det_boxes", "det_scores", "det_classes", "det_valid",
                 "primary_boxes", "primary_scores", "primary_valid", "masks",
                 "mask_iou_pred", "mask_area_frac", "embeddings",
                 "pose_boxes")


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def setup():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
        f"  count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    from lameness_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    secs = _cuda.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    hgmma = {}
    for name in _cuda.SOURCES:
        hgmma[name] = sass_count(_cuda.library_path(name), "HGMMA")
        path = _cuda.BUILD_DIR / f"{name}.log"
        if path.exists():
            entries = _cuda.ptxas_entries(path.read_text())
            regs = [int(e["registers"].split()[0]) for e in entries
                    if e["registers"]]
            spills = [e["spills"] for e in entries
                      if re.search(r"[1-9]\d* bytes spill stores",
                                   e["spills"])]
            log(f"  ptxas {name}: {len(regs)} kernels, registers "
                f"{min(regs, default=0)}-{max(regs, default=0)}, "
                f"{len(spills)} with spills {spills[:2]}; HGMMA in SASS "
                f"{hgmma[name]}")
            if name == "sam_global_attention":    # the Hopper global routine
                # ptxas's C7512: wgmma serialised for want of registers
                serial = set(re.findall(r"serialized .* function '([^']+)'",
                                        path.read_text()))
                for e in entries:
                    m = re.search(r"hopper_global_kernelILi(\d+)ELb([01])E",
                                  e["name"])
                    if m:
                        log(f"    hopper_global_kernel<{m[1]}, "
                            f"{('false', 'true')[int(m[2])]}>: "
                            f"{e['registers']}; {e['spills']}; wgmma "
                            f"serialised {e['name'] in serial}")
    return smi, hgmma


def sass_count(lib, opcode: str) -> int:
    """Instructions whose SASS opcode starts with ``opcode`` in a built
    library (cuobjdump of the CUDA toolkit)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum(1 for ln in sass.splitlines()
               if ln.split("*/", 1)[-1].strip().startswith(opcode))


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int) -> float:
    """ms per call from CUDA events around ``reps`` back-to-back calls: for
    a small kernel this is the host's launch rate, not the card's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, only: str = "", tries: int = 3) -> float:
    """Device ms per call: the summed duration of every kernel and copy
    that ``reps`` calls put on the card (torch.profiler), without the host
    gaps between launches; with ``only``, of the kernels whose name holds
    it.  The profiler has been seen to record no device event in a session
    now and then: it is asked again, and after ``tries`` empty sessions the
    CUDA-event time per call of the whole call is used, with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and only in e.key)
        if busy_us > 0:
            return busy_us / reps / 1e3
    log("  (torch.profiler recorded no device time: CUDA-event time per "
        "call instead)")
    return cuda_ms(fn, reps)


def kernel_names(fn) -> list:
    """Names of the device kernels and copies one call of ``fn`` runs, by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def foreign_kernels(fn) -> list:
    """Names of the device kernels and copies one call of ``fn`` runs
    besides the port's own (``lameness::``), by torch.profiler."""
    return [k for k in kernel_names(fn) if "lameness::" not in k]


def agree(name, dtype, out, ref):
    """max |out - ref| and whether it is inside TOL[dtype]."""
    import torch
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        (err <= atol + rtol * ref.float().abs()).all())
    mx = float(err.max())
    log(f"  {name:24s} {dtype:8s} max_abs_err {mx:.3e}  tol atol {atol:g} "
        f"rtol {rtol:g}  {'ok' if ok else 'FAIL'}")
    return mx, ok


# id, launch-count record (ops/_cuda.py KERNELS), entry, operand layout,
# source, and the TPU kernel it replaces (lameness_tpu/ops/...)
KERNEL_TABLE = (
    ("K1", "attention", "flash_attention", "dino", "attention.cu",
     "attention.py:50"),
    ("K2", "sam_window_attention_v3", "sam_window_attention_v3", "window_hl",
     "sam_window_attention.cu", "sam_attention.py:586"),
    ("K3", "sam_global_attention_v4", "sam_global_attention_v4", "global",
     "sam_global_attention.cu", "sam_attention.py:216"),
    ("K4", "sam_global_attention_v1", "sam_global_attention_v1", "global",
     "sam_global_attention_v1.cu", "sam_attention.py:32"),
    ("K5", "sam_global_attention_v2", "sam_global_attention_v2", "global",
     "sam_global_attention_v2.cu", "sam_attention.py:137"),
    ("K6", "sam_global_attention_v3", "sam_global_attention_v3", "global_hl",
     "sam_global_attention_v3.cu", "sam_attention.py:492"),
    ("K7", "sam_window_attention_v1", "sam_window_attention_v1", "window_hm",
     "sam_window_attention_v1.cu", "sam_attention.py:309"),
    ("K8", "sam_window_attention_v2", "sam_window_attention_v2", "window_hm",
     "sam_window_attention_v2.cu", "sam_attention.py:398"),
    ("K9", "sam_window_attention_v5", "sam_window_attention_v5", "window_hl",
     "sam_window_attention_v5.cu", "sam_attention.py:688"),
)


def kernel_inputs(layout: str, dtype, batch: int, gen, heads: int = 12,
                  hd: int = 64):
    """Inputs at the shapes the full-width engine gives each kernel for a
    batch of ``batch`` clips (EngineSpec() defaults): B·5 DINO frames,
    B·11 SAM frames of 25 windows (14x14, ``heads`` heads of ``hd``: ViT-B
    12 of 64, ViT-H 16 of 80) and of one 64x64 global grid.  q, k, v are
    views of a fused qkv tensor where the engine reads them so."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    dev = torch.device("cuda")

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                ).to(dtype)
    if layout == "dino":
        n_img, s, h, d = batch * 5, 257, 12, 64
        return tuple(rnd(n_img, s, h, d).transpose(1, 2) for _ in range(3))
    if layout in ("window_hl", "window_hm"):
        bw, n, h, d, win = batch * 11 * 25, 196, heads, hd, 14
        q4, k4, v4 = rnd(bw, n, 3, h, d).unbind(2)
        tables = (rnd(2 * win - 1, d, std=0.1), rnd(2 * win - 1, d, std=0.1))
        if layout == "window_hl":
            return (q4, k4, v4) + sa.project_rel_tables_hl(q4, *tables, win)
        q, k, v = (t.transpose(1, 2) for t in (q4, k4, v4))
        rh, rw = sa.project_rel_tables(q.reshape(bw * h, n, d), *tables, win)
        return (q, k, v) + tuple(t.reshape(bw, h, n, win) for t in (rh, rw))
    g, d = 64, hd
    tables = (rnd(2 * g - 1, d, std=0.1), rnd(2 * g - 1, d, std=0.1))
    if layout == "global_hl":
        q4, k4, v4 = rnd(batch * 11, g * g, 3, heads, d).unbind(2)
        return (q4, k4, v4) + sa.project_rel_tables_hl(q4, *tables, g)
    q, k, v = (rnd(batch * 11 * heads, g * g, d) for _ in range(3))
    return (q, k, v) + sa.project_rel_tables(q, *tables, g)


def kernel_work(layout: str, args):
    """(flops, bytes) of the function, whatever computes it: QK and PV
    products over the head dim, each input (q, k, v, the projected tables)
    read once and the output written once.  K3-K6 share one count, and K2,
    K7, K8, K9 another: the augmented width is not counted."""
    q = args[0]
    if layout in ("window_hl", "global_hl"):
        b, n, h, d = q.shape
    elif layout == "global":
        (b, n, d), h = q.shape, 1
    else:
        b, h, n, d = q.shape
    el = q.element_size()
    extra = sum(t.numel() for t in args[3:]) * el
    return 4.0 * b * h * n * n * d, 4.0 * b * h * n * d * el + extra


def plain_version(kid: str, args):
    """The plain version on these inputs (the augmented operands built here,
    outside the timed call).  The global ones run in chunks of 24 heads to
    bound their f32 scores."""
    import torch
    from lameness_tpu_torch.ops import attention as at
    from lameness_tpu_torch.ops import sam_attention as sa
    ref = sa.augmented_attention_reference

    def chunked(fn, tensors, size):
        return lambda: torch.cat([fn(*(t[i:i + size] for t in tensors))
                                  for i in range(0, tensors[0].shape[0],
                                                 size)])
    if kid == "K1":
        return lambda: at.reference_attention(*args)
    if kid == "K2":
        return lambda: sa.window_attention_reference(*args)
    if kid in ("K3", "K4"):
        return chunked(sa.sam_attention_reference, args, 24)
    if kid == "K5":
        qa, ka, rw = sa.global_v2_operands(args[0], args[1], *args[3:])
        return chunked(ref, (qa, ka, args[2], rw), 24)
    if kid == "K7":
        return lambda: sa.window_attention_hm_reference(*args)
    if kid == "K8":
        qa, ka = sa.window_v2_operands(args[0], args[1], *args[3:])
        return lambda: ref(qa, ka, args[2])
    q4, k4, v4, rh4, rw4 = args
    b, n, h, d = q4.shape
    if kid == "K6":
        qa, ka, rw = sa.global_v3_operands(q4, k4, rh4, rw4)
        return chunked(lambda *t: ref(*(x.transpose(1, 2) for x in t)
                                      ).transpose(1, 2).reshape(-1, n, h * d),
                       (qa, ka, v4, rw), 2)
    qa, ka = sa.window_v5_operands(q4, k4, rh4, rw4)              # K9
    return lambda: ref(*(x.transpose(1, 2) for x in (qa, ka, v4)),
                       fold=True).transpose(1, 2).reshape(b, n, h * d)


def library_call(layout: str, args):
    """One PyTorch call computing the same function: SDPA over (heads, N, ·)
    views, given the bias materialised from the tables for the SAM kernels
    (a yardstick only: the port never calls it)."""
    import torch.nn.functional as F
    q, k, v = args[:3]
    bias = None
    if layout in ("window_hl", "global_hl"):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        rh, rw = (t.transpose(1, 2) for t in args[3:])
    elif layout == "window_hm":
        rh, rw = args[3:]
    elif layout == "global":
        q, k, v = (t[:, None] for t in (q, k, v))
        rh, rw = (t.reshape(t.shape[0], 1, -1, t.shape[-1]) for t in args[3:])
    if layout != "dino":
        b, h, n = q.shape[:3]
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(b, h, n, n)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def check_kernels(batch: int = BATCH):
    """Phase 2: returns {id: record} and whether every check passed."""
    import torch
    from lameness_tpu_torch.ops import attention as at
    from lameness_tpu_torch.ops import sam_attention as sa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records, all_ok = {}, True
    for kid, name, entry, layout, source, replaces in KERNEL_TABLE:
        fn = getattr(at if kid == "K1" else sa, entry)
        rec = {"name": name, "route": "cuda",
               "source": f"lameness_tpu_torch/csrc/{source}",
               "replaces": f"lameness_tpu/ops/{replaces}"}
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            args = kernel_inputs(layout, dtype, batch, gen)
            out = fn(*args)
            plain = plain_version(kid, args)
            ref = plain()
            torch.cuda.synchronize()
            err, ok = agree(f"{kid} {entry}", dtype_name, out, ref)
            all_ok &= ok
            if dtype_name != "bfloat16":
                del args, out, ref, plain
                continue
            # times at the engine's working dtype (bf16 under the policy):
            # the kernel's own device time inside its entry, and the whole
            # entry's (anything else it launches) beside it
            reps = 5 if layout.startswith("global") else 20
            rec["max_abs_err"] = err
            rec["ms"] = device_ms(lambda: fn(*args), reps, only="lameness::")
            rec["entry_ms"] = device_ms(lambda: fn(*args), reps)
            rec["call_ms"] = cuda_ms(lambda: fn(*args), reps)
            rec["plain_ms"] = device_ms(plain, 3)
            # the yardstick twice: the profiler's device sum and CUDA events
            # (a profiler run has been seen to read a library call at a
            # third of its usual time)
            library = library_call(layout, args)
            rec["library_ms"] = device_ms(library, 3)
            rec["library_cuda_ms"] = cuda_ms(library, 3)
            ratio = rec["library_ms"] / rec["library_cuda_ms"]
            if not 0.5 <= ratio <= 2.0:
                log(f"  note: {kid} library time by the profiler "
                    f"{rec['library_ms']:.4f} ms against CUDA events "
                    f"{rec['library_cuda_ms']:.4f} ms (more than 2x apart)")
            del library
            others = foreign_kernels(lambda: fn(*args))
            if others:
                log(f"  {kid} entry also runs: {others[:6]}")
            if kid in ENTRY_ALONE and others:
                log(f"  {kid}: its entry must launch its kernel alone")
                all_ok = False
            flops, nbytes = kernel_work(layout, args)
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = flops / PEAK_FLOPS_S[dtype_name] * 1e3
            rec["bound_ms"] = max(t_bytes, t_ops)
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            rec["entry_over_ms"] = rec["entry_ms"] / rec["ms"]
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            log(f"  {kid} {entry:24s} device ms {rec['ms']:.4f} (entry "
                f"{rec['entry_ms']:.4f} = {rec['entry_over_ms']:.3f}x, per "
                f"call {rec['call_ms']:.4f})  plain {rec['plain_ms']:.4f}  "
                f"library {rec['library_ms']:.4f} (CUDA events "
                f"{rec['library_cuda_ms']:.4f})  bound {rec['bound_ms']:.4f} "
                f"({rec['bound_by']}, {100 * rec['bound_share']:.1f}% of ms; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  shapes "
                f"{[tuple(a.shape) for a in args]}")
            del args, out, ref, plain
        torch.cuda.empty_cache()
        records[kid] = rec
    return records, (all_ok & check_global_bitwise(batch, gen)
                     & check_window_bitwise(batch, gen))


def check_global_bitwise(batch: int, gen) -> bool:
    """K3, K4 and K5 run one device routine on one set of operands: their
    bf16 outputs at the engine's shapes must be equal bit for bit.  K6 runs
    it on head-last views: its output must equal K3's on head-major copies
    of the same q, k, v and tables, bit for bit."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    args = kernel_inputs("global", torch.bfloat16, batch, gen)
    outs = {kid: getattr(sa, entry)(*args)
            for kid, _, entry, *_ in KERNEL_TABLE
            if kid in ("K3", "K4", "K5")}
    torch.cuda.synchronize()
    same = {kid: bool(torch.equal(out, outs["K3"]))
            for kid, out in outs.items()}
    del args, outs
    q4, k4, v4, rh4, rw4 = kernel_inputs("global_hl", torch.bfloat16, batch,
                                         gen)
    b, n, h, d = q4.shape
    g = rh4.shape[-1]

    def head_major(t):
        return t.transpose(1, 2).reshape(b * h, n, t.shape[-1])
    k3 = sa.sam_global_attention_v4(
        head_major(q4), head_major(k4), head_major(v4),
        *(head_major(t).view(b * h, g, n // g, t.shape[-1])
          for t in (rh4, rw4)))
    k6 = sa.sam_global_attention_v3(q4, k4, v4, rh4, rw4)
    torch.cuda.synchronize()
    same["K6"] = bool(torch.equal(
        k6, k3.view(b, h, n, d).transpose(1, 2).reshape(k6.shape)))
    ok = all(same.values())
    log(f"  K3, K4, K5 bfloat16 ({b * h}, {n}, {d}) and K6 on head-last "
        f"views {tuple(q4.shape)}: bit-identical to K3 {json.dumps(same)}"
        f"  {'ok' if ok else 'FAIL'}")
    return ok


def check_window_bitwise(batch: int, gen) -> bool:
    """K8 launches K7's route choice (window_entry) on K7's operands, K9
    K2's on K2's: at the engine's shapes in bf16, K8's output must equal
    K7's and K9's K2's, bit for bit."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    same, shapes = {}, {}
    entry = {kid: e for kid, _, e, *_ in KERNEL_TABLE}
    for kid, twin, layout in (("K8", "K7", "window_hm"),
                              ("K9", "K2", "window_hl")):
        args = kernel_inputs(layout, torch.bfloat16, batch, gen)
        out, ref = (getattr(sa, entry[k])(*args) for k in (kid, twin))
        torch.cuda.synchronize()
        same[f"{kid} = {twin}"] = bool(torch.equal(out, ref))
        shapes[kid] = tuple(args[0].shape)
        del args, out, ref
    ok = all(same.values())
    log(f"  K8 on {shapes['K8']}, K9 on {shapes['K9']} bfloat16: "
        f"{json.dumps(same)}  {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def leaves(tree, prefix=""):
    """Flatten the output dict (``locomotion`` is a dict of its own)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(val)


def rel_l2(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def same_leaves(out, ref, skip=()) -> bool:
    """Whether every leaf of ``out`` but ``skip`` equals ``ref``'s bit for
    bit (same key set)."""
    a, b = dict(leaves(out)), dict(leaves(ref))
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for k in a if k not in skip)


def check_small_engine(spec_kw=None, devices=("cpu", "cuda"), pose=False,
                       sam=None):
    """The tiny engine (make_test_engine geometry + a 128² SAM) on the card
    in f32 against its plain path on the CPU, same weights and frames; with
    ``spec_kw``, through ``with_spec`` with those fields changed; with
    ``pose``, trained pose installed (``calibrate_pose_tree`` on the CPU
    engine, the same tree on the card; the frames are seeded 5x5-pixel
    blocks, which the pose letterbox does not average to grey); with
    ``sam`` (Sam keyword arguments), that SAM instead of the 128² one.  The
    CPU path is what tests/test_torch_engine.py (and
    tests/test_torch_ingest.py, tests/test_torch_sam_modes.py,
    tests/test_torch_pose.py, tests/test_torch_weights.py) holds against the
    JAX engine; the gates are those tests'."""
    import torch
    from lameness_tpu_torch.models.sam import Sam
    from lameness_tpu_torch.pipeline.engine import make_test_engine
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.weights import seeded_state_dict
    rng = np.random.default_rng(SEED)
    if pose:
        frames = rng.integers(0, 256, (2, 15, 18, 32, 3), dtype=np.uint8
                              ).repeat(5, axis=2).repeat(5, axis=3)
    else:
        frames = rng.integers(0, 256, (2, 15, 90, 160, 3), dtype=np.uint8)
    from lameness_tpu_torch.ops._cuda import KERNELS
    outs, tree = {}, None
    for dev in devices:
        for k in KERNELS.values():
            k.launches = 0
        gen = torch.Generator().manual_seed(SEED)
        eng = make_test_engine(device=dev, with_sam=True, generator=gen)
        # dropout 0: the CPU and CUDA generators draw different masks
        eng.tcn = TCN(input_dim=44, dropout=0.0, device=dev)
        eng.gait = GaitTransformer(input_dim=44, dropout=0.0, device=dev)
        eng.load_state_dicts({"tcn": seeded_state_dict(eng.tcn, gen),
                              "gait": seeded_state_dict(eng.gait, gen)})
        if sam:
            eng.sam = Sam(img_size=128, device=dev, **sam)
            eng.load_state_dicts({"sam": seeded_state_dict(eng.sam, gen)})
        if spec_kw:
            eng = eng.with_spec(dataclasses.replace(eng.spec, **spec_kw))
        if pose and tree is None:
            tree, level, margin = calibrate_pose_tree(
                eng, seeded_pose_tree(torch.Generator().manual_seed(SEED)),
                eng.to_device(frames))
            log(f"small engine pose: level {level} carries the detections, "
                f"smallest margin of a frame's top logit {margin:.3g}")
        elif pose:
            eng.install_pose_params(tree)
        outs[dev] = dict(leaves(eng.process_clip_batch(frames)))
    log("small engine launches: " + json.dumps(
        {name: k.launches for name, k in KERNELS.items() if k.launches}))
    cpu, gpu = outs[devices[0]], outs[devices[1]]
    ok = set(cpu) == set(gpu)
    worst = {}
    for key in sorted(cpu):
        a, b = cpu[key], gpu[key]
        ok &= a.shape == b.shape and a.dtype == b.dtype
        if key == "masks":
            worst[key] = float((a == b).mean())
            ok &= worst[key] >= 0.995
        elif a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            worst[key] = float((a != b).mean())
            ok &= worst[key] == 0.0
        else:
            worst[key] = float(np.abs(a.astype(np.float64) - b).max())
            tol = 1e-3 if key == "mask_iou_pred" else 1e-4
            ok &= worst[key] <= tol
    floats = {k: v for k, v in worst.items()
              if k != "masks" and cpu[k].dtype.kind == "f"}
    top = max(floats, key=floats.get)
    log(f"small engine {devices[1]} vs {devices[0]}: mask agreement "
        f"{worst['masks']:.5f}; int/bool mismatch share "
        f"{max(v for k, v in worst.items() if k not in floats and k != 'masks'):.3g}"
        f"; float max_abs_err {floats[top]:.3e} ({top})")
    if pose:
        hit = cpu["pose_trained_mask"]
        mixed = bool(hit.any() and not hit.all())
        ok &= mixed
        log(f"small engine trained pose: hits {int(hit.sum())} of "
            f"{hit.size} pose frames (hits and misses: {mixed})")
    log(f"small engine agreement: {'ok' if ok else 'FAIL'}")
    return ok


def seeded_pose_tree(generator, gain: float = POSE_GAIN):
    """Seeded weights of the trained pose model (YOLOv8-n, one class, 20
    keypoints) as a flax-layout tree (numpy leaves): ``seeded_state_dict``
    with its kernels times ``gain``.  At the lecun draw alone the pose head
    hardly reads the frame (its keypoints move by about 1e-4 px between
    frames), and the locomotion ratios of such strides turn float rounding
    into percent."""
    from lameness_tpu_torch.models import pose as pose_mod
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.weights import (conv_tree_from_state_dict,
                                            seeded_state_dict)
    model = YoloV8("n", num_classes=1, num_keypoints=pose_mod.NUM_KEYPOINTS,
                   device="cpu")
    return conv_tree_from_state_dict(seeded_state_dict(model, generator,
                                                       gain))


def calibrate_pose_tree(eng, tree, frames_dev, spread: float = POSE_SPREAD):
    """The pose ``tree`` with its class head set so that trained pose hits
    on about half of the pose frames of ``frames_dev`` and misses on the
    rest; installs it in ``eng`` and returns (tree, level, margin).

    Seeded weights detect nothing in particular, so a hit is made, not
    found: the one level whose boxes overlap the primaries (most hits with
    every anchor of it passing the threshold, the others suppressed) keeps
    its class kernel times ``spread`` (the frames' scores then differ by
    O(1) logits), and its class bias is minus the median over frames of
    its largest logit.  ``margin`` is the smallest distance of a frame's
    largest logit from the threshold."""
    import copy
    import torch
    from lameness_tpu_torch.ops import preprocess as prep
    s = eng.spec
    with torch.no_grad():
        det = eng._detect_stage(frames_dev)
        near = np.abs(s.pose_idx[:, None] - s.det_idx[None, :]).argmin(1)
        pose_boxes = det["primary_boxes"][:, torch.as_tensor(
            near, device=eng.device)]

        def variant(level, bias, kernel_scale):
            t = copy.deepcopy(tree)
            for i in range(3):
                node = t["params"][f"detect{i}"]["cls2"]
                node["bias"] = np.full_like(node["bias"], bias if i == level
                                            else -30.0)
                if i == level:
                    node["kernel"] = node["kernel"] * kernel_scale
            return t
        hits = []
        for level in range(3):
            eng.install_pose_params(variant(level, 30.0, 1.0))
            hits.append(float(eng._trained_pose(frames_dev, pose_boxes)[2]
                              .float().mean()))
        level = int(np.argmax(hits))
        eng.install_pose_params(variant(level, 0.0, spread))
        frames, h, w = eng._pose_frames(frames_dev)
        canvases, _, _ = prep.letterbox(frames.reshape((-1, h, w, 3)),
                                        s.pose_size)
        logits = eng.pose_model(canvases.to(s.dtype))["levels"][level]["cls"]
        top = logits.flatten(1).amax(1).float().cpu().numpy()
    mid = float(np.median(top))
    tree = variant(level, -mid, spread)
    eng.install_pose_params(tree)
    return tree, level, float(np.abs(top - mid).min())


def check_outputs(out, s, batch: int, pose: bool = False) -> bool:
    """The JAX engine's key set (with trained pose, its two leaves more),
    finite values, the expected shapes."""
    keys = ENGINE_KEYS | (POSE_KEYS if pose else set())
    ok = set(out) == keys
    if not ok:
        log(f"key mismatch: extra {sorted(set(out) - keys)} missing "
            f"{sorted(keys - set(out))}")
    flat = dict(leaves(out))
    for key, arr in flat.items():
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            log(f"non-finite output {key}")
            ok = False
    td, tp = len(s.det_idx), len(s.pose_idx)
    shapes = {"det_boxes": (batch, td, s.max_det, 4),
              "det_classes": (batch, td, s.max_det),
              "primary_boxes": (batch, td, 4),
              "masks": (batch, td, s.sam_mask_size, s.sam_mask_size),
              "mask_iou_pred": (batch, td),
              "keypoints": (batch, tp, 20, 3),
              "seq_features": (batch, 125, 44),
              "tcn_probability": (batch,), "gait_saliency": (batch, 125),
              "locomotion.lameness_score": (batch,)}
    if pose:
        shapes.update({"keypoints_model": (batch, tp, 20, 3),
                       "pose_trained_mask": (batch, tp)})
    for key, shape in shapes.items():
        if key not in flat or flat[key].shape != shape:
            log(f"shape {key}: {flat.get(key, np.empty(0)).shape} != {shape}")
            ok = False
    log(f"engine outputs: {'ok' if ok else 'FAIL'}  ("
        + ", ".join(f"{k} {v.shape} {v.dtype}" for k, v in sorted(
            flat.items()) if not k.startswith("locomotion.")) + ")")
    return ok


def time_stages(eng, frames, reps: int):
    """Median host-clock ms of each stage, synchronised, on packed device
    frames; the transfer in (host frames to device RGB) and the readback
    (the outputs to numpy in one copy) are timed as rows of their own."""
    import torch
    times = {k: [] for k in ("transfer", "detect", "sam", "dino", "heads",
                             "readback")}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for _ in range(reps):
            def timed(name, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                return out
            dev = timed("transfer", lambda: eng.to_device(frames))
            out = timed("detect", lambda: eng._detect_stage(dev))
            out.update(timed("sam", lambda: eng._sam_stage(
                dev, out["primary_boxes"])))
            out.update(timed("dino", lambda: eng._dino_stage(dev)))
            out.update(timed("heads", lambda: eng._heads_stage(
                out["primary_boxes"], out["primary_scores"], gen, dev)))

            def readback():
                flat, meta = eng.pack_output(out)
                return eng.unpack_output(eng._fetch(flat), meta)
            timed("readback", readback)
    return {k: float(np.median(v)) for k, v in times.items()}


def profile_batch(eng, frames, top: int = 12):
    """One process_clip_batch under torch.profiler: the device's busy share
    of the wall time (kernels and copies; the profiler's own host overhead
    lengthens the wall, so the idle share is an upper bound) and the device
    time by kernel name.  Returns the device busy ms (None when the
    profiler recorded nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process_clip_batch(frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("profile: no device events recorded (device idle share not "
            "measured)")
        return None
    busy_us = sum(e.self_device_time_total for e in dev)
    log(f"profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), idle "
        f"share <= {100 * (1 - busy_us / wall_us):.1f}%")
    log("  device time by kernel (the top ones, then the port's own):")
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top] + [e for e in ranked[top:] if "lameness::" in e.key]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    # the same time by the host op that launched it (kernels of the port's
    # own wrappers have no aten op above them)
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log("  device time by launching op:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    return busy_us / 1e3


@contextlib.contextmanager
def switches(env):
    """The switches set to ``env`` (the others unset), restored
    afterwards."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    try:
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(env)
        yield
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


def counted_run(eng, frames, transfer=None):
    """One process_clip_batch with every launch count from 0: the counts,
    the outputs and the SAM image embeddings of the batch (of every encoder
    call, copied to the host in this run only)."""
    import torch
    from lameness_tpu_torch.ops._cuda import KERNELS
    captured = []
    hook = eng.sam.vision_encoder.register_forward_hook(
        lambda mod, inp, out: captured.append(out.float().cpu()))
    for k in KERNELS.values():
        k.launches = 0
    out = eng.process_clip_batch(
        frames, generator=torch.Generator(device="cuda").manual_seed(SEED),
        transfer=transfer)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    hook.remove()
    return launches, out, torch.cat(captured)


def run_engine(batch: int = BATCH):
    """The full-width default engine on ``batch`` synthetic 720p clips, then
    the same engine (same weights, same frames) under each other kernel
    selection.  Returns the launches of each selection, whether every check
    passed, and (engine, frames, the default run's outputs, SAM embeddings
    and peak GB) for phase 4."""
    import torch
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    eng = LamenessEngine(Config(), EngineSpec(), generator=gen)
    torch.cuda.synchronize()
    log(f"engine init {time.perf_counter() - t0:.2f} s  dtype "
        f"{eng.spec.dtype}  precision {json.dumps(eng.precision)}")
    t0 = time.perf_counter()
    with switches({}):
        warm = eng.warmup(batch=batch)
    log(f"warmup {time.perf_counter() - t0:.2f} s  {json.dumps(warm)}")
    s = eng.spec
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (batch, s.clip_frames, s.frame_height,
                                   s.frame_width, 3), dtype=np.uint8)
    ok, by_selection, ref = True, {}, None
    for sel, env, expected in SELECTIONS:
        with switches(env):
            torch.cuda.reset_peak_memory_stats()
            launches, out, emb = counted_run(eng, frames)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            e2e = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                eng.process_clip_batch(frames)
                torch.cuda.synchronize()
                e2e.append(time.perf_counter() - t0)
            log(f"== engine, {sel}: launches in one process_clip_batch "
                f"(B={batch}) {json.dumps(launches)}")
            log("engine e2e s/batch " + json.dumps([round(t, 4) for t in e2e])
                + f"  clips/s {batch / float(np.median(e2e)):.3f}  peak mem "
                f"{peak_gb:.2f} GB")
            if ref is None:
                ref_peak = peak_gb
                stages = time_stages(eng, frames, REPEATS)
                log("stage ms (median of " + str(REPEATS) + "): "
                    + json.dumps({k: round(v, 3) for k, v in stages.items()}))
            profile_batch(eng, frames, top=12 if ref is None else 8)
        ok &= expect_launches(launches, expected)
        ok &= check_outputs(out, s, batch)
        by_selection[sel] = launches
        if ref is None:
            ref = out, emb
            continue
        agreement = float((out["masks"] == ref[0]["masks"]).mean())
        rel = rel_l2(emb, ref[1])
        good = agreement >= 0.995 and rel <= EMB_RTOL
        ok &= good
        bitwise = torch.equal(emb, ref[1]) and same_leaves(out, ref[0])
        log(f"{sel} vs default: mask agreement {agreement:.5f} (gate "
            f">= 0.995); SAM embeddings relative L2 error {rel:.3e} (gate "
            f"<= {EMB_RTOL:g}), max abs {float((emb - ref[1]).abs().max()):.3e}"
            f"; every output bit for bit {bitwise}"
            f"  {'ok' if good else 'FAIL'}")
    return by_selection, ok, (eng, frames) + ref + (ref_peak,)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def mode_gate(name, m, frames, out, emb, peak_gb, ref) -> bool:
    """The gate of one serving mode (its outputs, SAM embeddings and peak
    GB) against the default run ``ref`` = (outputs, SAM embeddings, peak
    GB)."""
    import torch
    from lameness_tpu_torch.video.yuv import i420_to_rgb_device, rgb_to_i420
    ref_out, ref_emb, ref_peak = ref
    agreement = float((out["masks"] == ref_out["masks"]).mean()) \
        if out["masks"].shape == ref_out["masks"].shape else float("nan")
    if name == "pose_pixels=False":
        ok = same_leaves(out, ref_out) and torch.equal(emb, ref_emb)
        log(f"  gate a: every output and the SAM embeddings bit for bit the "
            f"default's {ok}  {'ok' if ok else 'FAIL'}")
    elif name.startswith("split"):
        e, e0 = out["embeddings"], ref_out["embeddings"]
        rel = rel_l2(torch.from_numpy(e), torch.from_numpy(e0)) \
            if e.shape == e0.shape else float("nan")
        ok = (same_leaves(out, ref_out, skip=("embeddings",))
              and torch.equal(emb, ref_emb) and e.shape == e0.shape
              and bool(np.isfinite(e).all()))
        log(f"  gate b: det, SAM and heads outputs bit for bit the "
            f"default's, DINO embeddings finite {e.shape} "
            f"{'ok' if ok else 'FAIL'}; embeddings relative L2 to the "
            f"default {rel:.3e} (not gated: 640x360 DINO input)")
    elif name == "yuv420":
        packed = m.spec.pack_frames(frames)
        trip = i420_to_rgb_device(torch.from_numpy(rgb_to_i420(packed)))
        dev = m.to_device(frames)
        torch.cuda.synchronize()
        same_rgb = torch.equal(dev.cpu(), trip)
        _, rgb_out, rgb_emb = counted_run(m, trip.numpy(), transfer="rgb")
        same_out = same_leaves(out, rgb_out) and torch.equal(emb, rgb_emb)
        ok = same_rgb and same_out
        log(f"  gate c: the card's I420 -> RGB equals the CPU's bit for bit "
            f"{same_rgb}; every output equals the RGB path's on the "
            f"round-tripped frames {same_out}  {'ok' if ok else 'FAIL'}; "
            f"mask agreement with the default (source frames) "
            f"{agreement:.5f}")
    elif name == "sam_rect":
        ok = True
        log(f"  gate d: mask agreement with the square canvas {agreement:.5f}"
            f" (reported, not gated: pad tokens join the square canvas's "
            f"attention); SAM embeddings {tuple(emb.shape)} against "
            f"{tuple(ref_emb.shape)}")
    else:
        rel = rel_l2(emb, ref_emb)
        ok = agreement >= 0.995 and rel <= EMB_RTOL
        log(f"  gate e: mask agreement {agreement:.5f} (gate >= 0.995); SAM "
            f"embeddings relative L2 error {rel:.3e} (gate <= {EMB_RTOL:g}); "
            f"every output bit for bit {same_leaves(out, ref_out)}; peak "
            f"{peak_gb:.2f} GB against the default's {ref_peak:.2f}  "
            f"{'ok' if ok else 'FAIL'}")
    return ok


def ingest_parts(m, frames) -> dict:
    """The parts of a split or I420 transfer, medians of REPEATS (ms): the
    host packing (the resize alone), the host I420 conversion, the card's
    conversion back (CUDA events)."""
    import torch
    from lameness_tpu_torch.video.yuv import i420_to_rgb_device, rgb_to_i420
    s = m.spec

    def host_ms(fn):
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    parts = {}
    if s.split:
        parts["split_pack_host"] = host_ms(lambda: s.split_pack_host(frames))
        lo = frames[:, s.lo_idx]
        parts["lo_resize"] = host_ms(lambda: torch.nn.functional.interpolate(
            torch.from_numpy(lo).flatten(0, 1).permute(0, 3, 1, 2),
            size=(s.lo_height, s.lo_width), mode="bilinear",
            align_corners=False, antialias=False))
    if m.default_transfer() == "yuv420":
        packed = s.pack_frames(frames)
        parts["rgb_to_i420"] = host_ms(lambda: rgb_to_i420(packed))
        i420 = torch.from_numpy(rgb_to_i420(packed)).cuda()
        parts["i420_to_rgb_card"] = cuda_ms(
            lambda: i420_to_rgb_device(i420), REPEATS)
    return parts


def run_modes(eng, frames, ref_out, ref_emb, ref_peak,
              batch: int = BATCH) -> bool:
    """Phase 4: each serving mode of MODES on the default engine's modules
    (with_spec), weights and frames."""
    import torch
    from lameness_tpu_torch.ops._cuda import KERNELS
    ok = True
    for name, spec_kw, _, env, expected in MODES:
        with switches(env):
            m = eng.with_spec(dataclasses.replace(eng.spec, **spec_kw))
            t0 = time.perf_counter()
            m.warmup(batch=batch)
            warm = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            launches, out, emb = counted_run(m, frames)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            e2e = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                m.process_clip_batch(frames)
                torch.cuda.synchronize()
                e2e.append(time.perf_counter() - t0)
            log(f"== mode {name} (packed rows {m.spec.n_packed}"
                + (f", hi {len(m.spec.hi_idx)} lo {len(m.spec.lo_idx)}"
                   if m.spec.split else "")
                + f", transfer {m.default_transfer()}): warmup {warm:.2f} s;"
                f" launches in one process_clip_batch (B={batch}) "
                + json.dumps({k: v for k, v in launches.items() if v}))
            stages = time_stages(m, frames, REPEATS)
            busy = profile_batch(m, frames, top=6)
            log("mode record " + json.dumps({
                "mode": name, "e2e_s": [round(t, 4) for t in e2e],
                "clips_s": batch / float(np.median(e2e)),
                "stage_ms": {k: round(v, 3) for k, v in stages.items()},
                "ingest_parts_ms": ingest_parts(m, frames),
                "device_busy_ms": busy, "peak_gb": round(peak_gb, 3)}))
            good = expect_launches(launches, expected)
            good &= check_outputs(out, m.spec, batch)
            good &= mode_gate(name, m, frames, out, emb, peak_gb,
                              (ref_out, ref_emb, ref_peak))
            ok &= good
            del m, out, emb
            torch.cuda.empty_cache()
    for k in KERNELS.values():
        k.launches = 0
    return ok & rect_k3(batch)


def rect_k3(batch: int) -> bool:
    """K3 at the rect canvas's global grid (36x64 tokens, B·11 frames x 12
    heads, bf16) against its plain version, its device time beside its
    bound and one SDPA call (the yardstick of phase 2)."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gh, gw = RECT_GRID
    dev = torch.device("cuda")

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                ).to(torch.bfloat16)
    q, k, v = (rnd(batch * 11 * 12, gh * gw, 64) for _ in range(3))
    args = (q, k, v) + sa.project_rel_tables(
        q, rnd(2 * gh - 1, 64, std=0.1), rnd(2 * gw - 1, 64, std=0.1), gh, gw)
    fn = sa.sam_global_attention_v4
    out = fn(*args)
    ref = plain_version("K3", args)()
    torch.cuda.synchronize()
    err, ok = agree("K3 rect", "bfloat16", out, ref)
    # the profiler's kernel time, the whole entry's, and CUDA events around
    # back-to-back calls (a profiler session has read this kernel at a
    # fifth of its time in the engine's profile)
    ms = device_ms(lambda: fn(*args), 5, only="lameness::")
    entry = device_ms(lambda: fn(*args), 5)
    call = cuda_ms(lambda: fn(*args), 20)
    library = library_call("global", args)
    lib = device_ms(library, 3)
    lib_call = cuda_ms(library, 5)
    flops, nbytes = kernel_work("global", args)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S["bfloat16"] * 1e3
    bound = max(t_bytes, t_ops)
    log("K3 at the rect shape " + json.dumps({
        "shapes": [tuple(a.shape) for a in args], "ms": ms,
        "entry_ms": entry, "call_ms": call, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share_of_call": bound / call, "library_ms": lib,
        "library_cuda_ms": lib_call, "max_abs_err": err}))
    return ok


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------
# ViT-H's launches in one process_clip_batch of B = 2: 28 windowed layers,
# the 7 before the first global one (layer 7) split into content and
# shared pad windows (35); 4 global layers; 12 DINO layers
VIT_H_SELECTIONS = (
    ("default", {}, {"K1": 12, "K2": 35, "K3": 4}),
    ("WIN=v1 GLB=v1", {"LAMENESS_WIN_KERNEL": "v1",
                       "LAMENESS_GLB_KERNEL": "v1"},
     {"K1": 12, "K7": 35, "K4": 4}),
    ("WIN=v2 GLB=v2", {"LAMENESS_WIN_KERNEL": "v2",
                       "LAMENESS_GLB_KERNEL": "v2"},
     {"K1": 12, "K8": 35, "K5": 4}),
    # hd + 64 = 144 > 128: GLB=v3 takes K5, not K6 (models/sam.py)
    ("WIN=v5 GLB=v3", {"LAMENESS_WIN_KERNEL": "v5",
                       "LAMENESS_GLB_KERNEL": "v3"},
     {"K1": 12, "K9": 35, "K5": 4}),
)
# the kernels that run at hd 80, and the routine each must launch there in
# bf16: the window routine's instantiation at hd 80 and SAM's 13 key tiles,
# and the Hopper global routine's at hd 80 (the 64 x 64 grid: rw per
# column, ROW_TILE)
HD80_ROUTINES = {"K2": "window_attention_kernel<80, 13>",
                 "K3": "hopper_global_kernel<80, true>",
                 "K4": "hopper_global_kernel<80, true>",
                 "K5": "hopper_global_kernel<80, true>",
                 "K7": "window_attention_kernel<80, 13>",
                 "K8": "window_attention_kernel<80, 13>",
                 "K9": "window_attention_kernel<80, 13>"}
# the tiny SAM at ViT-H's head dim (tests/test_sam_variants.py:202)
HD80_SAM = dict(encoder_dim=160, encoder_depth=3, encoder_heads=2,
                global_attn_indexes=(1,))


def engine_record(name, eng, frames, launches, peak_gb,
                  batch: int = BATCH) -> None:
    """e2e (REPEATS runs), stage ms, device busy of one profiled batch and
    peak memory of one engine, as a ``checkpoint record`` line."""
    import torch
    e2e = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        eng.process_clip_batch(frames)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    stages = time_stages(eng, frames, REPEATS)
    busy = profile_batch(eng, frames, top=8)
    log("checkpoint record " + json.dumps({
        "engine": name, "launches": {k: v for k, v in launches.items() if v},
        "e2e_s": [round(t, 4) for t in e2e],
        "clips_s": batch / float(np.median(e2e)),
        "stage_ms": {k: round(v, 3) for k, v in stages.items()},
        "device_busy_ms": busy, "peak_gb": round(peak_gb, 3)}))


def expect_launches(launches, expected) -> bool:
    record = {kid: name for kid, name, *_ in KERNEL_TABLE}
    want = {record[kid]: expected.get(kid, 0) for kid in record}
    if launches != want:
        log(f"launches {launches} != expected {want}")
    return launches == want


def pass_through(eng, frames) -> bool:
    """5a: ``process_clip_batch`` of the engine's own ``to_device`` output
    (the packed tensor, and the split dict through ``with_spec``) equals
    the host path's bit for bit, with no second transfer."""
    ok = True
    split = eng.with_spec(dataclasses.replace(eng.spec, lo_height=360,
                                              lo_width=640))
    for name, m in (("packed", eng), ("split dict", split)):
        dev = m.to_device(frames)
        calls = []
        to_device = m.to_device
        m.to_device = lambda *a, **k: calls.append(a) or to_device(*a, **k)
        try:
            got = m.process_clip_batch(dev)
        finally:
            del m.to_device
        want = m.process_clip_batch(frames)
        leaves_of = dev.values() if isinstance(dev, dict) else [dev]
        same = same_leaves(got, want) and not calls
        ok &= same
        log(f"  pass-through, {name} on {[str(t.device) for t in leaves_of]}"
            f" (engine device {m.device}): transfers inside the call "
            f"{len(calls)}; every output bit for bit the host path's {same}"
            f"  {'ok' if same else 'FAIL'}")
    return ok


def trained_pose(ref_out, frames, batch: int = BATCH) -> bool:
    """5b: the default engine with trained pose, installed from ``.pt``
    files (the seeded pose model and the phase-3 engine's YOLO, in the
    ultralytics layout) through ``restore_engine``."""
    import tempfile
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.models.yolo import export_ultralytics_state_dict
    from lameness_tpu_torch.pipeline.checkpoint import restore_engine
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    from lameness_tpu_torch.weights import conv_tree_from_state_dict
    eng = LamenessEngine(Config(), EngineSpec(),
                         generator=torch.Generator().manual_seed(SEED))
    tree, level, margin = calibrate_pose_tree(
        eng, seeded_pose_tree(torch.Generator().manual_seed(SEED + 1)),
        eng.to_device(frames))
    with tempfile.TemporaryDirectory() as tmp:
        for name, src, pose in (
                ("yolo", conv_tree_from_state_dict(eng.yolo.state_dict()),
                 False), ("pose", tree, True)):
            path = Path(tmp) / name / f"{name}.pt"
            path.parent.mkdir()
            torch.save({k: torch.as_tensor(v) for k, v in
                        export_ultralytics_state_dict(src, pose).items()},
                       path)
        loaded = restore_engine(eng, Path(tmp))
    ok = loaded.get("yolo") is True and loaded.get("pose") is True
    log(f"  restore_engine: {json.dumps(loaded)}; pose level {level}, "
        f"smallest margin of a frame's top logit {margin:.3g}; precision "
        f"{json.dumps(eng.precision)}  {'ok' if ok else 'FAIL'}")
    eng.warmup(batch=batch)
    torch.cuda.reset_peak_memory_stats()
    launches, out, _ = counted_run(eng, frames)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok &= expect_launches(launches, BASE_LAUNCHES)
    ok &= check_outputs(out, eng.spec, batch, pose=True)
    hit = out["pose_trained_mask"]
    mixed = bool(hit.any() and not hit.all())
    same = same_leaves({k: out[k] for k in UPSTREAM_KEYS},
                       {k: ref_out[k] for k in UPSTREAM_KEYS})
    ok &= mixed and same
    log(f"  trained pose: hits {int(hit.sum())} of {hit.size} pose frames "
        f"(hits and misses: {mixed}); keypoints_model zero on misses "
        f"{bool((out['keypoints_model'][~hit] == 0).all())}; detect, SAM "
        f"and DINO outputs bit for bit the default run's (the YOLO file is "
        f"its weights) {same}  {'ok' if ok else 'FAIL'}")
    engine_record("trained pose", eng, frames, launches, peak_gb)
    return ok


def hd80_kernels(launches, batch: int = BATCH) -> bool:
    """The kernels of HD80_ROUTINES at ViT-H's shapes (16 heads of 80) in
    bf16: each launches its routine alone (torch.profiler's kernel names),
    agrees with its plain version on one image's slice (the batch's plain
    K3 would hold about 24 GB of f32 scores), and its device time (the
    profiler's, and by CUDA events around back-to-back calls) stands
    beside its bound, its plain version's time over the batch (the global
    ones in chunks of 24 heads) and one SDPA call; one ``kernel shape
    record`` line each."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {kid: (name, entry, layout) for kid, name, entry, layout, *_
               in KERNEL_TABLE}
    # K3, K4 and K5 run one routine on one set of operands
    args = kernel_inputs(entries["K3"][2], torch.bfloat16, batch, gen,
                         heads=16, hd=80)
    outs = [getattr(sa, entries[kid][1])(*args) for kid in ("K3", "K4", "K5")]
    ok = all(torch.equal(outs[0], o) for o in outs[1:])
    log(f"  K3, K4 and K5 at hd 80 {tuple(args[0].shape)}: outputs equal bit "
        f"for bit {ok}  {'ok' if ok else 'FAIL'}")
    del args, outs
    for kid, routine in HD80_ROUTINES.items():
        name, entry, layout = entries[kid]
        fn = getattr(sa, entry)
        args = kernel_inputs(layout, torch.bfloat16, batch, gen, heads=16,
                             hd=80)
        one = 25 if layout.startswith("window") else 16    # one image
        out = fn(*args)
        ref = plain_version(kid, tuple(a[:one] for a in args))()
        torch.cuda.synchronize()
        err, good = agree(f"{kid} hd 80", "bfloat16", out[:one], ref)
        names = kernel_names(lambda: fn(*args))
        alone = len(names) == 1 and routine in names[0]
        log(f"  {kid} hd 80 launches {names} (expected {routine} alone)  "
            f"{'ok' if alone else 'FAIL'}")
        ok &= good and alone
        reps = 5 if layout.startswith("global") else 20
        ms = device_ms(lambda: fn(*args), reps, only="lameness::")
        call = cuda_ms(lambda: fn(*args), reps)
        plain_ms = device_ms(plain_version(kid, args), 3)
        library = library_call(layout, args)
        lib = device_ms(library, 3)
        lib_call = cuda_ms(library, 3)
        del library
        flops, nbytes = kernel_work(layout, args)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS_S["bfloat16"] * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  {kid} hd 80: {call:.4f} ms by CUDA events, one SDPA call "
            f"{lib_call:.4f} ms: faster {call < lib_call}; bound share "
            f"{bound / call:.3f}")
        log("kernel shape record " + json.dumps({
            "id": kid, "name": name, "shapes": [tuple(a.shape) for a in args],
            "routine": names, "ms": ms, "call_ms": call,
            "launches": launches.get(name, 0), "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": bound / ms, "library_ms": lib,
            "library_cuda_ms": lib_call, "max_abs_err": err,
            "flops": flops, "bytes": nbytes}))
        del args, out, ref
        torch.cuda.empty_cache()
    return ok


def vit_h(frames, batch: int = BATCH) -> bool:
    """5c: the engine at SAM ViT-H (32 layers, 16 heads of 80) with seeded
    weights, by default and under the other VIT_H_SELECTIONS, and its
    kernels at hd 80."""
    import torch
    from lameness_tpu_torch.core.config import Config, SamConfig
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    t0 = time.perf_counter()
    eng = LamenessEngine(Config(sam=SamConfig(variant="vit_h")),
                         EngineSpec(),
                         generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    heads = eng.sam.vision_encoder.layer0.attn.heads
    log(f"  ViT-H engine init {time.perf_counter() - t0:.2f} s: "
        f"{sum(p.numel() for p in eng.sam.parameters()) / 1e6:.1f} M SAM "
        f"parameters, {heads} heads of {eng.sam.encoder_dim // heads}")
    with switches({}):
        eng.warmup(batch=batch)
    ok, ref, counts = True, None, {}
    for sel, env, expected in VIT_H_SELECTIONS:
        with switches(env):
            torch.cuda.reset_peak_memory_stats()
            launches, out, emb = counted_run(eng, frames)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            log(f"  ViT-H, {sel}: launches {json.dumps(launches)}")
            ok &= expect_launches(launches, expected)
            ok &= check_outputs(out, eng.spec, batch)
            counts.update({k: v for k, v in launches.items() if v})
            if ref is None:
                ref = out, emb
                engine_record("vit_h", eng, frames, launches, peak_gb)
                continue
            agreement = float((out["masks"] == ref[0]["masks"]).mean())
            rel = rel_l2(emb, ref[1])
            good = agreement >= 0.995 and rel <= EMB_RTOL
            ok &= good
            log(f"  ViT-H {sel} vs default: mask agreement {agreement:.5f} "
                f"(gate >= 0.995); SAM embeddings relative L2 error "
                f"{rel:.3e} (gate <= {EMB_RTOL:g}); every output bit for "
                f"bit {same_leaves(out, ref[0])}  {'ok' if good else 'FAIL'}")
    del eng, ref, out, emb
    torch.cuda.empty_cache()
    return ok & hd80_in_fresh_process(counts)


def hd80_in_fresh_process(launches) -> bool:
    """hd80_kernels in a process of its own (``chip_smoke.py --hd80``; the
    kernels are built already).  Late in a run, after the engines'
    profiled batches, torch.profiler has recorded no device event for one
    kernel call, and a fifth of the CUDA-event time over 5 calls (K3 at hd
    80 2.55 ms against 12.75); in a fresh process the two agree."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--hd80",
                          json.dumps(launches)], timeout=900)
    return res.returncode == 0


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------
# the serving stream: STREAM_JOBS jobs over STREAM_CLIPS clips held in
# memory, at each batch size (the serving batcher's max_batch of 4 first);
# the curation detector's chunks
STREAM_CLIPS = 8
STREAM_JOBS = 32
STREAM_BATCHES = (4, 2, 8)
CURATION_CHUNKS = (16, 48)
RESULT_KINDS = ("yolo", "sam3", "dinov3", "tleap", "tcn", "transformer")
TIMER_STAGES = ("decode", "transfer", "engine_stream", "readback",
                "write_results")
# the host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


class MemoryReader:
    """The stream's reader over clips held in memory: ``reader(path)`` for
    the clip named by the path's file name (up to its last "~"), with the
    ``info`` and ``read_selected`` of a decoder (RGB frames, no copy)."""

    def __init__(self, clips, fps: int = 25):
        self.clips, self.fps = clips, fps

    def __call__(self, path):
        frames = self.clips[path.name.split("~")[0]]
        fps = self.fps

        class Clip:
            info = {"width": frames.shape[2], "height": frames.shape[1],
                    "fps": fps, "total_frames": len(frames)}

            def read_selected(self, indices):
                return {i: frames[i] for i in indices if i < len(frames)}
        return Clip()


def default_engine():
    """The phase-3 default engine: the same construction and seed, so the
    same weights."""
    import torch
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    return LamenessEngine(Config(), EngineSpec(),
                          generator=torch.Generator().manual_seed(SEED))


# the synthetic cow of phase 6's clips: a bright textured block of COW_SIZE
# (w, h) frame pixels walking left to right over frames COW_FRAMES
COW_SIZE = (480, 300)
COW_FRAMES = (40, 100)
# how far, in logits, calibrate_yolo puts the frames with the cow above the
# engine's threshold (0.5) and the cow-free frames below curation's (0.3)
# -- no further: scores near 1 lose their order in float32 (sigmoid's
# slope), and equal scores let NMS keep other boxes on the card and the CPU
COW_MARGIN = 1.0
CURATION_LOGIT = float(np.log(0.3 / 0.7))


def walking_clip(rng, spec):
    """A clip of uniform noise in which a bright textured block (the "cow")
    walks left to right over the frames COW_FRAMES.  Returns the frames and
    the cow's box (x1, y1, x2, y2) in each frame, or None."""
    t, h, w = spec.clip_frames, spec.frame_height, spec.frame_width
    frames = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    cw, ch = COW_SIZE
    # a fixed bright texture of 6-pixel cells: no two of YOLO's cells on
    # the cow see the same pixels (a periodic pattern ties their scores)
    cells = np.random.default_rng(SEED).integers(
        170, 256, (-(-ch // 6), -(-cw // 6), 3), dtype=np.uint8)
    cow = cells.repeat(6, 0).repeat(6, 1)[:ch, :cw]
    y = (h - ch) // 2
    f0, f1 = COW_FRAMES
    boxes = [None] * t
    for i in range(f0, min(f1, t - 1) + 1):
        x = round((i - f0) * (w - cw) / (f1 - f0))
        frames[i, y:y + ch, x:x + cw] = cow
        boxes[i] = (x, y, x + cw, y + ch)
    return frames, boxes


def calibrate_yolo(eng, frames, boxes, margin: float = COW_MARGIN):
    """YOLO's cow class made to find the synthetic cow of ``walking_clip``.
    Seeded weights find no box on these frames (none reaches the engine's
    0.5 or curation's 0.3), and the stream's writer would then measure no
    mask.  A hit is made, not found, as for the pose model: on the level
    whose classification features (``cls1``) part the cow best, the cow
    kernel becomes the difference of the mean feature of the cells inside
    the cow and that of the cells of the cow-free frames, its bias puts the
    weakest frame with the cow ``margin`` logits above the engine's
    threshold and the strongest cow-free frame ``margin`` below curation's;
    the other levels' cow bias is -30.  Returns (the level, the gap between
    the two sides relative to the projections' spread, the largest cow
    logit); raises when no level parts them."""
    import torch
    from lameness_tpu_torch.ops import preprocess as prep
    s, cow = eng.spec, eng.config.yolo.cow_class_id
    feats = {i: [] for i in range(3)}
    hooks = [getattr(eng.yolo, f"detect{i}").cls1.register_forward_hook(
        lambda mod, inp, out, i=i: feats[i].append(out.float().cpu()))
        for i in range(3)]
    try:
        with torch.no_grad():
            for o in range(0, len(frames), 16):
                x = torch.from_numpy(np.ascontiguousarray(frames[o:o + 16]))
                canvas, ratio, pad = prep.letterbox(x.to(eng.device),
                                                    s.yolo_size)
                eng.yolo(canvas.to(s.dtype))
    finally:
        for h in hooks:
            h.remove()
    r, (px, py) = float(ratio[0]), pad[0].tolist()
    has = np.array([b is not None for b in boxes])
    best = None
    for i in range(3):
        f = torch.cat(feats[i])                          # (N, C, gh, gw)
        stride = s.yolo_size // f.shape[-1]
        cell = (torch.arange(f.shape[-1]) * stride).double()
        inside = torch.zeros(f.shape[0], f.shape[2], f.shape[3], dtype=bool)
        for n, b in enumerate(boxes):
            if b is not None:
                x1, y1, x2, y2 = (b[0] * r + px, b[1] * r + py,
                                  b[2] * r + px, b[3] * r + py)
                inside[n] = (((cell >= y1) & (cell + stride <= y2))[:, None]
                             & ((cell >= x1) & (cell + stride <= x2))[None])
        if not inside.flatten(1).any(1)[torch.from_numpy(has)].all():
            continue                  # a frame's cow covers no whole cell
        pos = f.permute(0, 2, 3, 1)[inside]
        free = f[torch.from_numpy(~has)]
        d = pos.mean(0) - free.mean((0, 2, 3))
        proj = torch.einsum("nchw,c->nhw", f, d)
        neg_top = float(proj[torch.from_numpy(~has)].max())
        pos_tops = torch.where(inside, proj, torch.full_like(proj, -1e30)
                               ).flatten(1).amax(1)[torch.from_numpy(has)]
        gap = float(pos_tops.min()) - neg_top
        rel = gap / float(proj.std())
        if best is None or rel > best[1]:
            best = (i, rel, d, neg_top, gap, float(proj.max()))
    if best is None or not best[4] > 0:
        raise RuntimeError(f"calibrate_yolo: no level parts the cow from "
                           f"the cow-free frames ({best and best[4]})")
    level, rel, d, neg_top, gap, top = best
    # logits k·(p - t): ``margin`` at the weakest frame with the cow,
    # CURATION_LOGIT - ``margin`` at the strongest cow-free one
    k = (2 * margin - CURATION_LOGIT) / gap
    t = neg_top + gap - margin / k
    with torch.no_grad():
        for i in range(3):
            head = getattr(eng.yolo, f"detect{i}").cls2
            if i == level:
                head.weight[cow] = (k * d).to(head.weight)[:, None, None]
                head.bias[cow] = -k * t
            else:
                head.weight[cow] = 0
                head.bias[cow] = -30.0
    return level, rel, k * (top - t)


def curation_detector(eng, clip) -> bool:
    """6a: the engine's YOLOv8-n at 640 as the batched curation detector
    over one 125-frame 720p clip: on the card in the engine's dtype at
    chunks 16 and 48 (frames/s, the copy in per chunk, dispatches), and in
    f32 on the card against the same f32 detector on the CPU."""
    import copy
    import torch
    from lameness_tpu_torch.core.streams import host_to_device
    from lameness_tpu_torch.models.yolo import decode_predictions
    from lameness_tpu_torch.ops import preprocess as prep
    from lameness_tpu_torch.video.curation import BatchedYoloDetector
    s = eng.spec
    ok = True
    runs = {}
    for chunk in CURATION_CHUNKS:
        det = BatchedYoloDetector(eng.yolo, size=s.yolo_size, chunk=chunk)
        det.detect_batch(clip, bgr=False)                 # warm
        times = []
        for _ in range(REPEATS):
            det.dispatches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = det.detect_batch(clip, bgr=False)
            times.append(time.perf_counter() - t0)
        want = -(-len(clip) // chunk)
        ok &= det.dispatches == want and len(got) == len(clip)
        h2d = []
        for o in range(0, len(clip), chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_to_device(clip[o:o + chunk], eng.device)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
        runs[chunk] = got
        log("curation record " + json.dumps({
            "chunk": chunk, "dtype": str(det.dtype),
            "dispatches": det.dispatches, "expected_dispatches": want,
            "s": [round(t, 4) for t in times],
            "frames_s": len(clip) / float(np.median(times)),
            "h2d_ms_per_chunk": float(np.median(h2d)),
            "detections": sum(d is not None for d in got)}))

    def boxes_of(sel):
        return np.array([d["bbox"] if d else [np.nan] * 4 for d in sel])
    # the f32 detector on the card against the same on the CPU: the None
    # pattern, and every anchor's decoded box and score before NMS (the
    # seeded head gives every anchor of a level the same box size and the
    # cow's anchors scores within 1e-6 of each other, so which equal-area
    # box NMS and _best_detection keep turns on float rounding: reported)
    gpu32 = copy.deepcopy(eng.yolo).float()
    cpu32 = copy.deepcopy(eng.yolo).float().cpu()
    card = BatchedYoloDetector(gpu32, size=s.yolo_size, chunk=16)
    host = BatchedYoloDetector(cpu32, size=s.yolo_size, chunk=16)
    a, b = card.detect_batch(clip, bgr=False), host.detect_batch(clip,
                                                                  bgr=False)
    same_none = [x is None for x in a] == [y is None for y in b]
    both = [i for i, (x, y) in enumerate(zip(a, b)) if x and y]
    picked = float(np.abs(boxes_of(a)[both] - boxes_of(b)[both]).max()) \
        if both else 0.0
    box_err = score_err = 0.0
    with torch.no_grad():
        for o in range(0, len(clip), 16):
            cand = []
            for model in (gpu32, cpu32):
                x = torch.from_numpy(clip[o:o + 16]).to(
                    model.stem.conv.weight.device)
                canvas = prep.letterbox(x, s.yolo_size)[0]
                boxes, scores, _ = decode_predictions(model(canvas)["levels"])
                cand.append((boxes.cpu(), scores.cpu()))
            box_err = max(box_err, float((cand[0][0] - cand[1][0]).abs()
                                         .max()))
            score_err = max(score_err, float((cand[0][1] - cand[1][1])
                                             .abs().max()))
    good = (same_none and box_err <= 1e-2 and score_err <= 1e-4
            and 0 < len(both) < len(a))
    ok &= good
    log(f"  curation f32, card against CPU: the same None pattern "
        f"{same_none} ({len(both)} frames with a detection of {len(a)}, "
        f"some and not all); every anchor before NMS: max box error "
        f"{box_err:.3e} px (gate <= 1e-2), score {score_err:.3e} (gate <= "
        f"1e-4)  {'ok' if good else 'FAIL'}; the picked boxes differ by "
        f"up to {picked:.3f} px (reported)")
    # the engine dtype's selections beside the f32 ones (reported)
    for chunk, sel in runs.items():
        agree_none = float(np.mean([(x is None) == (y is None)
                                    for x, y in zip(sel, a)]))
        both = [i for i, (x, y) in enumerate(zip(sel, a)) if x and y]
        err = float(np.abs(boxes_of(sel)[both] - boxes_of(a)[both]).max()) \
            if both else 0.0
        log(f"  curation {eng.spec.dtype} chunk {chunk} against f32: None "
            f"pattern agreement {agree_none:.4f}; max box difference "
            f"{err:.3f} px over {len(both)} frames (reported)")
    del gpu32, cpu32, card, host
    torch.cuda.empty_cache()
    return ok


def stream_gaps(prof, wall_s, batches: int):
    """From one profiled stream: the device's busy share over a batch (from
    the last but one batch's frame copy in to the last one's), the share
    of each frame copy in and readback that overlaps kernels, the device's
    idle time before each frame copy, the largest idle gap in the window,
    and the host's calls that wait for the device (SYNC_CALLS), per batch.
    None when the profiler recorded no device events."""
    import torch
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None

    def span(e):
        return e.time_range.start, e.time_range.end
    h2d = sorted(span(e) for e in dev if "HtoD" in e.name)
    d2h = sorted(span(e) for e in dev if "DtoH" in e.name)
    compute = sorted(span(e) for e in dev if "Memcpy" not in e.name)
    frames_in = [iv for iv in h2d if iv[1] - iv[0] > 1000]   # > 1 ms

    def union(ivs):
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    busy = union([span(e) for e in dev])
    kern = union(compute)

    def covered(iv, by):
        a, b = iv
        return sum(max(0, min(b, y) - max(a, x)) for x, y in by) / max(
            b - a, 1e-9)

    def idle_before(iv):
        ends = [b for a, b in kern if b <= iv[0]]
        return (iv[0] - max(ends)) / 1e3 if ends else None
    syncs = [e for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name in SYNC_CALLS]

    def ancestors(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            out.append(e)
        return out
    rec = {"frame_copies_in": len(frames_in),
           "copy_in_ms": [round((b - a) / 1e3, 3) for a, b in frames_in],
           "copy_in_overlapped": [round(covered(iv, kern), 3)
                                  for iv in frames_in],
           "device_idle_before_copy_in_ms": [
               None if idle_before(iv) is None else round(idle_before(iv), 3)
               for iv in frames_in],
           "readbacks_overlapped": [round(covered(iv, kern), 3)
                                    for iv in d2h if iv[1] - iv[0] > 20],
           "device_busy_share_of_stream": sum(b - a for a, b in busy)
           / (wall_s * 1e6),
           "host_syncs_per_batch": len(syncs) / batches,
           "host_sync_ms_per_batch": sum(
               e.time_range.end - e.time_range.start for e in syncs)
           / 1e3 / batches,
           "host_syncs_by_call": {n: sum(e.name == n for e in syncs)
                                  for n in SYNC_CALLS},
           "host_syncs_under": sorted(collections.Counter(
               " < ".join(a.name for a in ancestors(e)[:3])
               for e in syncs).items(), key=lambda kv: -kv[1])[:8]}
    if len(frames_in) >= 2:
        w0, w1 = frames_in[-2][0], frames_in[-1][0]
        inside = [(max(a, w0), min(b, w1)) for a, b in busy
                  if b > w0 and a < w1]
        gaps = [b2 - a2 for (_, a2), (b2, _) in zip(inside[:-1], inside[1:])]
        rec.update({"batch_window_ms": (w1 - w0) / 1e3,
                    "device_busy_share_of_batch":
                        sum(b - a for a, b in inside) / (w1 - w0),
                    "largest_idle_gap_ms": max(gaps, default=0) / 1e3})
    return rec


def writer_costs(drv, outs) -> None:
    """The writer's mask features (``_mask_features`` at 1280x720) on the
    stream's measured masks, ms a mask, beside their 8-connected
    components, and on an ellipse (a cow-like blob) of the same size."""
    from scipy import ndimage
    from lameness_tpu_torch.serve.contours import resize_nearest
    info = {"width": 1280, "height": 720, "fps": 25, "total_frames": 125}
    masks = [o["masks"][t] for o in outs.values()
             for t in np.flatnonzero(o["primary_valid"])]
    yy, xx = np.mgrid[:256, :256]
    blob = ((yy - 128) ** 2 / 60 ** 2 + (xx - 128) ** 2 / 90 ** 2 < 1)

    def ms(m):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            drv._mask_features(m.astype(np.uint8), info)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)
    each = [ms(m) for m in masks]
    comps = [ndimage.label(resize_nearest(m, 1280, 720),
                           structure=np.ones((3, 3), int))[1] for m in masks]
    log("writer record " + json.dumps({
        "masks": len(masks), "mask_features_ms_p50": float(np.median(each))
        if each else None, "mask_features_ms_max": max(each, default=None),
        "components_p50": float(np.median(comps)) if comps else None,
        "fill_p50": float(np.median([m.mean() for m in masks]))
        if masks else None, "blob_ms": ms(blob)}))


def sync_sites(eng, frames) -> list:
    """Where the host waits for the device in one batch of the stream's
    consumer (the transfer on the copy-in stream, the stages, the packed
    output and its copy out): PyTorch's CUDA sync debug mode warns at each
    synchronising call; the count by message and the port's source line
    nearest to it."""
    import traceback
    import warnings
    import torch
    from lameness_tpu_torch.core.streams import Overlap
    lanes = Overlap(eng.device)
    torch.cuda.synchronize()
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return                      # the mode's own notice
        here = [f"{f.filename.split('lameness_tpu_torch/')[-1]}:{f.lineno}"
                for f in traceback.extract_stack()
                if "lameness_tpu_torch" in f.filename]
        sites[here[-1] if here else f"{filename}:{lineno}"] += 1
    saved = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fd = lanes.put(lambda: eng.to_device(frames))
            out = eng.process_clip_batch(fd, readback=False)
            flat, _ = eng.pack_output(out)
            lanes.fetch([flat])()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = saved
    return sorted(sites.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def per_call_constants():
    """The engine's small constant tensors made from host data at each call
    (as before the port cached them), each copy to the card synchronising
    the stream: the comparison for the stream's overlap."""
    from lameness_tpu_torch.core import device as dev_mod
    from lameness_tpu_torch.ops import sam_attention as sa
    cached, index = dev_mod._constant, sa._rel_index
    dev_mod._constant = cached.__wrapped__
    sa._rel_index = index.__wrapped__
    try:
        yield
    finally:
        dev_mod._constant, sa._rel_index = cached, index


def serve_stream(eng, clips, keep_root=None) -> bool:
    """6b: ``PipelineDriver.process_stream`` on the default engine over
    STREAM_JOBS jobs of the 125-frame 720p ``clips`` held in memory, at each
    of STREAM_BATCHES (batch_size = pad_to), each into a fresh data root
    (the one of B = 4 copied to ``keep_root``, mtimes kept, for phase 7);
    the serial path (process_clip_batch, then the writer) at B = 2 and 4;
    profiled streams at B = 4, with the engine's constants cached and made
    at each call."""
    import tempfile
    from pathlib import Path
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.ops._cuda import KERNELS
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.utils.timing import TIMERS
    reader = MemoryReader(clips, fps=eng.spec.fps)
    names = sorted(clips)
    jobs = [(f"{n[:-4]}_{r}", Path(f"{n}~{r}")) for r in
            range(-(-STREAM_JOBS // len(names))) for n in names][:STREAM_JOBS]
    keep = ("masks", "embeddings", "det_boxes", "det_valid", "keypoints",
            "primary_valid")
    ok, files, outs, rates = True, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def driver(tag):
            drv = PipelineDriver(config=Config(dirs=DataDirs(
                root=f"{tmp}/{tag}")), engine=eng, reader=reader)
            seen = outs.setdefault(tag, {})
            write = drv._write_stage_results

            def capture(video_id, out, bi, scale, info):
                seen[video_id] = {k: np.array(out[k][bi]) for k in keep}
                return write(video_id, out, bi, scale, info)
            drv._write_stage_results = capture
            return drv

        def read_files(drv, tag):
            good = True
            files[tag] = {}
            for vid, _ in jobs:
                for kind in RESULT_KINDS:
                    path = drv.dirs.results_for(kind) / f"{vid}_{kind}.json"
                    if not path.exists():
                        log(f"  {tag}: missing {path.name}")
                        good = False
                        continue
                    files[tag][path.name] = path.read_bytes()
                    missing = schemas.validate(kind, json.loads(
                        files[tag][path.name]))
                    if missing:
                        log(f"  {tag}: {path.name} misses {missing}")
                        good = False
            return good

        for b in STREAM_BATCHES:
            eng.warmup(batch=b)
            launches = counted_run(eng, np.stack(
                [clips[n] for n in names[:b]]))[0]
            ok &= expect_launches(launches, BASE_LAUNCHES)
            log(f"  counted_run at B={b}: "
                + json.dumps({k: v for k, v in launches.items() if v}))
            drv = driver(f"stream{b}")
            TIMERS.reset()
            for k in KERNELS.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = drv.process_stream(jobs, batch_size=b, pad_to=b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {name: k.launches for name, k in KERNELS.items()}
            n_batches = -(-STREAM_JOBS // b)
            ok &= expect_launches(counts, {k: v * n_batches for k, v in
                                           BASE_LAUNCHES.items()})
            good = len(res) == STREAM_JOBS and read_files(drv, f"stream{b}")
            ok &= good
            summ = TIMERS.summary()
            rates[b] = STREAM_JOBS / wall
            log("stream record " + json.dumps({
                "batch": b, "clips": STREAM_JOBS, "wall_s": wall,
                "clips_s": rates[b],
                "launches": {k: v for k, v in counts.items() if v},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "timers": {k: {"count": summ[k]["count"],
                               "mean_s": summ[k]["mean_s"],
                               "p50_s": summ[k]["p50_s"],
                               "total_s": summ[k]["mean_s"]
                               * summ[k]["count"]}
                           for k in TIMER_STAGES if k in summ},
                "masks_measured": int(sum(o["primary_valid"].sum() for o in
                                          outs[f"stream{b}"].values())),
                "files_ok": good}))

        # the serial path: process_clip_batch (transfer, stages, blocking
        # readback), then the writer, batch after batch
        for b in (2, 4):
            drv = driver(f"serial{b}")
            TIMERS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for o in range(0, STREAM_JOBS, b):
                loaded = [drv._load_engine_frames(p) for _, p in
                          jobs[o:o + b]]
                out = eng.process_clip_batch(np.concatenate(
                    [f for f, _, _ in loaded]))
                for bi, ((vid, _), (_, scale, info)) in enumerate(
                        zip(jobs[o:o + b], loaded)):
                    drv._write_stage_results(vid, out, bi, scale, info)
            wall = time.perf_counter() - t0
            ok &= read_files(drv, f"serial{b}")
            wr = TIMERS.summary().get("write_results", {})
            log("serial record " + json.dumps({
                "batch": b, "wall_s": wall, "clips_s": STREAM_JOBS / wall,
                "write_results_mean_s": wr.get("mean_s"),
                "stream_over_serial": rates[b] / (STREAM_JOBS / wall)}))
        same = files["stream2"] == files["serial2"]
        ok &= same
        log(f"  stream at B=2 against the serial path: every result file "
            f"byte for byte the same {same} ({len(files['stream2'])} files)"
            f"  {'ok' if same else 'FAIL'}")

        # across batch sizes, the engine outputs behind the yolo, sam3,
        # dinov3 and tleap files under phase 3's gates (masks, embeddings),
        # the detection flags and the keypoints (relative L2).  tcn and
        # transformer only validate: MC-dropout draws follow the batch's
        # shape
        ref = outs["stream2"]
        for b in (4, 8):
            got = outs[f"stream{b}"]
            masks = min(float((got[v]["masks"] == ref[v]["masks"]).mean())
                        for v in ref)
            emb = max(rel_l2(torch.from_numpy(got[v]["embeddings"]),
                             torch.from_numpy(ref[v]["embeddings"]))
                      for v in ref)
            valid = min(float((got[v]["det_valid"] == ref[v]["det_valid"]
                               ).mean()) for v in ref)
            kp = max(rel_l2(torch.from_numpy(got[v]["keypoints"]),
                            torch.from_numpy(ref[v]["keypoints"]))
                     for v in ref)
            g = np.concatenate([got[v]["det_boxes"][got[v]["det_valid"]
                                                    & ref[v]["det_valid"]]
                                for v in ref])
            r = np.concatenate([ref[v]["det_boxes"][got[v]["det_valid"]
                                                    & ref[v]["det_valid"]]
                                for v in ref])
            box = rel_l2(torch.from_numpy(g), torch.from_numpy(r)) \
                if len(r) else float("nan")
            good = (masks >= 0.995 and emb <= EMB_RTOL and kp <= EMB_RTOL
                    and len(r) > 0 and valid >= 0.99)
            ok &= good
            same = {k: files[f"stream{b}"][n] == files["stream2"][n]
                    for k in RESULT_KINDS for n in [f"{jobs[0][0]}_{k}.json"]}
            log(f"  stream B={b} against B=2: mask agreement (worst clip) "
                f"{masks:.5f} (>= 0.995); DINO embeddings relative L2 "
                f"{emb:.3e}, keypoints {kp:.3e} (each <= {EMB_RTOL:g}); "
                f"detection flags agreement {valid:.4f} (>= 0.99); "
                f"detection boxes {box:.3e} over {len(r)} (reported: which "
                f"equal-area box NMS keeps turns on bf16 rounding, as in "
                f"6a); first clip's files byte "
                f"for byte {json.dumps(same)}  {'ok' if good else 'FAIL'}")

        if keep_root is not None:
            shutil.copytree(f"{tmp}/stream4", keep_root)
        writer_costs(driver("writer"), outs["stream2"])

        four = np.stack([clips[n][eng.spec.packed_idx] for n in names[:4]])
        log("stream sync sites " + json.dumps(sync_sites(eng, four)))
        with per_call_constants():
            log("stream sync sites, constants made at each call "
                + json.dumps(sync_sites(eng, four)))

        # profiled streams at the serving batcher's B = 4, three batches:
        # as the port runs, and with the constants made at each call
        for tag, ctx in (("cached constants", contextlib.nullcontext),
                         ("constants made at each call", per_call_constants)):
            drv = driver(f"profiled {tag}")
            with ctx():
                drv.process_stream(jobs[:4], batch_size=4, pad_to=4)  # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    drv.process_stream(jobs[:12], batch_size=4, pad_to=4)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            rec = stream_gaps(prof, wall, 3)
            log("stream profile " + json.dumps({
                "engine": tag, "batch": 4, "clips": 12, "wall_s": wall,
                "clips_s": 12 / wall, **(rec or {"device": "not measured"})}))
    return ok


def small_stream_files(dev, root, clips):
    """The tiny engine of ``check_small_engine`` (128² SAM, dropout 0) on
    ``dev`` streaming ``clips`` at batch_size=2 into ``root``: {file name:
    parsed JSON} and {video id: engine outputs}."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.pipeline.engine import make_test_engine
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.weights import seeded_state_dict
    gen = torch.Generator().manual_seed(SEED)
    eng = make_test_engine(device=dev, with_sam=True, generator=gen)
    eng.tcn = TCN(input_dim=44, dropout=0.0, device=dev)
    eng.gait = GaitTransformer(input_dim=44, dropout=0.0, device=dev)
    eng.load_state_dicts({"tcn": seeded_state_dict(eng.tcn, gen),
                          "gait": seeded_state_dict(eng.gait, gen)})
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         engine=eng, reader=MemoryReader(clips, fps=5))
    outs = {}
    write = drv._write_stage_results

    def capture(video_id, out, bi, scale, info):
        outs[video_id] = {k: v[bi] for k, v in leaves(out)}
        return write(video_id, out, bi, scale, info)
    drv._write_stage_results = capture
    drv.process_stream([(n[:-4], Path(n)) for n in clips], batch_size=2)
    files = {p.name: json.loads(p.read_text())
             for p in sorted(Path(root).glob("results/*/*.json"))}
    return files, outs


def json_leaves(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from json_leaves(v, f"{prefix}.{k}")
    elif isinstance(obj, list):
        yield prefix + "#len", len(obj)
        for i, v in enumerate(obj):
            yield from json_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def check_small_stream() -> bool:
    """The tiny engine's stream (three 15-frame 160x90 clips, B = 2 and a
    trailing batch of one) on the card against the same on the CPU: the
    outputs behind the files under check_small_engine's gates; the files'
    keys and list lengths equal and their numbers within 1e-4, those of a
    sam3 file only where the clip's masks are equal bit for bit."""
    import tempfile
    rng = np.random.default_rng(SEED)
    clips = {f"t{i}.mp4": rng.integers(0, 256, (15, 90, 160, 3),
                                       dtype=np.uint8) for i in range(3)}
    with tempfile.TemporaryDirectory() as tmp:
        cpu = small_stream_files("cpu", f"{tmp}/cpu", clips)
        gpu = small_stream_files("cuda", f"{tmp}/cuda", clips)
    ok = set(cpu[0]) == set(gpu[0]) and len(cpu[0]) == 6 * len(clips)
    worst, masks = 0.0, 1.0
    for vid, a in cpu[1].items():
        b = gpu[1][vid]
        for key, x in a.items():
            y = b[key]
            if key == "masks":
                masks = min(masks, float((x == y).mean()))
            elif x.dtype == bool or np.issubdtype(x.dtype, np.integer):
                ok &= bool(np.array_equal(x, y))
            else:
                tol = 1e-3 if key == "mask_iou_pred" else 1e-4
                err = float(np.abs(x.astype(np.float64) - y).max())
                ok &= err <= tol
                worst = max(worst, err)
    ok &= masks >= 0.995
    file_err, compared = 0.0, 0
    for name, want in cpu[0].items():
        w, g = dict(json_leaves(want)), dict(json_leaves(gpu[0][name]))
        ok &= list(w) == list(g)
        vid = name.rsplit("_", 1)[0]
        if name.endswith("_sam3.json") and not np.array_equal(
                cpu[1][vid]["masks"], gpu[1][vid]["masks"]):
            continue
        compared += 1
        for key, x in w.items():
            if isinstance(x, float) and key in g:
                file_err = max(file_err, abs(x - g[key]))
    ok &= file_err <= 1e-4
    log(f"small stream card vs CPU: {len(cpu[0])} files; outputs max_abs_err"
        f" {worst:.3e}, mask agreement {masks:.5f}; {compared} files "
        f"compared number by number, max_abs_err {file_err:.3e}  "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------
# the graph heads' full-width graph: 16 cows x 8 videos = max_nodes (128)
COWS, VIDEOS_PER_COW = 16, 8
WALK_COWS = 4             # 7b's tracked videos: 4 cows x 8
LOCO_KEYS = ("back_arch_mean", "back_arch_std", "back_arch_score",
             "head_bob_magnitude", "head_bob_frequency", "head_bob_score",
             "stride_fl_mean", "stride_fr_mean", "stride_rl_mean",
             "stride_rr_mean", "front_leg_asymmetry", "rear_leg_asymmetry")


def write_cow_videos(root, cows: int = COWS, per_cow: int = VIDEOS_PER_COW,
                     seed: int = SEED, dim: int = 768,
                     tracking: bool = True, fps: int = 25,
                     frames: int = 125) -> list:
    """The result files of ``cows`` x ``per_cow`` videos as the stream
    writes them (yolo, sam3, dinov3, tleap, tcn, transformer), built with
    the port's schema builders from a seeded generator, into the data root
    ``root``; with ``tracking``, a tracking file naming each video's cow
    too.  Each cow has its own mean of the shape and gait features and its
    own DINO embedding, which its videos scatter around (relative noise
    0.3: cosine about 0.92 within a cow, about 0 across).  The yolo file
    holds one box a detection frame (every fps // 2), walking 2 px a frame,
    which ByteTrack confirms as one track.  Returns the video ids."""
    from lameness_tpu_torch.core.config import DataDirs
    from lameness_tpu_torch.io import schemas
    rng = np.random.default_rng(seed)
    dirs = DataDirs(root=str(root))
    centers = rng.standard_normal((cows, dim))
    gait = rng.uniform(0.1, 1.0, (cows, len(LOCO_KEYS)))
    shape = rng.uniform(0.2, 1.0, (cows, 4))
    vids = []
    for c in range(cows):
        for v in range(per_cow):
            vid = f"cow{c:02d}_v{v}"
            vids.append(vid)

            def write(kind, obj):
                schemas.write_result(
                    dirs.results_for(kind) / f"{vid}_{kind}.json", obj)
            det_frames = list(range(0, frames, max(1, fps // 2)))
            x0, y0 = rng.uniform(0, 400), rng.uniform(100, 300)
            boxes = np.array([[x0 + 2 * f, y0, x0 + 2 * f + 480, y0 + 300]
                              for f in det_frames])
            confs = rng.uniform(0.7, 0.95, len(det_frames))
            write("yolo", schemas.yolo_result(
                [schemas.yolo_frame_entry(f, fps, [
                    schemas.yolo_detection_entry(f, b, s, "cow", 19)])
                 for f, b, s in zip(det_frames, boxes, confs)],
                schemas.yolo_features(boxes, confs, len(det_frames), frames),
                frames, fps))
            feats = [schemas.sam3_frame_features(
                1.44e5 * a, a, ci, asp, 640.0, 360.0, 1500.0, f, fps)
                for f, (a, ci, asp) in zip(det_frames, shape[c, :3]
                                           * rng.uniform(0.9, 1.1, (len(
                                               det_frames), 3)))]
            write("sam3", schemas.sam3_result(
                [schemas.sam3_segmentation_entry(f["frame"], fps, True, f)
                 for f in feats], schemas.sam3_aggregated(feats), frames,
                fps))
            embs = centers[c] + 0.3 * rng.standard_normal((frames // fps,
                                                           dim))
            write("dinov3", schemas.dinov3_result(
                vid, embs.mean(axis=0), len(embs), [], 0.5,
                [schemas.dinov3_embedding_entry(i * fps, fps, e)
                 for i, e in enumerate(embs)]))
            loco = dict(zip(LOCO_KEYS, (gait[c] * rng.uniform(
                0.9, 1.1, len(LOCO_KEYS))).tolist()))
            write("tleap", schemas.tleap_result(
                vid, frames, fps, [], loco, "heuristic", [], [], {}))
            sev = float(np.clip(gait[c].mean() + rng.normal(0, 0.05), 0, 1))
            write("tcn", schemas.tcn_result(vid, sev, 0.05, frames, 44, 29))
            write("transformer", schemas.transformer_result(
                vid, sev, 0.05, frames, 44, 0, rng.uniform(0, 1, 20), 64, 4,
                4))
            if tracking:
                write("tracking", {
                    **schemas.tracking_result(vid, [], [], {}),
                    "reid_results": [schemas.reid_entry(
                        0, f"COW-{c + 1:04d}", f"identity-{c}", 0.9, 1.0,
                        v == 0)]})
    return vids


GRAPH_TOL = 1e-4          # card against CPU, f32 with TF32 off
BOX_TOL = 1e-4            # the device tracker's boxes, card against CPU
GRAPH_REPS = 3            # timed process_video calls a target
ANALYSIS_TS = "2026-01-01T00:00:00+00:00"


def graph_runner(root, device, **kw):
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.graph_runner import GraphHeadRunner
    return GraphHeadRunner(Config(dirs=DataDirs(root=str(root))),
                           device=device, **kw)


def zero_dropout(runner):
    """``runner`` with dropout-0 heads holding its heads' weights (dropout
    has no parameters), so its MC samples are equal; returns it."""
    from lameness_tpu_torch.models.graphgps import EnhancedGraphGPS
    from lameness_tpu_torch.models.graphormer import CowLamenessGraphormer
    for name, cls in (("gnn", EnhancedGraphGPS), ("gt", CowLamenessGraphormer)):
        head = cls(dropout=0.0, device=runner.device).eval()
        head.load_state_dict(getattr(runner, name).state_dict())
        setattr(runner, name, head)
    return runner


def head_outputs(runner, target) -> dict:
    """Both heads' deterministic outputs on ``target``'s graph (numpy)."""
    import torch
    g = runner.build_graph(target)[0]
    with torch.no_grad():
        outs = {"gnn": runner.gnn(*runner._gnn_args(g)),
                "gt": runner.gt(*runner._gt_args(g))}
    return {f"{h}.{k}": v[0].cpu().numpy() for h, o in outs.items()
            for k, v in o.items() if k != "multi_scale_repr"}


def json_diff(got, want):
    """(max |difference| over the float leaves, whether every other leaf
    and the key structure are equal)."""
    g, w = dict(json_leaves(got)), dict(json_leaves(want))
    same = list(g) == list(w)
    err = 0.0
    for key, x in w.items():
        if isinstance(x, float) and isinstance(g.get(key), float):
            err = max(err, abs(g[key] - x))
        else:
            same &= g.get(key) == x
    return err, same


def graph_card_vs_cpu(root, targets) -> bool:
    """The graph heads on the card against the same runner on the CPU, with
    the same seeded weights, for each of ``targets`` ({name: video id}):
    the deterministic outputs (cow severity, node predictions, attention
    weights) within GRAPH_TOL; with dropout-0 heads, the two result files'
    numbers within GRAPH_TOL and everything else (ids, neighbour lists and
    orders) equal; with dropout, two card runs give the same files and the
    MC std is above 0."""
    card, cpu = graph_runner(root, "cuda"), graph_runner(root, "cpu")
    card0 = zero_dropout(graph_runner(root, "cuda"))
    cpu0 = zero_dropout(graph_runner(root, "cpu"))
    ok = True
    for name, target in targets.items():
        a, b = head_outputs(card, target), head_outputs(cpu, target)
        det = max(float(np.abs(a[k] - b[k]).max()) for k in a)
        files = [json_diff(card0.process_video(target)[k],
                           cpu0.process_video(target)[k])
                 for k in ("gnn", "graph_transformer")]
        file_err = max(e for e, _ in files)
        same = all(s for _, s in files)
        runs = [card.process_video(target) for _ in range(2)]
        std = min(runs[0]["gnn"]["uncertainty"],
                  runs[0]["graph_transformer"]["uncertainty"])
        good = (det <= GRAPH_TOL and file_err <= GRAPH_TOL and same
                and runs[0] == runs[1] and std > 0)
        ok &= good
        log(f"  graph heads {name} ({runs[0]['gnn']['graph_info']['num_nodes']}"
            f" nodes), card vs CPU: deterministic outputs max_abs_err "
            f"{det:.3e}; dropout-0 files max_abs_err {file_err:.3e}, ids and "
            f"neighbours equal {same}; MC runs equal {runs[0] == runs[1]}, "
            f"std (gnn, graph_transformer) {runs[0]['gnn']['uncertainty']:.4g}"
            f", {runs[0]['graph_transformer']['uncertainty']:.4g}  "
            f"{'ok' if good else 'FAIL'}")
    return ok


def kernel_events(fn):
    """(device kernels, copies) one call of ``fn`` puts on the card, and
    their summed device ms (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum("Memcpy" in e.name or "Memset" in e.name for e in dev)
    return len(dev) - copies, copies, sum(
        e.time_range.end - e.time_range.start for e in dev) / 1e3


def busy_share(fn):
    """Wall ms of one call of ``fn`` under torch.profiler and the share of
    it the card was busy (the union of its kernels' and copies' spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return wall * 1e3, None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return wall * 1e3, busy / (wall * 1e6)


def graph_record(runner, name, target) -> dict:
    """One target's process_video on the card: wall ms (median of
    GRAPH_REPS), the host parts (collect, graph build, PEs, SPD: host
    clock), each head's MC and deterministic forward (CUDA events), the
    kernel launches of each forward, the device busy share and the peak MB
    it adds to what was allocated before it."""
    import torch
    torch.cuda.synchronize()

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    from lameness_tpu_torch.graph import build as gb
    (vids, feats, embs, cows, ts), collect = host_ms(
        lambda: runner.collect_graph(target))

    def build_graph():
        g = gb.build_dense_graph(np.stack(feats), np.stack(embs), vids, cows,
                                 ts, runner.config.graphgps.k_nn,
                                 runner.max_nodes)
        g["x"] = gb.standardize_features(g["x"], g["node_mask"])
        return g
    g, build = host_ms(build_graph)
    gnn_args, pes = host_ms(lambda: runner._gnn_args(g))
    gt_args, spd = host_ms(lambda: runner._gt_args(g))
    gen = runner._mc_generator(target)
    forwards = {
        "gnn_mc": lambda: runner.gnn(*gnn_args, generator=gen, samples=10),
        "gnn_det": lambda: runner.gnn(*gnn_args),
        "gt_mc": lambda: runner.gt(*gt_args, generator=gen, samples=10),
        "gt_det": lambda: runner.gt(*gt_args)}
    device, launches, kernel_ms = {}, {}, {}
    with torch.no_grad():
        for key, fn in forwards.items():
            device[key] = cuda_ms(fn, GRAPH_REPS)
            launches[key], _, kernel_ms[key] = kernel_events(fn)
    walls = []
    for _ in range(GRAPH_REPS):
        torch.cuda.synchronize()
        walls.append(host_ms(lambda: runner.process_video(target))[1])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    wall, share = busy_share(lambda: runner.process_video(target))
    return {"graph": name, "nodes": int(g["node_mask"].sum()),
            "process_video_ms": float(np.median(walls)),
            "process_video_ms_all": walls,
            "host_ms": {"collect": collect, "build": build, "pes": pes,
                        "spd": spd},
            "device_ms_cuda_events": device,
            "device_kernel_ms": kernel_ms, "launches": launches,
            "profiled_wall_ms": wall, "device_busy_share": share,
            "peak_mb": (torch.cuda.max_memory_allocated() - before) / 2 ** 20,
            "allocated_before_mb": before / 2 ** 20}


def graph_heads(tmp) -> bool:
    """7a: the graph heads at full width (128 nodes, 10 MC samples) over
    COWS x VIDEOS_PER_COW written videos: the global graph (a target with
    no tracking file) and a per-cow graph, card against CPU, and each
    one's record."""
    root = f"{tmp}/graph"
    vids = write_cow_videos(root)
    os.unlink(f"{root}/results/tracking/{vids[-1]}_tracking.json")
    targets = {"global": vids[-1], "per_cow": vids[0]}
    ok = graph_card_vs_cpu(root, targets)
    card = graph_runner(root, "cuda")
    for name, target in targets.items():
        log("graph record " + json.dumps(graph_record(card, name, target)))
    return ok


def back_half(root, data: str, cows: bool = False) -> bool:
    """7b: the back half of ``process_video_file`` over every video of the
    data root ``root`` (``data`` names it in the record): run_tracking
    (host), the graph heads, run_ml, fusion, each under its stage timer as
    process_video_file times them.  Every file must validate and every
    fusion file name the five automated predictors.  With ``cows`` (videos
    of ``write_cow_videos(tracking=False)``, whose walking boxes ByteTrack
    confirms), every video must also be tracked, Re-ID must name the cow it
    was written for (COW-0001 for cow00, in order of first sight), and its
    gnn file must come from the per-cow graph."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.fuse.fusion import AUTO_KEYS
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.utils.timing import TIMERS
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         device="cuda")
    vids = sorted(p.name[:-len("_dinov3.json")] for p in
                  drv.dirs.results_for("dinov3").glob("*_dinov3.json"))
    drv._ensure_graph_runner().process_video(vids[0])      # warm up
    TIMERS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for vid in vids:
        drv.run_tracking(vid)
        with TIMERS.time("graph_heads"):
            drv._ensure_graph_runner().process_video(vid)
        with TIMERS.time("ml"):
            drv.run_ml(vid)
        with TIMERS.time("fusion"):
            drv.fusion.process_video(vid, timestamp=ANALYSIS_TS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok, bad = True, []
    for vid in vids:
        for kind in ("tracking", "gnn", "graph_transformer", "ml", "fusion"):
            path = Path(drv.dirs.results_for(kind)) / f"{vid}_{kind}.json"
            obj = json.loads(path.read_text()) if path.exists() else {}
            missing = schemas.validate(kind, obj)
            if kind == "fusion" and not missing:
                got = obj["fusion_result"]["pipeline_contributions"]
                missing = [k for k in AUTO_KEYS if k not in got]
            if missing:
                bad.append((path.name, missing))
    ok = not bad
    summ = TIMERS.summary()
    drv.bus.shutdown()

    def read(kind, vid):
        return json.loads((Path(drv.dirs.results_for(kind))
                           / f"{vid}_{kind}.json").read_text())
    reid = {v: [r["cow_id"] for r in read("tracking", v)["reid_results"]]
            for v in vids}
    tracked = sum(bool(r) for r in reid.values())
    per_cow = sum(read("gnn", v)["graph_info"]["per_cow_graph"] for v in vids)
    named = sum(r[:1] == [f"COW-{int(v[3:5]) + 1:04d}"]
                for v, r in reid.items()) if cows else None
    if cows:
        ok &= tracked == per_cow == named == len(vids)
    log("back half record " + json.dumps({
        "data": data, "clips": len(vids), "wall_s": wall,
        "clips_s": len(vids) / wall,
        "s_per_clip": {k: summ[k]["mean_s"] for k in
                       ("tracking", "graph_heads", "ml", "fusion")},
        "tracked": tracked, "per_cow_graphs": per_cow,
        "reid_named_its_cow": named}))
    log(f"  back half over {data} ({len(vids)} clips): "
        f"{5 * len(vids) - len(bad)} of {5 * len(vids)} files valid, every "
        f"fusion file with the five automated predictors {not bad}; tracked "
        f"{tracked}, per-cow graphs {per_cow}, Re-ID named its cow {named}"
        f"{' (all gated)' if cows else ''}  "
        f"{'ok' if ok else 'FAIL ' + str(bad[:4])}")
    return ok


def tracker_outputs_close(a, b):
    same = all(np.array_equal(a[k], b[k])
               for k in ("track_id", "state", "confirmed"))
    return same, float(np.abs(a["boxes"] - b["boxes"]).max())


def device_tracker(root, block_boxes) -> bool:
    """7c: the device tracker on the card against the same on the CPU over
    the detections of every distinct clip of ``root`` (ids and states equal,
    boxes within BOX_TOL), ms and launches a clip, the driver's
    ``run_tracking(backend="device")``; and, on phase 6's block walking
    (its box at every frame), the same confirmed tracks as the host
    ByteTracker: the same number in every frame and the same frame spans."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.track import device_tracker as dt
    from lameness_tpu_torch.track.bytetrack import ByteTracker, Detection
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         device="cuda")
    clips = {}                  # the distinct clips' detections (phase 6
    for f in sorted(Path(drv.dirs.results_for("yolo")).glob("*_yolo.json")):
        entries = json.loads(f.read_text())["detections"]  # repeats them)
        clips.setdefault(json.dumps(entries), (f.name[:-len("_yolo.json")],
                                               entries))
    ok, worst, same_all, ms, launches = True, 0.0, True, [], []
    for vid, entries in clips.values():
        boxes, scores, valid, _ = dt.pack_detection_frames(entries)
        outs = {}
        for dev in ("cuda", "cpu"):
            _, o = dt.track_clip(boxes, scores, valid, device=dev)
            outs[dev] = {k: v.cpu().numpy() for k, v in o.items()}
        same, err = tracker_outputs_close(outs["cuda"], outs["cpu"])
        same_all &= same
        worst = max(worst, err)
        ms.append(cuda_ms(lambda: dt.track_clip(boxes, scores, valid,
                                                device="cuda"), 3))
        launches.append(kernel_events(lambda: dt.track_clip(
            boxes, scores, valid, device="cuda"))[:2])
        res = drv.run_tracking(vid, backend="device")
        ok &= not schemas.validate("tracking", res) \
            and res["statistics"]["backend"] == "device"
    ok &= same_all and worst <= BOX_TOL
    drv.bus.shutdown()
    log("device tracker record " + json.dumps({
        "clips": len(clips), "frames_a_clip": len(boxes),
        "ms_a_clip": ms, "launches_a_clip": [k for k, _ in launches],
        "copies_a_clip": [c for _, c in launches]}))
    log(f"  device tracker card vs CPU over {len(clips)} clips: ids and "
        f"states equal {same_all}, boxes max_abs_err {worst:.3e} (<= "
        f"{BOX_TOL:g})  {'ok' if ok else 'FAIL'}")
    # the separated block: phase 6's cow box at every frame it is in view
    entries = [{"frame": i, "detections": [] if b is None else [
        {"bbox": [float(v) for v in b], "confidence": 0.9}]}
        for i, b in enumerate(block_boxes)]
    frame_tracks, summaries, _ = dt.track_detection_frames(entries,
                                                           device="cuda")
    host = ByteTracker(high_thresh=0.6, low_thresh=0.1, match_thresh=0.8)
    host_counts, host_spans = [], {}
    for e in entries:
        tracks = host.update([Detection(np.asarray(d["bbox"], float),
                                        d["confidence"])
                              for d in e["detections"]], frame_idx=e["frame"])
        host_counts.append(len(tracks))
        for t in tracks:
            host_spans.setdefault(t.track_id, []).append(e["frame"])
    dev_counts = [sum(t["frame"] == i for t in frame_tracks)
                  for i in range(len(entries))]
    dev_spans = sorted((s["start_frame"], s["end_frame"], s["total_frames"])
                       for s in summaries)
    host_spans = sorted((f[0], f[-1], len(f)) for f in host_spans.values())
    good = dev_counts == host_counts and dev_spans == host_spans \
        and len(dev_spans) == 1
    ok &= good
    log(f"  device vs host tracker on the walking block: confirmed tracks "
        f"{dev_spans} vs {host_spans} (start, end, frames), the same count "
        f"in every frame {dev_counts == host_counts}  "
        f"{'ok' if good else 'FAIL'}")
    return ok


def analysis(tmp, stream_root, block_boxes, clips) -> bool:
    """Phase 7: the graph heads at full width (7a), the back half over phase
    6's videos and over written walks (7b), the device tracker (7c).
    Phase 6's files are made again (one stream of ``clips`` at B = 4 on the
    default engine) when ``stream_root`` does not hold them."""
    from pathlib import Path
    if not os.path.isdir(stream_root):
        from lameness_tpu_torch.core.config import Config, DataDirs
        from lameness_tpu_torch.serve.driver import PipelineDriver
        log(f"  {stream_root} is gone: phase 6's stream made again")
        eng = default_engine()
        drv = PipelineDriver(config=Config(dirs=DataDirs(root=stream_root)),
                             engine=eng,
                             reader=MemoryReader(clips, fps=eng.spec.fps))
        drv.process_stream([(f"{n[:-4]}_0", Path(n)) for n in sorted(clips)],
                           batch_size=4, pad_to=4)
        drv.bus.shutdown()
        del eng, drv
    ok = graph_heads(tmp)
    ok &= back_half(stream_root, "phase 6's stream")
    write_cow_videos(f"{tmp}/walk", cows=WALK_COWS, per_cow=VIDEOS_PER_COW,
                     tracking=False)
    ok &= back_half(f"{tmp}/walk", f"written walks, {WALK_COWS} cows x "
                    f"{VIDEOS_PER_COW}", cows=True)
    ok &= device_tracker(stream_root, block_boxes)
    return ok


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------
# the upload: UPLOAD_FRAMES frames of 1280x720 at 25 fps over a still
# background of uniform noise (a fixed frame, +-2 LSB of noise a frame:
# MOG2 needs a still background), the phase-6 cow block (COW_SIZE, its
# 6-pixel cells) walking left to right over frames UPLOAD_COW (first,
# last); the right-to-left upload is shorter
UPLOAD_FRAMES, UPLOAD_COW = 250, (20, 230)
# right to left at the same speed (at 5.7 px a frame MOG2 leaves gaps in
# the cow's mask, as cv2's does), over two thirds of the width
RTL_FRAMES, RTL_COW = 170, (15, 155)
RTL_TRAVEL = (RTL_COW[1] - RTL_COW[0]) / (UPLOAD_COW[1] - UPLOAD_COW[0])
# the small chain (8b): 320x180 at 10 fps (a 5 s window is 50 frames), the
# cow at 3.3 pixels a frame from frame 25 (MOG2's learning rate settles at
# frame 25: a cow there earlier loses some frames); the tiny engine
SMALL_UPLOAD = {"n": 95, "cow": (25, 85), "h": 180, "w": 320, "fps": 10}
UPLOAD_FPS = 25
UPLOAD_TIMERS = ("curation.track", "curation.detect", "curation.extract",
                 "preprocess", "decode", "engine", "tracking", "graph_heads",
                 "ml", "fusion")
CHAIN_FILES = RESULT_KINDS + ("tracking", "gnn", "graph_transformer", "ml",
                              "fusion")
# the 720p upload's frames whose MOG2 masks are held card against CPU (MOG2
# at 720p takes about 0.3 s a frame on the CPU)
MOG2_FRAMES = (20, 28)
# keys of the result files that hold the wall clock, or Re-ID's random
# identity ids (uuid4)
VOLATILE_KEYS = ("timestamp", "last_updated", "identity_id")

PROBE = """
import importlib, json
out = {}
for mod in ("av", "torchvision.io", "torchcodec"):
    try:
        m = importlib.import_module(mod)
        out[mod] = "ok " + str(getattr(importlib.import_module(
            mod.split(".")[0]), "__version__", ""))
    except Exception as exc:
        out[mod] = (type(exc).__name__ + ": " + str(exc))[:160]
print(json.dumps(out))
"""


def decoder_probe() -> dict:
    """What the machine can decode: the ffmpeg and ffprobe binaries (path,
    first line of ``-version``), whether ``av``, ``torchvision.io`` and
    ``torchcodec`` import (in a process of their own), and the hwaccels
    ffmpeg lists (NVDEC is ``cuda``)."""
    out = {}
    for tool in ("ffmpeg", "ffprobe"):
        path = shutil.which(tool)
        version = None
        if path:
            res = subprocess.run([path, "-version"], capture_output=True,
                                 text=True, timeout=60)
            version = (res.stdout.splitlines() or [""])[0]
        out[tool] = {"path": path, "version": version}
    res = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=300)
    out["imports"] = json.loads(res.stdout.strip().splitlines()[-1]) \
        if res.returncode == 0 else {"probe_failed": res.stderr[-300:]}
    hwaccels = None
    if out["ffmpeg"]["path"]:
        res = subprocess.run([out["ffmpeg"]["path"], "-hide_banner",
                              "-hwaccels"], capture_output=True, text=True,
                             timeout=60)
        hwaccels = res.stdout.split()[3:]      # after "Hardware acceleration
    out["hwaccels"] = hwaccels                 # methods:"
    out["nvdec"] = bool(hwaccels and "cuda" in hwaccels)
    return out


def upload_clip(path, n: int, cow_frames, reverse: bool = False,
                h: int = 720, w: int = 1280, fps: int = UPLOAD_FPS,
                travel: float = 1.0):
    """Write an upload with the port's ``write_video`` (generated and
    converted to I420 on the card): a fixed frame of uniform noise with
    +-2 LSB of noise a frame, and the phase-6 cow block (its 6-pixel
    cells; COW_SIZE at 1280x720, scaled with the frame) walking over the
    frames ``cow_frames``, from one side across ``travel`` of the frame's
    free width.  MOG2 keeps a cow in view while its pixels change colour
    about every frame or two: cells of 6 pixels (the 5x5 opening erases
    smaller ones) at about 3.8 pixels a frame.
    Returns (the .y4m path, the cow's box in each frame or None)."""
    import torch
    from lameness_tpu_torch.video.decode import write_video
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bg = torch.randint(0, 256, (h, w, 3), generator=gen, device="cuda",
                       dtype=torch.int16)
    cw, ch = COW_SIZE[0] * w // 1280, COW_SIZE[1] * h // 720
    cells = np.random.default_rng(SEED).integers(
        170, 256, (-(-ch // 6), -(-cw // 6), 3), dtype=np.uint8)
    cow = torch.from_numpy(np.ascontiguousarray(
        cells.repeat(6, 0).repeat(6, 1)[:ch, :cw])).cuda()
    y = (h - ch) // 2
    f0, f1 = cow_frames
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device="cuda")
    boxes = [None] * n
    for i in range(n):
        noise = torch.randint(-2, 3, bg.shape, generator=gen, device="cuda",
                              dtype=torch.int16)
        frames[i] = (bg + noise).clamp_(0, 255)
        if f0 <= i <= f1:
            frac = (i - f0) / (f1 - f0)
            x = round((1 - frac * travel if reverse else frac * travel)
                      * (w - cw))
            frames[i, y:y + ch, x:x + cw] = cow
            boxes[i] = (x, y, x + cw, y + ch)
    out = write_video(path, frames, fps)
    del frames
    return out, boxes


def chain_files(root, vid) -> dict:
    """{kind: the parsed result file or None} of one video's chain."""
    from pathlib import Path
    out = {}
    for kind in CHAIN_FILES:
        p = Path(root) / "results" / kind / f"{vid}_{kind}.json"
        out[kind] = json.loads(p.read_text()) if p.exists() else None
    return out


def upload_chain(eng, root, src, boxes, name: str, curator=None):
    """One ``process_video_file`` of ``src`` on the card (the driver's own
    curator, or ``curator``), with every launch count from 0; logs its
    record.  Returns the launch counts, the checks' results and whether
    curation detected something on each of the cow's frames and on each
    other frame."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.ops._cuda import KERNELS
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.utils.timing import TIMERS
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         engine=eng, curator=curator)
    TIMERS.reset()
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drv.process_video_file(src, "up")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name_: k.launches for name_, k in KERNELS.items()}
    drv.bus.shutdown()
    report = json.loads((Path(root) / "quality_reports"
                         / "up_quality.json").read_text())
    files = chain_files(root, "up")
    invalid = [k for k, v in files.items()
               if v is None or schemas.validate(k, v)]
    pre = drv.bus.messages_on("video.preprocessed")[0]
    stages = {**drv.curator.timers.summary(), **TIMERS.summary()}
    sizes = {p.name: p.stat().st_size for p in sorted(
        Path(root).glob("*/up*.y4m"))}
    dets = drv.curator.last_detections["detections"]
    hit = [d["detection"] is not None for d in dets]
    on_cow = [h for h, b in zip(hit, boxes) if b is not None]
    off_cow = [h for h, b in zip(hit, boxes) if b is None]
    record = {
        "detector": name, "frames": len(dets), "wall_s": wall,
        "status": report["status"],
        "selected_window": report["selected_window"] and {
            k: report["selected_window"][k]
            for k in ("start_frame", "end_frame", "needs_flip")},
        "passes": [(p_["start_frame"], p_["end_frame"], p_["direction"])
                   for p_ in report["passes"]],
        "crop_box": pre["crop_box"],
        "detections_on_cow_frames": f"{sum(on_cow)}/{len(on_cow)}",
        "detections_off_cow_frames": f"{sum(off_cow)}/{len(off_cow)}",
        "stage_s": {k: stages[k]["last_s"] if stages[k]["count"] == 1
                    else stages[k]["mean_s"] * stages[k]["count"]
                    for k in UPLOAD_TIMERS if k in stages},
        "curation_frames_s": len(dets) / stages["curation.track"]["last_s"],
        "disk_bytes": sizes, "launches": {k: v for k, v in launches.items()
                                          if v}}
    log("upload record " + json.dumps(record))
    first = next(b for b in boxes if b is not None)
    x1, y1, x2, y2 = pre["crop_box"]
    sel = report["selected_window"]
    checks = {
        "status success": report["status"] == "success",
        "window inside the cow's frames, unflipped": bool(
            sel and UPLOAD_COW[0] <= sel["start_frame"]
            and sel["end_frame"] <= UPLOAD_COW[1] + 1
            and not sel["needs_flip"]),
        "crop holds the cow's first box": (
            x1 <= first[0] and y1 <= first[1] and x2 >= first[2]
            and y2 >= first[3]),
        "every result file written and valid": not invalid,
        "K1-K3 at the default engine's counts": expect_launches(
            launches, BASE_LAUNCHES)}
    return launches, checks, on_cow, off_cow


def motion_costs(src, first: int = UPLOAD_COW[0], n: int = 64) -> dict:
    """The motion fallback's parts over ``n`` frames of the upload from
    ``first`` (the cow in view): MOG2 and the opening on the card (CUDA
    events, a frame), the copy of the masks to the host, and the host's
    contour step on one thread (a frame)."""
    import torch
    from lameness_tpu_torch.video.curation import (MotionDetector,
                                                   mask_detection)
    from lameness_tpu_torch.video.decode import VideoReader
    with VideoReader(src, device="cuda") as vr:
        frames = vr.read_selected(range(first, first + n))
    bgr = torch.from_numpy(np.stack([frames[i] for i in sorted(frames)])
                           [..., ::-1].copy()).cuda()
    det = MotionDetector(device="cuda")
    ms = cuda_ms(lambda: det.masks(bgr), 1) / n       # after one warm pass
    masks = det.masks(bgr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = masks.cpu().numpy()
    copy_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    for m in host:
        mask_detection(m)
    contour_ms = (time.perf_counter() - t0) * 1e3 / n
    return {"frames": n, "mog2_open_ms_a_frame": ms,
            "masks_to_host_ms_a_frame": copy_ms,
            "contour_ms_a_frame_one_thread": contour_ms}


def check_upload(eng, tmp) -> tuple:
    """8a: the full-width chain over the 720p upload, with the motion
    fallback (gated) and with phase 6's calibrated YOLO as curation's
    detector; the right-to-left upload's curation."""
    import torch
    from lameness_tpu_torch.video.curation import (BatchedYoloDetector,
                                                   ClipCurator)
    t0 = time.perf_counter()
    src, boxes = upload_clip(f"{tmp}/upload", UPLOAD_FRAMES, UPLOAD_COW)
    torch.cuda.synchronize()
    log(f"  upload: {UPLOAD_FRAMES} frames of 1280x720 at {UPLOAD_FPS} "
        f"fps written in {time.perf_counter() - t0:.2f} s, "
        f"{src.stat().st_size} bytes ({src.stat().st_size / UPLOAD_FRAMES:.0f}"
        f" a frame with its FRAME line)")
    log("motion fallback record " + json.dumps(motion_costs(src)))
    ok = True
    launches = {}
    launches["upload, motion fallback"], checks, *_ = upload_chain(
        eng, f"{tmp}/motion", src, boxes, "motion")
    for what, good in checks.items():
        log(f"  motion fallback: {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    shutil.rmtree(f"{tmp}/motion")
    # phase 6's calibrated YOLO as curation's detector.  Its seeded box
    # head puts a 240-pixel box on whichever anchor inside the cow scores
    # highest, which jumps by hundreds of pixels from frame to frame (phase
    # 6: "the picked boxes differ by up to 272 px"), so the walking-pass
    # segmentation splits the walk: its window, flip and crop are reported,
    # and the detections, the files and the launches gated
    yolo = BatchedYoloDetector(eng.yolo, cow_class_id=eng.config.yolo.
                               cow_class_id, size=eng.spec.yolo_size)
    from lameness_tpu_torch.core.config import DataDirs
    cur = ClipCurator(DataDirs(root=f"{tmp}/yolo").ensure(), detector=yolo,
                      device=eng.device)
    launches["upload, YOLO curation"], checks, on_cow, off_cow = \
        upload_chain(eng, f"{tmp}/yolo", src, boxes, "yolo", curator=cur)
    gated = ("every result file written and valid",
             "K1-K3 at the default engine's counts")
    checks["the cow found on 90% of its frames, 10% of the others at most"] = (
        sum(on_cow) >= 0.9 * len(on_cow)
        and sum(off_cow) <= 0.1 * len(off_cow))
    for what, good in checks.items():
        gate = what in gated or what.startswith("the cow found")
        log(f"  YOLO curation: {what}  "
            f"{('ok' if good else 'FAIL') if gate else good} "
            f"{'' if gate else '(reported)'}")
        ok &= good or not gate
    shutil.rmtree(f"{tmp}/yolo")
    src.unlink()
    # right to left: curation alone (the motion fallback)
    src, _ = upload_clip(f"{tmp}/rtl", RTL_FRAMES, RTL_COW, reverse=True,
                         travel=RTL_TRAVEL)
    cur = ClipCurator(DataDirs(root=f"{tmp}/rtl_data").ensure(),
                      device=eng.device)
    report = cur.curate_video(src, "rtl")
    sel = report["selected_window"]
    good = bool(report["status"] == "success" and sel["needs_flip"]
                and RTL_COW[0] <= sel["start_frame"]
                and sel["end_frame"] <= RTL_COW[1] + 1)
    log(f"  right to left ({RTL_FRAMES} frames, the cow over "
        f"{RTL_COW[0]}-{RTL_COW[1]}): status {report['status']}, window "
        f"{sel and (sel['start_frame'], sel['end_frame'])}, needs_flip "
        f"{sel and sel['needs_flip']}, curation.track "
        f"{cur.timers.summary()['curation.track']['last_s']:.3f} s  "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    shutil.rmtree(f"{tmp}/rtl_data")
    src.unlink()
    return ok, launches


def small_chain(dev, root, src):
    """The tiny engine of ``small_stream_files`` (dropout 0) and its graph
    heads at dropout 0 on ``dev``: ``process_video_file(src)`` with the
    motion fallback.  Returns {file: parsed JSON}, the engine outputs and
    the crop's scale to the engine's frame (the files' pixel coordinates are
    the outputs' times it)."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.pipeline.engine import make_test_engine
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.weights import seeded_state_dict
    gen = torch.Generator().manual_seed(SEED)
    eng = make_test_engine(device=dev, with_sam=True, generator=gen)
    eng.tcn = TCN(input_dim=44, dropout=0.0, device=dev)
    eng.gait = GaitTransformer(input_dim=44, dropout=0.0, device=dev)
    eng.load_state_dicts({"tcn": seeded_state_dict(eng.tcn, gen),
                          "gait": seeded_state_dict(eng.gait, gen)})
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         engine=eng)
    drv.graph_runner = zero_dropout(graph_runner(root, dev))
    outs = {}
    write = drv._write_stage_results

    def capture(video_id, out, bi, scale, info):
        outs.update({k: v[bi] for k, v in leaves(out)})
        return write(video_id, out, bi, scale, info)
    drv._write_stage_results = capture
    drv.process_video_file(src, "small")
    drv.bus.shutdown()
    x1, y1, x2, y2 = drv.bus.messages_on("video.preprocessed")[0]["crop_box"]
    scale = max(1.0, (x2 - x1) / eng.spec.frame_width,
                (y2 - y1) / eng.spec.frame_height)
    files = {p.relative_to(root).as_posix(): json.loads(p.read_text())
             for p in sorted(Path(root).glob("*/**/*.json"))}
    return files, outs, scale


def check_small_chain(tmp, big_src=None) -> bool:
    """8b: the whole chain at the small geometry on the card and on the
    CPU over one upload: the engine's outputs under check_small_engine's
    gates; the files key by key (list lengths equal, the clock and Re-ID's
    random ids apart), their numbers within 1e-4 times the crop's scale to
    the engine's frame (pixel coordinates are the outputs' times it), a
    sam3 file only where the masks are equal bit for bit; and MOG2's masks
    card against CPU, over the small upload and over frames MOG2_FRAMES of
    the 720p one."""
    import torch
    from lameness_tpu_torch.video.curation import MotionDetector
    from lameness_tpu_torch.video.decode import VideoReader
    u = SMALL_UPLOAD
    src, _ = upload_clip(f"{tmp}/small", u["n"], u["cow"], h=u["h"],
                         w=u["w"], fps=u["fps"])
    runs = {dev: small_chain(dev, f"{tmp}/small_{dev}", src)
            for dev in ("cpu", "cuda")}
    (cpu, cpu_out, scale), (gpu, gpu_out, _) = runs["cpu"], runs["cuda"]
    ok = list(cpu) == list(gpu) and len(cpu) >= len(CHAIN_FILES) + 1
    out_err, masks = 0.0, 1.0
    for key, x in cpu_out.items():
        y = gpu_out[key]
        if key == "masks":
            masks = float((x == y).mean())
        elif x.dtype == bool or np.issubdtype(x.dtype, np.integer):
            ok &= bool(np.array_equal(x, y))
        else:
            tol = 1e-3 if key == "mask_iou_pred" else 1e-4
            err = float(np.abs(x.astype(np.float64) - y).max())
            ok &= err <= tol
            out_err = max(out_err, err)
    ok &= masks >= 0.995
    same_masks = masks == 1.0
    worst, where, compared = 0.0, None, 0
    for name, want in cpu.items():
        w, g = dict(json_leaves(want)), dict(json_leaves(gpu[name]))
        ok &= list(w) == list(g)
        if "sam3" in name and not same_masks:
            continue
        compared += 1
        for key, x in w.items():
            if key.rsplit(".", 1)[-1] in VOLATILE_KEYS:
                continue
            y = g.get(key)
            if isinstance(x, float):
                if abs(x - y) > worst:
                    worst, where = abs(x - y), f"{name}{key}"
            elif not (isinstance(x, str) and x.startswith(str(tmp))):
                ok &= x == y
    ok &= worst <= 1e-4 * scale
    quality = cpu["quality_reports/small_quality.json"]
    log(f"  small chain: status {quality['status']}, window "
        f"{quality['selected_window'] and quality['selected_window']['start_frame']}"
        f", {quality['walking_passes_detected']} passes; the crop {scale:.3f}"
        f"x the engine's frame")
    log(f"  small chain card vs CPU: engine outputs max_abs_err "
        f"{out_err:.3e}, mask agreement {masks:.5f}; {len(cpu)} files, "
        f"{compared} compared key by key, max_abs_err {worst:.3e} ({where};"
        f" gate {1e-4 * scale:.3e})  {'ok' if ok else 'FAIL'}")
    masks_ok = True
    clips = [(src, None)]
    if big_src is not None:
        clips.append((big_src, MOG2_FRAMES))
    for path, span in clips:
        with VideoReader(path, device="cuda") as vr:
            frames = vr.read_sampled()[0]
        if span:
            frames = frames[span[0]:span[1]]
        bgr = torch.from_numpy(np.ascontiguousarray(frames[..., ::-1]))
        got = {dev: MotionDetector(device=dev).masks(bgr.to(dev)).cpu()
               for dev in ("cpu", "cuda")}
        equal = torch.equal(got["cpu"], got["cuda"])
        masks_ok &= equal
        log(f"  MOG2 masks card vs CPU, {len(frames)} frames of "
            f"{frames.shape[2]}x{frames.shape[1]}: equal {equal} (foreground "
            f"{float((got['cpu'] > 0).float().mean()):.4f})  "
            f"{'ok' if equal else 'FAIL'}")
    return ok and masks_ok


def upload_phase(tmp) -> tuple:
    """Phase 8: the decoder probe, 8a and 8b.  Returns (ok, the launch
    counts of 8a's chains)."""
    import torch
    t0 = time.perf_counter()
    log("decoder probe " + json.dumps(decoder_probe()))
    eng = default_engine()
    rng = np.random.default_rng(SEED + 6)
    clip, cow = walking_clip(rng, eng.spec)       # phase 6's calibration
    calibrate_yolo(eng, clip, cow)
    del clip
    t1 = time.perf_counter()
    ok, launches = check_upload(eng, tmp)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    big, _ = upload_clip(f"{tmp}/mog2", MOG2_FRAMES[1], UPLOAD_COW)
    log("small engine, upload chain:")
    ok &= check_small_chain(tmp, big)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s (probe, engine and "
        f"calibration {t1 - t0:.1f}, 8a {t2 - t1:.1f}, 8b "
        f"{time.perf_counter() - t2:.1f})")
    return ok, launches


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------
# 9a: YOLOv8-n (80 classes, the engine's) trained at the engine's 640 canvas
# on letterboxed synthetic cows: tests/test_training_e2e.py's _cow_dataset
# at 720p (a bright square with darker rows every 32 px on flat gray, 224 to
# 480 px a side), through the engine's own letterbox.  The seeded weights
# get ultralytics' detect-head bias init (``detect_bias_init``): from zero
# biases the 8400 x 80 class logits start at sigmoid 0.5, and after 200
# steps no detect frame held a cow detection (best cow score 0.000); with
# it, 320 steps found the cow on 11 and on 10 of 11 (scores 0.957 and
# 0.707: the card's training is not deterministic) in two runs (H100,
# 700 W), so phase 9 takes 400
DET_FRAMES = 96
DET_BATCH = 16
DET_STEPS = 400
DET_LR = 2e-3
DET_FOUND = 0.5           # share of detect frames whose cow must be found
DET_IOU = 0.5
HEAD_VIDEOS = 24          # 9b: labelled tleap files, 30 pose frames each
HEAD_EPOCHS = 30
POSE_IMAGES = 32          # 9c: 320² images, 20 keypoints
POSE_EPOCHS = 3
GRAPH_COWS, GRAPH_PER_COW = 16, 4     # 9d/9e: 64 labelled videos
GRAPH_EPOCHS = 100
# 9f: card against CPU, f32 with TF32 off, from the same weights and batch.
# The first step's loss parts within 1e-5 relative, the second's within
# 2e-4; the parameters after two steps with 90% of all elements within 2%
# of a step and every element within 4·lr (two steps each way): Adam's
# update is g / (|g| + eps) per element, so a gradient that is zero but for
# rounding moves its element by up to a step either way
# (tests/test_torch_training.py holds the port to JAX by the same rule)
TRAIN_RTOL = (1e-5, 2e-4)
TRAIN_STEP_SHARE, TRAIN_SHARE = 0.02, 0.9


def square_cows(rng, n, h=720, w=1280, size=(224, 480)):
    """n frames of one bright square cow each, and its boxes."""
    frames = np.full((n, h, w, 3), 60, np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        s = int(rng.integers(*size))
        x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
        frames[i, y:y + s, x:x + s] = 220
        frames[i, y:y + s:32, x:x + s] = 160
        boxes[i] = [x, y, x + s, y + s]
    return frames, boxes


def walking_square_clip(t=125, h=720, w=1280, s=320):
    """A clip of the same cow walking left to right, and its boxes."""
    frames = np.full((t, h, w, 3), 60, np.uint8)
    y = (h - s) // 2
    boxes = np.zeros((t, 4), np.float32)
    for i in range(t):
        x = round(i * (w - s) / (t - 1))
        frames[i, y:y + s, x:x + s] = 220
        frames[i, y:y + s:32, x:x + s] = 160
        boxes[i] = [x, y, x + s, y + s]
    return frames, boxes


def box_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / ((a[2] - a[0]) * (a[3] - a[1])
                    + (b[2] - b[0]) * (b[3] - b[1]) - inter)


def detect_bias_init(model) -> None:
    """Ultralytics' ``Detect.bias_init``: box biases 1, class biases
    log(5 / nc / (640 / stride)²)."""
    import torch
    with torch.no_grad():
        for i, stride in enumerate((8, 16, 32)):
            branch = getattr(model, f"detect{i}")
            branch.box2.bias.fill_(1.0)
            branch.cls2.bias.fill_(math.log(5 / model.num_classes
                                            / (640 / stride) ** 2))


def cow_found(eng, out, truth) -> list:
    """Per detect frame of the clip: whether a valid cow-class detection
    overlaps the cow's box by DET_IOU."""
    cow = eng.config.yolo.cow_class_id
    found = []
    for t, fi in enumerate(eng.spec.det_idx):
        found.append(any(
            out["det_valid"][0, t, k] and out["det_classes"][0, t, k] == cow
            and box_iou(out["det_boxes"][0, t, k], truth[fi]) >= DET_IOU
            for k in range(out["det_valid"].shape[-1])))
    return found


def step_record(name, fn, steps, wall_s, **extra) -> dict:
    """One more step of ``fn`` profiled (its kernels and copies, device ms,
    busy share of its wall) beside the loop's ms a step."""
    kernels, copies, dev_ms = kernel_events(fn)
    wall_ms, busy = busy_share(fn)
    rec = {"trainer": name, "steps": steps, "ms_step": 1e3 * wall_s / steps,
           "launches_step": kernels, "copies_step": copies,
           "device_ms_step": dev_ms, "profiled_wall_ms": wall_ms,
           "busy_share": busy, **extra}
    log("training record " + json.dumps(rec))
    return rec


def train_detector(eng, models_dir) -> bool:
    """9a: DetectTrainer at 640, batch 16; the loss must fall, and the EMA
    weights, saved and restored into the default engine, must find the cow
    on DET_FOUND of a walking clip's detect frames."""
    import torch
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.ops import preprocess as prep
    from lameness_tpu_torch.pipeline.checkpoint import (restore_engine,
                                                        save_params)
    from lameness_tpu_torch.pipeline.detect_training import DetectTrainer
    from lameness_tpu_torch.weights import seeded_state_dict
    rng = np.random.default_rng(SEED + 9)
    frames, boxes = square_cows(rng, DET_FRAMES)
    images, r, pad = prep.letterbox(torch.from_numpy(frames).cuda(),
                                    eng.spec.yolo_size)
    del frames
    shift = torch.cat([pad, pad], dim=-1)
    gt = torch.zeros((DET_FRAMES, 2, 4), device="cuda")
    gt[:, 0] = torch.from_numpy(boxes).cuda() * r[:, None] + shift
    labels = torch.full((DET_FRAMES, 2), eng.config.yolo.cow_class_id,
                        dtype=torch.long, device="cuda")
    mask = torch.zeros((DET_FRAMES, 2), dtype=torch.bool, device="cuda")
    mask[:, 0] = True
    model = YoloV8("n", num_classes=eng.config.yolo.num_classes)
    model.load_state_dict(seeded_state_dict(
        model, torch.Generator().manual_seed(SEED)))
    detect_bias_init(model)
    trainer = DetectTrainer(model, lr=DET_LR)

    def step():
        idx = torch.from_numpy(rng.permutation(DET_FRAMES)[:DET_BATCH]
                               ).cuda()
        return trainer.train_step(images[idx], labels[idx], gt[idx],
                                  mask[idx])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step()["total"]]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += [step()["total"] for _ in range(DET_STEPS - 1)]
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    falls = bool(np.isfinite(losses).all()
                 and np.mean(losses[-10:]) < np.mean(losses[:10]))
    step_record("DetectTrainer (YOLOv8-n 640, batch 16)", step,
                DET_STEPS - 1, loop_s, first_step_s=first_s, peak_gb=peak,
                loss_first10=float(np.mean(losses[:10])),
                loss_last10=float(np.mean(losses[-10:])))
    clip, truth = walking_square_clip()
    before = cow_found(eng, eng.process_clip_batch(clip[None]), truth)
    save_params(models_dir, "yolo", trainer.ema_params)
    loaded = restore_engine(eng, models_dir)
    out = eng.process_clip_batch(clip[None])
    found = cow_found(eng, out, truth)
    cow = eng.config.yolo.cow_class_id
    best = float(np.where(out["det_classes"][0] == cow,
                          out["det_scores"][0], 0).max())
    ok = falls and loaded.get("yolo") is True \
        and np.mean(found) >= DET_FOUND
    log(f"  9a detector: loss {np.mean(losses[:10]):.4g} -> "
        f"{np.mean(losses[-10:]):.4g} over {DET_STEPS} steps (falls "
        f"{falls}); restore_engine {json.dumps(loaded)}; cow found on "
        f"{sum(found)} of {len(found)} detect frames (seeded weights "
        f"{sum(before)}), best cow score {best:.3f}  "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def write_pose_sequences(dirs, n: int = HEAD_VIDEOS, frames: int = 30):
    """tests/test_head_training.py's labelled videos: a tleap file of 30
    pose frames a video, where lame cows sag and bob their heads."""
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.models import pose
    rng = np.random.default_rng(SEED + 91)
    labels_dir = dirs.training / "labels"
    labels_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        vid, label = f"h{i:02d}", i % 2
        schemas.write_result(labels_dir / f"{vid}_label.json",
                             {"label": label})
        seqs = []
        for f in range(frames):
            x0 = 50 + 6 * f
            bbox = [x0, 100, x0 + 400, 400]
            kps = pose.heuristic_keypoints(bbox)
            for k in kps:
                k["y"] += (100.0 if label else 0.0) + rng.standard_normal()
                if k["name"] == "nose":
                    k["y"] += (25.0 if label else 2.0) * np.sin(f * 1.1)
            seqs.append({"frame": f * 5, "bbox": bbox, "keypoints": kps,
                         "detection_confidence": 0.9})
        schemas.write_result(dirs.results_for("tleap") / f"{vid}_tleap.json",
                             {"pose_sequences": seqs})


def train_sequence_heads(eng, dirs, models_dir) -> bool:
    """9b: train_heads at the default widths; the restored heads in the
    engine give the report's train accuracy (train_heads computes it with
    its best weights in memory) and new head outputs."""
    import torch
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.pipeline.checkpoint import restore_engine
    from lameness_tpu_torch.pipeline.head_training import (build_dataset,
                                                           heads_loss,
                                                           train_heads)
    from lameness_tpu_torch.pipeline.optim import Optimizer
    write_pose_sequences(dirs)
    data = build_dataset(dirs)
    clip = np.random.default_rng(SEED).integers(
        0, 256, (1, eng.spec.clip_frames, eng.spec.frame_height,
                 eng.spec.frame_width, 3), dtype=np.uint8)
    seeded = eng.process_clip_batch(clip)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = train_heads(dirs, models_dir, epochs=HEAD_EPOCHS, batch_size=8,
                         lr=3e-3)
    wall = time.perf_counter() - t0
    steps = report.get("epochs_run", 0) * -(-HEAD_VIDEOS // 8)
    loaded = restore_engine(eng, models_dir)
    x = torch.from_numpy(data["features"]).cuda()
    m = torch.from_numpy(data["masks"]).cuda()
    y = data["labels"] > 0.5
    with torch.no_grad():
        acc = {"tcn": float(((eng.tcn(x)[:, 0] > 0.5).cpu().numpy()
                             == y).mean()),
               "gait": float(((eng.gait(x, m)["probability"][:, 0] > 0.5)
                              .cpu().numpy() == y).mean())}
    out = eng.process_clip_batch(clip)
    moved = not np.array_equal(out["tcn_probability"],
                               seeded["tcn_probability"])
    tcn, gait = TCN(input_dim=44), GaitTransformer(input_dim=44)
    opt = Optimizer([*tcn.parameters(), *gait.parameters()], 3e-3,
                    max_norm=1.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def step():
        loss, _ = heads_loss(tcn, gait, x[:8], m[:8],
                             torch.from_numpy(data["labels"][:8]).cuda(),
                             gen)
        opt.step(loss)
        return loss.item()
    step_record("train_heads (TCN + GaitTransformer, batch 8)", step,
                steps, wall, epochs=report.get("epochs_run"),
                best_loss=report.get("best_loss"),
                train_accuracy=report.get("train_accuracy"))
    ok = (report["status"] == "completed" and loaded.get("tcn") is True
          and loaded.get("gait") is True
          and acc == report["train_accuracy"] and moved)
    log(f"  9b heads: {report['status']}, {report.get('epochs_run')} epochs, "
        f"best loss {report.get('best_loss'):.4g} (first "
        f"{report['loss_history'][0]:.4g}); restored {json.dumps(loaded)}; "
        f"the engine's heads give train accuracy {acc} (report "
        f"{report.get('train_accuracy')}); tcn_probability moved {moved}  "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def pose_images(rng, n=POSE_IMAGES, img=320, nk=20):
    """tests/test_pose_training.py's synthetic pose set: cow blobs with a
    fixed keypoint layout."""
    images = np.full((n, img, img, 3), 40, np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    kpts = np.zeros((n, nk, 3), np.float32)
    for i in range(n):
        w = int(rng.integers(img * 5 // 16, img * 9 // 16))
        h = int(rng.integers(img * 7 // 32, img * 3 // 8))
        x1, y1 = int(rng.integers(0, img - w)), int(rng.integers(0, img - h))
        images[i, y1:y1 + h, x1:x1 + w] = 210
        boxes[i] = [x1, y1, x1 + w, y1 + h]
        for k in range(nk):
            kpts[i, k] = [x1 + (k % 5 + 0.5) / 5 * w,
                          y1 + (k // 5 + 0.5) / 4 * h, 1.0]
    return images, boxes, kpts


def train_pose(eng, models_dir) -> bool:
    """9c: train_pose_model at 320, 20 keypoints, batch 8; the checkpoint
    restored into the (pose_pixels) default engine runs trained pose."""
    import torch
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.pipeline.checkpoint import restore_engine
    from lameness_tpu_torch.pipeline.optim import Optimizer
    from lameness_tpu_torch.pipeline.pose_training import (assign_targets,
                                                           pose_loss,
                                                           train_pose_model)
    images, boxes, kpts = pose_images(np.random.default_rng(SEED + 92))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = train_pose_model(images, boxes, kpts, models_dir=models_dir,
                              epochs=POSE_EPOCHS, batch_size=8, img_size=320)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    loaded = restore_engine(eng, models_dir)
    same = all(torch.equal(v, report["params"][k].to(v.dtype))
               for k, v in eng.pose_model.state_dict().items())
    clip, _ = walking_square_clip()
    out = eng.process_clip_batch(clip[None])
    model = YoloV8("n", num_classes=1, num_keypoints=20)
    model.load_state_dict(report["params"])
    opt = Optimizer(model.parameters(), 1e-3)
    x = torch.from_numpy(images[:8].astype(np.float32) / 255.0).cuda()
    tb = {k: torch.from_numpy(v[:8]).cuda()
          for k, v in assign_targets(boxes, kpts, 320).items()}

    def step():
        loss, _ = pose_loss(model, x, tb)
        opt.step(loss)
        return loss.item()
    step_record("train_pose_model (YOLOv8-n pose 320, batch 8)", step,
                POSE_EPOCHS * (POSE_IMAGES // 8), wall, peak_gb=peak,
                loss_history=report["loss_history"])
    hist = report["loss_history"]
    ok = (report["status"] == "completed" and bool(np.isfinite(hist).all())
          and loaded.get("pose") is True and same
          and "keypoints_model" in out)
    log(f"  9c pose: loss {hist[0]:.4g} -> {hist[-1]:.4g}; restored "
        f"{json.dumps(loaded)}, the engine's pose model the trained weights "
        f"{same}, trained pose in its outputs {'keypoints_model' in out}  "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def label_cow_videos(dirs, vids):
    """Every odd cow's videos lame (label 1), the others sound."""
    from lameness_tpu_torch.io import schemas
    for vid in vids:
        schemas.write_result(dirs.training / "labels" / f"{vid}_label.json",
                             {"label": int(vid[3:5]) % 2})


def train_graphs(dirs, models_dir) -> bool:
    """9d: train_graph_heads at the serving widths (GraphGPS 128-d 4
    layers, Graphormer 128-d 6 layers) on 64 labelled videos."""
    import torch
    from lameness_tpu_torch.models.graphgps import EnhancedGraphGPS
    from lameness_tpu_torch.models.graphormer import CowLamenessGraphormer
    from lameness_tpu_torch.pipeline.checkpoint import load_params
    from lameness_tpu_torch.pipeline.graph_training import (
        build_graph_dataset, graph_loss, train_graph_heads)
    from lameness_tpu_torch.pipeline.optim import Optimizer
    from lameness_tpu_torch.serve.graph_runner import gt_inputs, on_device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = train_graph_heads(dirs, models_dir, epochs=GRAPH_EPOCHS)
    wall = time.perf_counter() - t0
    heads = {}
    for name, cls in (("gnn", EnhancedGraphGPS),
                      ("graphormer", CowLamenessGraphormer)):
        heads[name] = cls()
        heads[name].load_state_dict(load_params(models_dir, name))
    g = build_graph_dataset(dirs)
    args = on_device(gt_inputs(g), "cuda")
    model = heads["graphormer"]
    opt = Optimizer(model.parameters(), 3e-4, max_norm=0.5)
    y = torch.from_numpy(g["labels"]).cuda()
    lm = torch.from_numpy(g["label_mask"].astype(np.float32)).cuda()
    mean_label = float((g["labels"] * g["label_mask"]).sum()
                       / g["label_mask"].sum())

    def step():
        loss = graph_loss(model, args, y, lm, mean_label)
        opt.step(loss)
        return loss.item()
    steps = sum(report.get("epochs_run", {}).values())
    step_record("train_graph_heads (GraphGPS + Graphormer, 64 nodes; the "
                "profiled step is Graphormer's)", step, steps, wall,
                epochs_run=report.get("epochs_run"),
                train_accuracy=report.get("train_accuracy"))
    hist = report.get("loss_history", [])
    ok = (report["status"] == "completed" and report["num_nodes"] == 64
          and bool(np.isfinite(hist).all()))
    log(f"  9d graph heads: {report['status']}, nodes "
        f"{report.get('num_nodes')}, epochs {report.get('epochs_run')}, "
        f"train accuracy {report.get('train_accuracy')}; both checkpoints "
        f"load  {'ok' if ok else 'FAIL'}")
    return ok


def train_tabular(dirs, vids) -> bool:
    """9e: TrainingService.run_training(cv_folds=2) over the labelled result
    files; the driver's GBDTEnsemble loads the saved reference files and
    run_ml predicts with all three."""
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.io.bus import MessageBus
    from lameness_tpu_torch.ml.training import TrainingService
    from lameness_tpu_torch.serve.driver import PipelineDriver
    bus = MessageBus()
    t0 = time.perf_counter()
    status = TrainingService(dirs, bus=bus).run_training(cv_folds=2)
    wall = time.perf_counter() - t0
    drv = PipelineDriver(config=Config(dirs=dirs), device="cuda")
    slots = sorted(drv.ensemble.models)
    ml = drv.run_ml(vids[0])
    drv.bus.shutdown()
    preds = sorted(k for k in ml["predictions"] if k != "ensemble")
    report = status.get("report", {})
    ok = (status["status"] == "completed"
          and slots == preds == ["catboost", "lightgbm", "xgboost"]
          and len(bus.messages_on("training.completed")) == 1)
    log(f"  9e tabular: {status['status']} in {wall:.2f} s host, "
        f"{status.get('num_labeled')} labelled, cv "
        f"{json.dumps({k: v.get('cv_accuracy_mean') for k, v in report.get('models', {}).items()})}; "
        f"the driver's ensemble loads {slots}, run_ml predicts with "
        f"{preds}  {'ok' if ok else 'FAIL'}")
    return ok


def tiny_steps(dev) -> dict:
    """9f: each trainer's step at a tiny size on ``dev`` from seeded weights
    and a seeded batch: {trainer: (loss parts per step, parameters after two
    steps (CPU), lr)}."""
    import torch
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.graphgps import EnhancedGraphGPS
    from lameness_tpu_torch.models.graphormer import CowLamenessGraphormer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.pipeline import detect_training as dt
    from lameness_tpu_torch.pipeline import graph_training as gtr
    from lameness_tpu_torch.pipeline import head_training as ht
    from lameness_tpu_torch.pipeline import pose_training as pt
    from lameness_tpu_torch.graph import build as gb
    from lameness_tpu_torch.pipeline.optim import Optimizer
    from lameness_tpu_torch.serve.graph_runner import (gnn_inputs, gt_inputs,
                                                       on_device)
    from lameness_tpu_torch.weights import seeded_state_dict
    rng = np.random.default_rng(SEED + 93)

    def seeded(model, seed):
        model.load_state_dict(seeded_state_dict(
            model, torch.Generator().manual_seed(seed)))
        return model

    def cpu_params(model):
        return {k: v.detach().cpu() for k, v in model.named_parameters()}
    res = {}
    # DetectTrainer, 64 canvas, 2 classes
    model = seeded(YoloV8("n", num_classes=2, device=dev), 1)
    tr = dt.DetectTrainer(model, lr=1e-3, device=dev)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    gt = np.array([[[6, 8, 40, 44], [0, 0, 0, 0]],
                   [[20, 4, 60, 30], [2, 30, 30, 62]]], np.float32)
    batch = (images, np.array([[0, 0], [1, 0]]), gt,
             np.array([[True, False], [True, True]]))
    res["DetectTrainer"] = ([tr.train_step(*batch) for _ in range(2)],
                            cpu_params(model), 1e-3)
    # pose step, 64 canvas, 20 keypoints
    model = seeded(YoloV8("n", num_classes=1, num_keypoints=20, device=dev),
                   2)
    opt = Optimizer(model.parameters(), 1e-3)
    ims, bxs, kps = pose_images(rng, n=2, img=64)
    x = torch.from_numpy(ims.astype(np.float32) / 255.0).to(dev)
    tb = {k: torch.from_numpy(v).to(dev)
          for k, v in pt.assign_targets(bxs, kps, 64).items()}
    parts = []
    for _ in range(2):
        loss, aux = pt.pose_loss(model, x, tb)
        parts.append({"total": loss.item(),
                      **{k: v.item() for k, v in aux.items()}})
        opt.step(loss)
    res["pose"] = (parts, cpu_params(model), 1e-3)
    # the sequence heads, dropout 0
    tcn = seeded(TCN(dropout=0.0, device=dev), 3)
    gait = seeded(GaitTransformer(dropout=0.0, device=dev), 4)
    opt = Optimizer([*tcn.parameters(), *gait.parameters()], 1e-3,
                    max_norm=1.0)
    xs = torch.from_numpy(rng.standard_normal((4, 125, 44)).astype(
        np.float32)).to(dev)
    ms = torch.zeros((4, 125), dtype=torch.bool, device=dev)
    ms[:, :10] = True
    ys = torch.tensor([0.0, 1.0, 1.0, 0.0], device=dev)
    parts = []
    for _ in range(2):
        loss, _ = ht.heads_loss(tcn, gait, xs, ms, ys, None)
        parts.append({"total": loss.item()})
        opt.step(loss)
    res["heads"] = (parts, {**{"tcn." + k: v for k, v in
                               cpu_params(tcn).items()},
                            **{"gait." + k: v for k, v in
                               cpu_params(gait).items()}}, 1e-3)
    # the graph heads at the serving widths on a 16-node graph
    g = gb.build_dense_graph(rng.standard_normal((11, 50)).astype(np.float32),
                             rng.standard_normal((11, 32)).astype(np.float32),
                             max_nodes=16)
    g["x"] = gb.standardize_features(g["x"], g["node_mask"])
    y = torch.from_numpy((np.arange(16) % 2).astype(np.float32)).to(dev)
    lm = torch.from_numpy(g["node_mask"].astype(np.float32)).to(dev)
    for name, cls, inputs, seed in (
            ("GraphGPS", EnhancedGraphGPS, gnn_inputs, 5),
            ("Graphormer", CowLamenessGraphormer, gt_inputs, 6)):
        model = seeded(cls(device=dev), seed)
        opt = Optimizer(model.parameters(), 3e-4, max_norm=0.5)
        args = on_device(inputs(g), dev)
        parts = []
        for _ in range(2):
            loss = gtr.graph_loss(model, args, y, lm, 0.5)
            parts.append({"total": loss.item()})
            opt.step(loss)
        res[name] = (parts, cpu_params(model), 3e-4)
    return res


def trainers_card_vs_cpu() -> bool:
    """9f: the card's steps against the CPU's under TRAIN_RTOL and the
    parameter rule."""
    card, cpu = tiny_steps("cuda"), tiny_steps("cpu")
    ok = True
    for name, (parts, params, lr) in card.items():
        want_parts, want_params, _ = cpu[name]
        rel = max(abs(p[k] - w[k]) / max(abs(w[k]), 1e-12)
                  for p, w in zip(parts, want_parts) for k in w)
        loss_ok = all(abs(p[k] - w[k]) <= rtol * max(abs(w[k]), 1e-12)
                      for p, w, rtol in zip(parts, want_parts, TRAIN_RTOL)
                      for k in w)
        close = total = 0
        worst = 0.0
        for key, val in params.items():
            diff = (val - want_params[key]).abs()
            worst = max(worst, float(diff.max()) / lr)
            close += int((diff <= TRAIN_STEP_SHARE * lr).sum())
            total += diff.numel()
        share = close / total
        good = loss_ok and worst <= 4.0 and share >= TRAIN_SHARE
        ok &= good
        log(f"  9f {name}: loss parts card vs CPU max rel {rel:.3g}; "
            f"parameters after two steps max |diff| {worst:.3g} lr, "
            f"{share:.4f} within {TRAIN_STEP_SHARE} lr  "
            f"{'ok' if good else 'FAIL'}")
    return ok


def grad_refused() -> bool:
    """The kernel wrappers refuse operands that require grad under grad
    mode (their kernels have no backward) and launch nothing."""
    import torch
    from lameness_tpu_torch.ops import attention as at
    q = torch.randn(1, 2, 16, 64, device="cuda", requires_grad=True)
    before = at.KERNEL.launches
    try:
        at.flash_attention(q, q, q)
    except RuntimeError as exc:
        ok = "requires grad" in str(exc) and at.KERNEL.launches == before
    else:
        ok = False
    with torch.no_grad():
        at.flash_attention(q, q, q)
    ok &= at.KERNEL.launches == before + 1
    log(f"  K1 with operands requiring grad: refused, no launch; under "
        f"no_grad launched  {'ok' if ok else 'FAIL'}")
    return ok


def training_phase() -> bool:
    """Phase 9 (in a process of its own: ``chip_smoke.py --training``)."""
    import torch
    from lameness_tpu_torch.core.config import DataDirs
    from lameness_tpu_torch.ops import _cuda
    _cuda.build(["attention", "sam_window_attention", "sam_global_attention"])
    t = [time.perf_counter()]
    ok = grad_refused()
    with tempfile.TemporaryDirectory() as tmp:
        models_dir = f"{tmp}/models"
        eng = default_engine()
        t.append(time.perf_counter())
        ok &= train_detector(eng, models_dir)
        t.append(time.perf_counter())
        dirs = DataDirs(root=f"{tmp}/heads")
        ok &= train_sequence_heads(eng, dirs, models_dir)
        t.append(time.perf_counter())
        ok &= train_pose(eng, models_dir)
        t.append(time.perf_counter())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        dirs = DataDirs(root=f"{tmp}/cows")
        vids = write_cow_videos(dirs.root, cows=GRAPH_COWS,
                                per_cow=GRAPH_PER_COW, tracking=False)
        label_cow_videos(dirs, vids)
        ok &= train_graphs(dirs, models_dir)
        t.append(time.perf_counter())
        ok &= train_tabular(dirs, vids)
        t.append(time.perf_counter())
    ok &= trainers_card_vs_cpu()
    t.append(time.perf_counter())
    names = ("engine", "9a", "9b", "9c", "9d", "9e", "9f")
    log(f"phase 9: {t[-1] - t[0]:.1f} s ("
        + ", ".join(f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:]))
        + ")")
    return ok


def training_in_fresh_process() -> bool:
    """Phase 9 in a process of its own: the profiler readings of a step
    are taken fresh (see hd80_in_fresh_process), and the trainers' memory
    goes with the process."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--training"], timeout=900)
    return res.returncode == 0


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import lameness_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: lameness_tpu_torch not importable ({exc}); run "
              f"from the repository root", file=sys.stderr)
        return 3
    if sys.argv[1:2] == ["--hd80"]:          # hd80_in_fresh_process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return 0 if hd80_kernels(json.loads(sys.argv[2])) else 1
    if sys.argv[1:2] == ["--training"]:      # training_in_fresh_process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return 0 if training_phase() else 1
    smi, hgmma = setup()
    ok_build = all(hgmma[name] > 0 for name in HOPPER_SOURCES)
    if not ok_build:
        log("a library of K1 or K3-K6 holds no HGMMA: its wgmma route was "
            "not built " + json.dumps({n: hgmma[n] for n in HOPPER_SOURCES}))
    log("== phase 2: kernels against their plain versions")
    records, ok_k = check_kernels()
    log("== phase 3: engine")
    ok_small = True
    for sel, env, _ in SELECTIONS:
        with switches(env):
            log(f"small engine, {sel}:")
            ok_small &= check_small_engine()
    launches, ok_e, (eng, frames, *ref) = run_engine()
    log("== phase 4: serving modes")
    ok_m = run_modes(eng, frames, *ref)
    for name, _, small_kw, env, _ in MODES:
        with switches(env):
            log(f"small engine, {name}:")
            ok_m &= check_small_engine(small_kw)
    log("== phase 5: checkpoints")
    with switches({}):
        ok_c = pass_through(eng, frames)
        del eng
        torch.cuda.empty_cache()
        ok_c &= trained_pose(ref[0], frames)
        for name, kw in (("full", None),
                         ("split", {"lo_height": 45, "lo_width": 80})):
            log(f"small engine, trained pose, {name} ingest:")
            ok_c &= check_small_engine(kw, pose=True)
        torch.cuda.empty_cache()
        ok_c &= vit_h(frames)
        log("small engine, SAM at head dim 80:")
        ok_c &= check_small_engine(sam=HD80_SAM)
    log("== phase 6: serving")
    work = tempfile.TemporaryDirectory()
    with switches({}):
        torch.cuda.empty_cache()
        eng = default_engine()
        s = eng.spec
        rng = np.random.default_rng(SEED + 6)
        (clip, cow), *stream = (walking_clip(rng, s)
                                for _ in range(1 + STREAM_CLIPS))
        level, rel, top = calibrate_yolo(eng, clip, cow)
        log(f"  YOLO's cow class set on level {level} (the two sides "
            f"{rel:.3g} projection spreads apart; largest cow logit "
            f"{top:.3g})")
        stream = [c for c, _ in stream]
        ok_s = curation_detector(eng, clip)
        stream = {f"clip{i}.mp4": c for i, c in enumerate(stream)}
        ok_s &= serve_stream(eng, stream,
                             keep_root=f"{work.name}/stream")
        del eng
        torch.cuda.empty_cache()
        log("small engine, serving stream:")
        ok_s &= check_small_stream()
    log("== phase 7: analysis")
    with work:
        gc.collect()            # phase 6's engine, held by reference cycles
        torch.cuda.empty_cache()
        ok_a = analysis(work.name, f"{work.name}/stream", cow, stream)
    log("== phase 8: upload")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, switches({}):
        ok_u, upload_launches = upload_phase(tmp)
    launches.update(upload_launches)
    log("== phase 9: training")
    gc.collect()
    torch.cuda.empty_cache()
    ok_t = training_in_fresh_process()
    for kid, rec in records.items():
        # each kernel's count on its own path (K1 runs on every one)
        rec["launches"] = max(counts[rec["name"]]
                              for counts in launches.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_cuda_ms", "entry_ms", "entry_over_ms", "call_ms",
            "bound_share")
    kern = {"kernels": [{k: rec[k] for k in keys}
                        for rec in records.values()]}
    if not (ok_build and ok_k and ok_small and ok_e and ok_m and ok_c
            and ok_s and ok_a and ok_u and ok_t):
        log("chip_smoke: FAILED")
        return 1
    log(smi)
    log(json.dumps(kern))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
