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
     ``PipelineDriver.process_stream`` over 16 jobs of 8 in-memory 720p
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
  10. platform (no kernel of its own; the app's engine runs K1-K3):
     ``LamenessApp`` with its admin API and SPA on the card, over HTTP with
     urllib. (a) ``GET /`` serves the SPA's index.html; the admin logs in
     and uploads phase 8's 250-frame 720p ``.y4m`` through
     ``POST /api/videos/upload``; the job completes; every result file is
     valid, the SHAP and LLM files and a lameness record exist, the files
     equal ``process_video_file``'s of the same upload on the same engine
     (1e-4; which are bit for bit is printed) and K1-K3 launch at the
     default engine's counts; the seconds from upload to fusion with the
     stage timers; (b) two raters' pairwise and triplet comparisons through
     the API, the rater-reliability and Elo/hierarchy endpoints reflecting
     them, the SHAP what-if of the video; (c) the render endpoint's
     annotated ``.mp4`` (the crop's frame count, streamed by the annotated
     route) against a ``device="cpu"`` render, within 1, ms a frame; (d)
     eight 125-frame uploads of phase 6's cow, each curated and cropped,
     their crops handed back to back to an app batching 4 clips an engine
     call: grouped into 2 engine calls (the batcher's count and K1-K3's
     launches), every job completed, each clip's files equal its crop run
     alone (1e-4), app clips/s beside phase 6's stream at B = 4; (e) a job put
     back to 'processing' with its crop on disk resumed by a new app; (f)
     the tiny app card against CPU, its files key by key (check_small_
     engine's gates).  Its uploads and intermediates live in a temporary
     directory, removed at the end.
  11. the compose topology (no kernel of its own; the worker's engine runs
     K1-K3): (a) ``python -m lameness_tpu_torch nats-server``,
     ``qdrant-server`` (its store on the card) and ``pg-server``, each on
     port 0, as subprocesses; (b) a ``worker`` subprocess on the card with
     ``--warmup``, ``DATABASE_URL`` at the pg-server and phase 10's
     calibrated YOLO restored from its models directory (so it curates
     with YOLO, as the engine here does), driven only over the NATS
     socket: phase 8's upload copied into its data/videos and
     ``video.uploaded`` published from a NatsClient here; the subscriber
     sees the pipeline subjects and ``analysis.complete``; every result
     file valid and equal to ``process_video_file``'s of the same upload
     on the same weights here, TF32 off in both (1e-4; which are bit for
     bit printed); the job row read back through the port's pg client;
     then phase 7's files of one walking video written into its data root
     and ``pipeline.yolo`` and ``pipeline.dinov3`` published: its fusion
     names COW-0001 and that lameness record is read back through the
     port's pg client (the upload's YOLO curation gives ByteTrack no
     confirmed track, so it names no cow); the worker's launch counts,
     printed at SIGINT, K1-K3 at the default engine's; exit 0; publish to
     ``analysis.complete`` seconds with its stage timers; (c) an app here
     with ``reid.vector_url`` at the qdrant-server, its database on the
     pg-server and a NatsBridge: ``make_store`` gives the REST client,
     phase 7's walking videos of 4 cows each named its cow by Re-ID, the
     identities counted over the wire, the lameness records read back
     through the port's pg client, a search over the wire equal to the
     card store's holding the same points (ids; scores 1e-6); (d)
     costs, not gated: NATS publish to delivery at 1 and 64 KB, Qdrant
     searches over the wire beside the in-process store at the Re-ID
     collection's size and at 100,000 vectors of 768, a pg round trip,
     each process's peak GB; (e) ``device_trace`` around one
     default-engine batch names K1, K2 and K3.  Every subprocess is
     stopped in a ``finally`` and must exit with 0.
  12. the mesh (in a process of its own: ``chip_smoke.py --mesh``; every
     mesh repeats cuda:0, the card's machine having one H100): (a) the
     default engine over dp 2 at B = 4, with the heads at dropout 0 and
     at MC dropout, every output bit for bit the unsharded engine on each
     shard's clips alone, fed their rows of the whole batch's MC-dropout
     draws (JAX's rule; ``parallel/same_batch.py``), the generator left
     where the whole-batch call leaves it, and the batch-size difference
     to the unsharded engine at the whole batch printed, not gated; each
     shard's draws its rows of the unsharded draw bit for bit; RGB and
     yuv420 rows transfer, K1-K3 counted over the shards (the ``mesh``
     entry of the launches); B = 3 the same way, the batch padded with a
     zero clip, trimmed; pair and monolith over dp 2 the same way, and
     bit for bit the sharded staged run; dp 2 x tp 2
     (DINO's 12 heads 6 a model shard) against the replicated layout, the
     DINO embeddings within 1e-4 on an f32 engine, the bf16 default's
     difference reported; (b) the train step at DINOv2 ViT-B/14 width
     (224, batch 8, f32, 3 steps) on one device, then dp 2 x tp 2 with
     FSDP from the same weights: the losses within 1e-4 relative, every
     shard and its AdamW moments on its position's device after each step,
     step ms and peak GB (a ``mesh train record`` line); (c)
     sam_encoder_pipeline (ViT-B at 1024², 4 stages x [w, w, g], 2
     microbatches) bit for bit sequential_reference, K2 16 and K3 8;
     sam_ring_attention over a 4-ring at (24, 4096, 64) against K3's plain
     version (f32); mc_dropout_sharded's 8 TCN samples over 4 positions bit
     for bit the stack on one; (d) ``python -m lameness_tpu_torch --dp auto
     process`` (tiny engine) as a dp-1 mesh, ``--dp 2`` refused with JAX's
     message.
  13. the engine's modes (run after phase 4, on phase 3's engine, weights
     and clips: B = 2, bf16): ``pair`` as two captured CUDA graphs,
     ``monolith`` as one. (a) both bit for bit staged, RGB and yuv420
     transfer; (b) K1 12, K2 10, K3 4 a call in each mode, by the
     wrappers' counts (a replay adds the launches recorded in its capture)
     and by the device functions a profiled call ran on the card; (c) two calls in a row with one
     generator equal two staged calls; (d) after ``install_state_dict``
     with other seeded DINO weights the graphs are dropped and a call
     equals ``run_staged`` with the new weights (the weights are put back
     after); (e) a ``readback=False`` tree held across the next call
     unchanged; times, not gated, in the order staged pair monolith
     monolith pair staged: wall and CUDA-event ms a call, device busy of
     one profiled call, capture seconds (a ``modes record`` line).
  14. the tools and the image codec (no kernel of their own; the engines
     the tools drive run K1-K3): (a) seeded 1280x720 and 640x480 frames
     encoded by the port (``video/image.py``) at 4:4:4, 4:2:0 and gray on
     the card and on the CPU: the same quantised blocks and bytes; decoded
     on both: the same pixels (integer arithmetic); ms an image of the
     device half (CUDA events, host clock) and of the host's Huffman coding
     (host clock), each alone; a PNG through the card and back bit for
     bit (a ``codec record`` line); (b) ``lameness_tpu_torch/tools/``, each
     a subprocess with ``--device cuda`` gated on its exit code and its
     files: a seeded 32-image COCO-keypoints set written by ``imwrite``;
     ``prepare_pose_dataset coco --flip-augment``,
     ``analyze_training_orientation``, ``train_pose_model`` (2 epochs at
     320) and ``compare_pose_models`` on its checkpoint,
     ``train_detector --synthetic`` and ``--data`` (1 epoch); the seeded
     default engine's YOLO, SAM and DINO written as ultralytics,
     segment-anything and HF files, converted by ``convert_weights`` and
     installed by ``restore_engine`` into an engine of other seeds: every
     output bit for bit the seeded engine's, K1-K3 at the default's counts;
     ``profile_stages --runs 2 --trace``; ``run_pipeline_example`` on a
     written 720p ``.y4m`` upload.  The phase's seconds are printed.
  15. mp4 (no kernel of its own): the first 50 of phase 8's 720p frames
     written as intra-only mp4v (``video/mpeg4.py`` over
     ``csrc/host/mpeg4_codec.cpp``) on the card and on the CPU: the same
     bytes; that file and ``tests/torch_fixtures/mp4v_gop12.mp4`` (cv2's
     writer, I+P) decoded on both: the same planes; the fixture's luma
     cv2's hashes beside it; the written file's planes the encoder's
     reconstruction; ms a frame of each half at 1280x720 and 640x480
     (device half by CUDA events, host bitstream half by the host clock)
     and bytes a frame against ``.y4m``'s (an ``mp4 record`` line).  The
     curation's canonical clip, the driver's crop and the annotated clip
     of phases 8, 10 and 11 are mp4v ``.mp4`` files, as in JAX.
The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
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
    import concurrent.futures
    from lameness_tpu_torch.ops import _cuda, _host
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the image codec's host library (g++) while nvcc builds the kernels
        host = pool.submit(lambda: (_host.build("image_codec"),
                                    time.perf_counter() - t0))
        secs = _cuda.build()
        host_path, host_s = host.result()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    log(f"host library build: {host_path.name} in {host_s:.2f} s")
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
    torch.profiler; a session that recorded no device event (as in
    ``device_ms``) is asked again, up to three sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    return names


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
STREAM_JOBS = 16
STREAM_BATCHES = (4, 2, 8)
# clips/s of each batch size's stream, for phase 10's batcher record
STREAM_RATES = {}
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
            rates[b] = STREAM_RATES[b] = STREAM_JOBS / wall
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
GRAPH_REPS = 2            # timed process_video calls a target
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


# the device function each of the default engine's kernels launches, as
# torch.profiler names it
DEVICE_FUNCTIONS = {"K1": "lameness::dino_attention_kernel",
                    "K2": "lameness::window_attention_kernel",
                    "K3": "lameness::hopper_global_kernel"}


def device_launches(fn) -> dict:
    """K1-K3's kernels that one call of ``fn`` ran on the card, counted by
    device-function name in a torch.profiler trace: what the card ran,
    a captured graph's replay included, not the wrappers' counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {kid: sum(fname in n for n in names)
            for kid, fname in DEVICE_FUNCTIONS.items()}


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


def upload_frames(n: int, cow_frames, reverse: bool = False,
                  h: int = 720, w: int = 1280, travel: float = 1.0):
    """An upload's frames, generated on the card: a fixed frame of uniform
    noise with +-2 LSB of noise a frame, and the phase-6 cow block (its
    6-pixel cells; COW_SIZE at 1280x720, scaled with the frame) walking
    over the frames ``cow_frames``, from one side across ``travel`` of the
    frame's free width.  MOG2 keeps a cow in view while its pixels change
    colour about every frame or two: cells of 6 pixels (the 5x5 opening
    erases smaller ones) at about 3.8 pixels a frame.  Frame i does not
    depend on ``n``.  Returns ((n, h, w, 3) uint8 on the card, the cow's
    box in each frame or None)."""
    import torch
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
    return frames, boxes


def upload_clip(path, n: int, cow_frames, reverse: bool = False,
                h: int = 720, w: int = 1280, fps: int = UPLOAD_FPS,
                travel: float = 1.0):
    """Write ``upload_frames`` as an upload with the port's ``write_video``
    (converted to I420 on the card; a ``path`` with no suffix is a
    ``.y4m``).  Returns (the path written, the cow's box in each frame or
    None)."""
    from lameness_tpu_torch.video.decode import write_video
    frames, boxes = upload_frames(n, cow_frames, reverse, h, w, travel)
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
        Path(root).glob("*/up*.*")) if p.suffix in (".y4m", ".mp4")}
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


def tiny_engine(dev):
    """The tiny engine of ``small_stream_files`` at dropout 0 on ``dev``."""
    import torch
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.pipeline.engine import make_test_engine
    from lameness_tpu_torch.weights import seeded_state_dict
    gen = torch.Generator().manual_seed(SEED)
    eng = make_test_engine(device=dev, with_sam=True, generator=gen)
    eng.tcn = TCN(input_dim=44, dropout=0.0, device=dev)
    eng.gait = GaitTransformer(input_dim=44, dropout=0.0, device=dev)
    eng.load_state_dicts({"tcn": seeded_state_dict(eng.tcn, gen),
                          "gait": seeded_state_dict(eng.gait, gen)})
    return eng


def capture_outputs(drv) -> dict:
    """The engine outputs behind ``drv``'s result files, collected as the
    driver writes them (one clip: {key: array})."""
    outs = {}
    write = drv._write_stage_results

    def capture(video_id, out, bi, scale, info):
        outs.update({k: v[bi] for k, v in leaves(out)})
        return write(video_id, out, bi, scale, info)
    drv._write_stage_results = capture
    return outs


def small_chain(dev, root, src):
    """The tiny engine of ``small_stream_files`` (dropout 0) and its graph
    heads at dropout 0 on ``dev``: ``process_video_file(src)`` with the
    motion fallback.  Returns {file: parsed JSON}, the engine outputs and
    the crop's scale to the engine's frame (the files' pixel coordinates are
    the outputs' times it)."""
    from pathlib import Path
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.driver import PipelineDriver
    eng = tiny_engine(dev)
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=str(root))),
                         engine=eng)
    drv.graph_runner = zero_dropout(graph_runner(root, dev))
    outs = capture_outputs(drv)
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
    ok = small_runs_agree(runs, tmp, "small chain")
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


def small_runs_agree(runs, tmp, label: str, loose=()) -> bool:
    """The card's and the CPU's small chain ({"cpu"/"cuda": (files, engine
    outputs, crop scale)}): the engine's outputs under check_small_engine's
    gates; the files key by key (list lengths equal, the clock and Re-ID's
    random ids apart; strings under the keys ``loose``, text rendered from
    the numbers, by their keys only), their numbers within 1e-4 times the
    crop's scale to the engine's frame (pixel coordinates are the outputs'
    times it), a sam3 file only where the masks are equal bit for bit."""
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
            elif key.rsplit(".", 1)[-1] in loose:
                ok &= type(x) is type(y)
            elif not (isinstance(x, str) and x.startswith(str(tmp))):
                ok &= x == y
    ok &= worst <= 1e-4 * scale
    quality = cpu["quality_reports/small_quality.json"]
    log(f"  {label}: status {quality['status']}, window "
        f"{quality['selected_window'] and quality['selected_window']['start_frame']}"
        f", {quality['walking_passes_detected']} passes; the crop {scale:.3f}"
        f"x the engine's frame")
    log(f"  {label} card vs CPU: engine outputs max_abs_err "
        f"{out_err:.3e}, mask agreement {masks:.5f}; {len(cpu)} files, "
        f"{compared} compared key by key, max_abs_err {worst:.3e} ({where};"
        f" gate {1e-4 * scale:.3e})  {'ok' if ok else 'FAIL'}")
    return ok


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
# ultralytics' learning-rate recipe: a linear ramp from 0 over DET_WARMUP
# steps, then a linear fall to DET_FINAL x DET_LR at the last step.  At a
# constant DET_LR the loss spikes (the class logits jump by orders of
# magnitude for a step) at any point of the run, and the EMA weights that
# 9a scores are, 400 steps in, about the last step's: a late spike left no
# cow found in 3 of 9 whole-script runs (PERF.md, PR 20)
DET_WARMUP = 50
DET_FINAL = 0.01
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


def det_schedule(lr=DET_LR, warmup=DET_WARMUP, final=DET_FINAL,
                 steps=DET_STEPS):
    """The learning rate of update n (0 first) of 9a's DetectTrainer."""
    def rate(n: int) -> float:
        if n < warmup:
            return lr * (n + 1) / warmup
        return lr * (1 - (1 - final) * (n - warmup) / max(1, steps - warmup))
    return rate


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
    """9a: DetectTrainer at 640, batch 16, on det_schedule; the loss must
    fall, and the EMA weights, saved and restored into the default engine,
    must find the cow on DET_FOUND of a walking clip's detect frames."""
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
    trainer = DetectTrainer(model, lr=det_schedule())

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


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------
# the platform: LamenessApp with its admin API and SPA on the card, spoken
# to over HTTP with urllib (the card's machine has no httpx).  The admin's
# password is set before the app seeds its accounts; the raters of (b) are
# made through the API.  (d) runs APP_UPLOADS uploads of APP_FRAMES frames
# through an app batching APP_BATCH clips an engine call.
APP_BATCH, APP_UPLOADS, APP_FRAMES = 4, 8, 125
# the seconds 10d's batched and alone runs take together, with room
APP_MTIME_S = 45
ADMIN_PASSWORD = "phase-10-admin"
UUID_RE = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                     r"[0-9a-f]{12}$")
# the result files of an app's analysis beside the chain's
APP_FILES = ("shap", "explanations")


class Api:
    """The admin API of an app over urllib: ``call`` gives (status,
    payload: parsed JSON or bytes, content type); ``ok`` raises unless the
    status is 200."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"
        self.token = None

    def call(self, method, path, body=None, raw=None, token=None,
             timeout=120):
        import urllib.error
        import urllib.request
        headers, data = {}, None
        if raw is not None:
            data = raw
            headers["Content-Type"] = "application/octet-stream"
        elif body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if token or self.token:
            headers["Authorization"] = f"Bearer {token or self.token}"
        req = urllib.request.Request(self.base + path, data=data,
                                     headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                status, ctype, out = r.status, r.headers["Content-Type"], \
                    r.read()
        except urllib.error.HTTPError as e:
            status, ctype, out = e.code, e.headers["Content-Type"], e.read()
        if ctype and "json" in ctype:
            out = json.loads(out)
        return status, out, ctype

    def ok(self, method, path, **kw):
        status, out, _ = self.call(method, path, **kw)
        if status != 200:
            raise RuntimeError(f"{method} {path}: HTTP {status} {out!r:.300}")
        return out

    def login(self, user: str, password: str) -> str:
        return self.ok("POST", "/api/auth/login", body={
            "username": user, "password": password})["access_token"]


def platform_app(root, eng, **kw):
    """A ``LamenessApp`` on ``root`` with ``eng``; its admin seeded with
    ADMIN_PASSWORD first (the app seeds the other accounts)."""
    from datetime import datetime, timezone
    from pathlib import Path
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io.db import open_database
    from lameness_tpu_torch.serve.app import LamenessApp
    from lameness_tpu_torch.serve.http import hash_password
    cfg = Config(dirs=DataDirs(root=str(root)))
    cfg.dirs.ensure()
    open_database(Path(root) / "lameness.db").insert("users", {
        "email": "admin@lameness.local", "username": "admin",
        "password_hash": hash_password(ADMIN_PASSWORD), "role": "admin",
        "is_active": 1, "created_at": datetime.now(timezone.utc).isoformat()})
    return LamenessApp(config=cfg, engine=eng, reactive=True, **kw)


def placeholders(obj, root, vid):
    """``obj`` without its VOLATILE_KEYS, and in its strings the run's data
    root, its video id and random ids (uuid4) by placeholders."""
    if isinstance(obj, dict):
        return {k: placeholders(v, root, vid) for k, v in obj.items()
                if k not in VOLATILE_KEYS}
    if isinstance(obj, list):
        return [placeholders(v, root, vid) for v in obj]
    if isinstance(obj, str):
        obj = obj.replace(str(root), "ROOT").replace(vid, "VID")
        return "UUID" if UUID_RE.match(obj) else obj
    return obj


def same_files(a, b, tol: float = 1e-4, kinds=CHAIN_FILES):
    """Two runs' chain files, ``(root, video id, {kind: JSON})`` each, key
    by key through ``json_diff`` once ``placeholders`` has named each run's
    root and id alike: the same keys and other leaves, floats within
    ``tol``.  Returns (ok, max |diff|, the kinds equal bit for bit)."""
    (ra, va, fa), (rb, vb, fb) = a, b
    ok, worst, equal = True, 0.0, []
    for kind in kinds:
        if fa[kind] is None or fb[kind] is None:
            ok = False
            continue
        err, same = json_diff(placeholders(fb[kind], rb, vb),
                              placeholders(fa[kind], ra, va))
        worst = max(worst, err)
        ok &= same and err <= tol
        if same and err == 0:
            equal.append(kind)
    return ok, worst, equal


def reset_counts():
    import torch
    from lameness_tpu_torch.ops._cuda import KERNELS
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0


def read_counts() -> dict:
    import torch
    from lameness_tpu_torch.ops._cuda import KERNELS
    torch.cuda.synchronize()
    return {name: k.launches for name, k in KERNELS.items()}


def api_upload(eng, tmp, src) -> tuple:
    """10a: the upload through the app's API against ``process_video_file``
    of the same upload, under the same video id, on the same engine.
    Returns (ok, the launch counts, the app, its API, the video id)."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.serve import api as api_mod
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from lameness_tpu_torch.utils.timing import TIMERS
    app = platform_app(f"{tmp}/app", eng, serve_api=True, api_port=0)
    api = Api(app.server.port)
    status, page, ctype = api.call("GET", "/")
    spa = (Path(api_mod.__file__).parent / "static" / "index.html")
    checks = {"GET / serves the SPA's index.html": (
        status == 200 and page == spa.read_bytes()
        and ctype.startswith("text/html")),
        "GET /static/app.js": api.call("GET", "/static/app.js")[0] == 200}
    api.token = api.login("admin", ADMIN_PASSWORD)
    data = src.read_bytes()
    TIMERS.reset()
    reset_counts()
    t0 = time.perf_counter()
    vid = api.ok("POST", "/api/videos/upload?filename=walk.y4m", raw=data,
                 timeout=600)["video_id"]
    job = None
    while time.perf_counter() - t0 < 300:
        jobs = api.ok("GET", "/api/training/queue")["jobs"]
        job = next((j for j in jobs if j["video_id"] == vid), None)
        if job and job["status"] != "processing":
            break
        time.sleep(0.2)
    launches = read_counts()
    wall = time.perf_counter() - t0
    stages = {**app.driver.curator.timers.summary(), **TIMERS.summary()}
    video = api.ok("GET", f"/api/videos/{vid}")
    analysis = api.ok("GET", f"/api/analysis/{vid}")
    # the reference: process_video_file of the same upload under the same
    # id (the graph heads' MC-dropout draws are seeded from the id)
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=f"{tmp}/ref")),
                         engine=eng)
    drv.process_video_file(src, vid)
    drv.bus.shutdown()
    root = Path(app.dirs.root)
    files = chain_files(root, vid)
    invalid = [k for k, v in files.items()
               if v is None or schemas.validate(k, v)]
    shap = root / "results" / "shap" / f"{vid}_shap.json"
    expl = root / "results" / "explanations" / f"{vid}_explanation.json"
    same, worst, equal = same_files((f"{tmp}/ref", vid,
                                     chain_files(f"{tmp}/ref", vid)),
                                    (root, vid, files))
    fusion = files["fusion"] or {}
    cow = fusion.get("cow_id")
    records = app.db.lameness_history(cow) if cow else []
    checks.update({
        "the job completed": bool(job) and job["status"] == "completed",
        "the video has its analysis": bool(video.get("has_analysis"))
        and "final_probability" in analysis["fusion"]
        and set(RESULT_KINDS) <= set(analysis["pipelines"]),
        "every result file written and valid": not invalid,
        "the SHAP and LLM files": shap.exists() and expl.exists()
        and json.loads(expl.read_text())["provider"] == "local_template",
        f"Re-ID named a cow ({cow}) and the app recorded its lameness":
        len(records) == 1
        and abs(records[0]["fusion_score"] - fusion["fusion_result"]
                ["final_probability"]) < 1e-12,
        "the files equal process_video_file's (1e-4)": same,
        "K1-K3 at the default engine's counts": expect_launches(
            launches, BASE_LAUNCHES)})
    log("platform upload record " + json.dumps({
        "upload_bytes": len(data), "upload_to_fusion_s": wall,
        "stage_s": {k: stages[k]["last_s"] if stages[k]["count"] == 1
                    else stages[k]["mean_s"] * stages[k]["count"]
                    for k in UPLOAD_TIMERS if k in stages},
        "cow_named_by_reid": fusion.get("cow_id"),
        "files_bit_for_bit": equal, "max_abs_diff_vs_driver": worst,
        "launches": {k: v for k, v in launches.items() if v},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    ok = True
    for what, good in checks.items():
        log(f"  10a {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok, launches, app, api, vid


def api_hitl(app, api, vid) -> bool:
    """10b: two raters' pairwise and triplet comparisons through the API;
    the rater-reliability and Elo/hierarchy endpoints after them; the SHAP
    what-if of the analysed video."""
    from datetime import datetime, timezone
    now = datetime.now(timezone.utc).isoformat()
    others = ["p10-b", "p10-c"]
    for o in others:
        app.db.insert("videos", {"id": o, "filename": f"{o}.y4m",
                                 "file_size": 0, "status": "uploaded",
                                 "uploaded_at": now})
    tokens = {}
    for name, tier in (("rater1", "gold"), ("rater2", "silver")):
        api.ok("POST", "/api/auth/users", body={
            "username": name, "password": name + "-pw", "role": "rater",
            "rater_tier": tier})
        tokens[name] = api.login(name, name + "-pw")
    pairs = [(vid, others[0], 1), (others[0], others[1], 2),
             (vid, others[1], 1)]
    for name, tok in tokens.items():
        for a, b, w in pairs:
            api.ok("POST", "/api/elo/comparison", token=tok, body={
                "video_id_1": a, "video_id_2": b, "winner": w, "degree": 2})
            api.ok("POST", "/api/training/pairwise", token=tok, body={
                "video_id_1": a, "video_id_2": b, "winner": w, "degree": 2,
                "confidence": "confident"})
        api.ok("POST", "/api/training/triplet/submit", token=tok, body={
            "reference_id": vid, "comparison_a_id": others[0],
            "comparison_b_id": others[1], "selected_answer": "A",
            "task_type": "similarity"})
    progress = {n: api.ok("GET", "/api/training/learn/progress", token=t)
                for n, t in tokens.items()}
    hierarchy = api.ok("GET", "/api/elo/hierarchy")
    stats = api.ok("GET", "/api/elo/stats")
    triplets = api.ok("GET", "/api/training/triplet/stats")
    whatif = api.ok("POST", f"/api/shap/{vid}/what-if",
                    body={"feature_index": 0, "values": [0.0, 0.5, 1.0],
                          "modifications": {}})
    ranked = {r["video_id"]: r for r in hierarchy["ranking"]}
    checks = {
        "each rater's comparisons and reliability stats": all(
            p["comparisons"] == 2 * len(pairs)
            and p["gold_accuracy"] is not None for p in progress.values()),
        "the reliability service holds both raters": {
            "rater1", "rater2"} <= set(app.reliability.rater_stats),
        "the hierarchy ranks the three videos": set(ranked) == {vid, *others}
        and hierarchy["total_comparisons"] == 4 * len(pairs)
        and ranked[vid]["elo_rating"] > 1500,
        "the Elo stats count them": stats["total_comparisons"]
        == 4 * len(pairs),
        "the triplets": triplets["total_triplets"] == 2,
        "the what-if answers": {"original_prediction",
                                "modified_prediction"} <= set(whatif)}
    log("platform hitl record " + json.dumps({
        "ranking": [(r["video_id"][:8], r["elo_rating"], r["rank"])
                    for r in hierarchy["ranking"]],
        "steepness": hierarchy["steepness"],
        "inter_rater_reliability": hierarchy["inter_rater_reliability"],
        "raters": {n: {k: p[k] for k in ("comparisons", "tier",
                                         "gold_accuracy")}
                   for n, p in progress.items()},
        "what_if": {k: whatif[k] for k in ("original_prediction",
                                           "modified_prediction")}}))
    ok = True
    for what, good in checks.items():
        log(f"  10b {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def api_annotation(app, api, vid, tmp) -> bool:
    """10c: the render endpoint on the card; its frames against a
    ``device="cpu"`` render of the same inputs (as each render hands them
    to its writer: the annotated clip is mp4v, lossy), and the annotated
    ``.mp4`` the route streams."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.serve import annotation
    from lameness_tpu_torch.serve.annotation import AnnotationRenderer
    from lameness_tpu_torch.video.decode import VideoReader
    crop = Path(app.dirs.processed) / f"{vid}_cropped.mp4"
    with VideoReader(crop, device="cuda") as vr:
        n = vr.info["total_frames"]
        size = (vr.info["width"], vr.info["height"])
    written = []
    real_write = annotation.write_video

    def keep(path, frames, *args, **kwargs):
        written.append(frames.cpu() if isinstance(frames, torch.Tensor)
                       else torch.from_numpy(np.stack(frames)))
        return real_write(path, frames, *args, **kwargs)
    annotation.write_video = keep
    try:
        t0 = time.perf_counter()
        st = api.ok("POST", f"/api/videos/{vid}/annotate")
        card_s = time.perf_counter() - t0
        cpu = AnnotationRenderer(app.dirs, device="cpu")
        cpu.out_dir = Path(tmp) / "annotated_cpu"
        cpu.out_dir.mkdir()
        t0 = time.perf_counter()
        cpu.render(vid)
        cpu_s = time.perf_counter() - t0
    finally:
        annotation.write_video = real_write
    out = Path(st["output"])
    a, b = (w.to(torch.int16) for w in written)
    diff = int((a - b).abs().max()) if a.shape == b.shape else None
    with VideoReader(out, device="cuda") as vr:
        back = vr.info["total_frames"]
    status, body, ctype = api.call("GET", f"/api/videos/{vid}/annotated")
    checks = {
        "an annotated .mp4 with the crop's frame count": (
            out.name == f"{vid}_annotated.mp4" and st["frames"] == n
            and back == n),
        "the annotated route streams it as video/mp4": status == 200
        and ctype == "video/mp4" and len(body) == out.stat().st_size,
        "the card's frames within 1 of the CPU's": diff is not None
        and diff <= 1}
    log("platform annotation record " + json.dumps({
        "frames": n, "size": size, "card_ms_a_frame": card_s * 1e3 / n,
        "cpu_ms_a_frame": cpu_s * 1e3 / n, "max_abs_diff": diff,
        "bytes": out.stat().st_size}))
    ok = True
    for what, good in checks.items():
        log(f"  10c {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def wait_batcher(app, clips: int, timeout_s: float = 300) -> None:
    """Until ``app``'s batcher has run ``clips`` clips (it counts a batch
    once its stream has returned, after the batch's fusion files)."""
    deadline = time.perf_counter() + timeout_s
    while app._batcher.clips_run < clips and time.perf_counter() < deadline:
        time.sleep(0.02)


def one_mtime_bucket(need_s: float) -> float:
    """Sleep until float32 keeps one value of the file clock for the next
    ``need_s`` seconds; returns the seconds slept.  The graph runner reads
    each herd video's ``_dinov3.json`` mtime as float32 (128 s apart at
    today's epoch seconds) into the Graphormer's temporal encoding, so two
    runs of the same clips agree only when neither straddles a step."""
    now = time.time()
    step = float(np.spacing(np.float32(now)))
    left = (np.floor(now / step + 0.5) + 0.5) * step - now
    if left >= need_s:
        return 0.0
    time.sleep(left + 0.5)
    return left + 0.5


def app_batcher(eng, tmp) -> bool:
    """10d: APP_UPLOADS uploads of phase 6's walking cow through an app
    batching APP_BATCH clips an engine call.  Each upload is curated and
    cropped in the submitting thread, as in 10a; the crops then reach the
    batcher back to back, as they do when uploads come in faster than they
    are curated, and it must group them into APP_UPLOADS / APP_BATCH engine
    calls.  Each clip's files against its crop run alone through a second
    such app (the clip padded to APP_BATCH by repeats): all of them for
    the clips in row 0 of their batch, and for the others those that read
    no MC-dropout draw (the draws follow the row)."""
    import torch
    vids = [f"c{i}" for i in range(APP_UPLOADS)]
    srcs = [upload_clip(f"{tmp}/{v}", APP_FRAMES, COW_FRAMES)[0]
            for v in vids]
    app = platform_app(f"{tmp}/batch", eng, clip_batch=APP_BATCH)
    alone = platform_app(f"{tmp}/alone", eng, clip_batch=APP_BATCH)
    try:
        held = []
        app._batcher.submit = lambda vid, path: held.append((vid, path))
        t0 = time.perf_counter()
        for vid, src in zip(vids, srcs):
            app.submit_video(src, vid)
        curate_s = time.perf_counter() - t0
        del app._batcher.submit
        waited = one_mtime_bucket(APP_MTIME_S)
        reset_counts()
        t1 = time.perf_counter()
        for job in held:
            app._batcher.submit(*job)
        done = [app.wait_for_analysis(v, timeout_s=300) for v in vids]
        wall = time.perf_counter() - t1
        wait_batcher(app, APP_UPLOADS)
        launches = read_counts()
        batches, clips = app._batcher.batches_run, app._batcher.clips_run
        jobs = app.db.query("SELECT status FROM processing_jobs")
        for i, job in enumerate(held):
            alone._batcher.submit(*job)
            wait_batcher(alone, i + 1)
        alone_batches = alone._batcher.batches_run
    finally:
        app.close()
        alone.close()
    for src in srcs:
        src.unlink()
    fixed = tuple(k for k in CHAIN_FILES if k not in
                  ("tcn", "transformer", "ml", "fusion"))
    vs_alone, worst, equal = True, 0.0, {}
    for i, v in enumerate(vids):
        good, err, same = same_files(
            (f"{tmp}/alone", v, chain_files(f"{tmp}/alone", v)),
            (f"{tmp}/batch", v, chain_files(f"{tmp}/batch", v)),
            kinds=CHAIN_FILES if i % APP_BATCH == 0 else fixed)
        vs_alone &= good
        worst = max(worst, err)
        equal[v] = len(same)
    checks = {
        "every upload analysed": all(done) and clips == APP_UPLOADS,
        "every job completed": [j["status"] for j in jobs]
        == ["completed"] * APP_UPLOADS,
        f"the crops grouped into {APP_UPLOADS // APP_BATCH} engine calls":
        batches == APP_UPLOADS // APP_BATCH,
        "K1-K3 at those calls' counts": expect_launches(
            launches, {k: v * APP_UPLOADS // APP_BATCH
                       for k, v in BASE_LAUNCHES.items()}),
        "each clip's files equal its run alone (1e-4)": vs_alone
        and alone_batches == APP_UPLOADS}
    log("platform batcher record " + json.dumps({
        "uploads": APP_UPLOADS, "frames": APP_FRAMES, "max_batch": APP_BATCH,
        "engine_calls": batches, "curate_s": curate_s, "wall_s": wall,
        "mtime_step_wait_s": waited,
        "app_clips_s": APP_UPLOADS / wall,
        "upload_to_fusion_clips_s": APP_UPLOADS / (curate_s + wall),
        "stream_clips_s_at_4": STREAM_RATES.get(4),
        "launches": {k: v for k, v in launches.items() if v},
        "kinds_bit_for_bit_vs_alone": equal,
        "max_abs_diff_vs_alone": worst,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    ok = True
    for what, good in checks.items():
        log(f"  10d {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def app_resume(eng, tmp, vid) -> bool:
    """10e: 10a's job put back to 'processing', its fusion file gone and
    its crop present, resumed by a new app as the ``resume`` subcommand
    does."""
    from pathlib import Path
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.app import LamenessApp
    cfg = Config(dirs=DataDirs(root=f"{tmp}/app"))
    fusion = cfg.dirs.results_for("fusion") / f"{vid}_fusion.json"
    fusion.unlink()
    app = LamenessApp(config=cfg, engine=eng, reactive=True)
    try:
        job = app.db.one("SELECT job_id FROM processing_jobs WHERE "
                         "video_id=?", (vid,))
        app.db.update("processing_jobs", job["job_id"],
                      {"status": "processing"}, pk="job_id")
        crop = Path(cfg.dirs.processed) / f"{vid}_cropped.mp4"
        t0 = time.perf_counter()
        n = app.resume_inflight_jobs()
        wall = time.perf_counter() - t0
        row = app.db.one("SELECT status FROM processing_jobs WHERE "
                         "video_id=?", (vid,))
    finally:
        app.close()
    good = (crop.exists() and n == 1 and fusion.exists()
            and row["status"] == "completed")
    log(f"  10e resumed {n} job from its crop in {wall:.2f} s: fusion "
        f"written {fusion.exists()}, job {row['status']}  "
        f"{'ok' if good else 'FAIL'}")
    return good


def small_app_chain(dev, root, src):
    """The tiny engine's app on ``dev``: the upload through
    ``submit_video`` (the motion fallback).  Returns small_chain's
    triple."""
    from pathlib import Path
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.serve.app import LamenessApp
    eng = tiny_engine(dev)
    app = LamenessApp(config=Config(dirs=DataDirs(root=str(root))),
                      engine=eng, reactive=True)
    app.driver.graph_runner = zero_dropout(graph_runner(root, dev))
    outs = capture_outputs(app.driver)
    app.submit_video(src, "small")
    app.close()
    x1, y1, x2, y2 = app.bus.messages_on("video.preprocessed")[0]["crop_box"]
    scale = max(1.0, (x2 - x1) / eng.spec.frame_width,
                (y2 - y1) / eng.spec.frame_height)
    files = {p.relative_to(root).as_posix(): json.loads(p.read_text())
             for p in sorted(Path(root).glob("*/**/*.json"))}
    return files, outs, scale


def check_small_app(tmp) -> bool:
    """10f: the tiny app card against CPU over phase 8's small upload, its
    result files (the SHAP and LLM ones too) key by key."""
    u = SMALL_UPLOAD
    src, _ = upload_clip(f"{tmp}/small", u["n"], u["cow"], h=u["h"],
                         w=u["w"], fps=u["fps"])
    runs = {dev: small_app_chain(dev, f"{tmp}/small_app_{dev}", src)
            for dev in ("cpu", "cuda")}
    names = set(runs["cuda"][0])
    ok = all(any(f"results/{k}/" in n for n in names) for k in APP_FILES)
    return small_runs_agree(runs, tmp, "small app",
                            loose=("prompt", "explanation")) and ok


def platform_phase(tmp) -> tuple:
    """Phase 10: 10a-10f.  Returns (ok, the launch counts of 10a's upload:
    the platform's main path, one engine call)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = default_engine()
    rng = np.random.default_rng(SEED + 6)
    clip, cow = walking_clip(rng, eng.spec)       # phase 6's calibration
    calibrate_yolo(eng, clip, cow)
    del clip
    src, _ = upload_clip(f"{tmp}/upload", UPLOAD_FRAMES, UPLOAD_COW)
    t1 = time.perf_counter()
    launches = {}
    ok, launches["platform, API upload"], app, api, vid = api_upload(
        eng, tmp, src)
    src.unlink()
    t2 = time.perf_counter()
    try:
        ok &= api_hitl(app, api, vid)
        t3 = time.perf_counter()
        ok &= api_annotation(app, api, vid, tmp)
    finally:
        app.close()
    t4 = time.perf_counter()
    ok &= app_batcher(eng, tmp)
    t5 = time.perf_counter()
    ok &= app_resume(eng, tmp, vid)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    log("small engine, app:")
    ok &= check_small_app(tmp)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s (engine, calibration "
        f"and upload {t1 - t0:.1f}, 10a {t2 - t1:.1f}, 10b {t3 - t2:.1f}, "
        f"10c {t4 - t3:.1f}, 10d {t5 - t4:.1f}, 10e {t6 - t5:.1f}, 10f "
        f"{time.perf_counter() - t6:.1f}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return ok, launches


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------
# the compose topology on the card (deploy/docker-compose.yml's shape): the
# broker, the vector server and the Postgres-wire server, and a headless
# worker, each a ``python -m lameness_tpu_torch`` subprocess.  Each server
# prints its URL first (with the port it bound: they start on port 0); the
# worker prints "worker ready" and, at SIGINT, "worker stopped {...}" (its
# launch counts since ready, its stage timers, its peak GB); the vector
# server "qdrant-server stopped {...}" (its peak GB).
PG_USER, PG_PASSWORD = "lameness_user", "lameness_pass"
COMPOSE_VIDEO = "compose-upload"
WIRE_VECTORS = 100_000     # 11d: the large collection, 768-d (307 MB)
WIRE_REPS = 10
SCORE_TOL = 1e-6           # a search over the wire against the store
# 11e: the device function of each kernel's route at the default engine's
# shapes in bf16 (K1 dino_entry's Hopper routine, K2 the window routine, K3
# the Hopper global routine), as the trace names them
TRACE_KERNELS = {"K1": "dino_attention_kernel",
                 "K2": "window_attention_kernel",
                 "K3": "hopper_global_kernel"}


class Service:
    """A ``python -m lameness_tpu_torch ARGV`` subprocess whose output
    lines (stdout and stderr) a thread collects.  ``expect`` waits for a
    line and raises if the process exits first; ``stop`` sends SIGINT and
    returns the exit code."""

    def __init__(self, name: str, argv, env=None):
        import queue
        import threading
        self.name, self.lines = name, []
        self._q = queue.Queue()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lameness_tpu_torch", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self._q.put(line.rstrip("\n"))
        self._q.put(None)

    def expect(self, pred, timeout_s: float) -> str:
        import queue
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                line = self._q.get(timeout=max(0.0, deadline
                                               - time.perf_counter()))
            except queue.Empty:
                raise RuntimeError(f"{self.name}: no such line in "
                                   f"{timeout_s} s; last {self.lines[-5:]}")
            if line is None:
                raise RuntimeError(f"{self.name} exited (rc "
                                   f"{self.proc.wait()}); last "
                                   f"{self.lines[-8:]}")
            self.lines.append(line)
            if pred(line):
                return line

    def stop(self, timeout_s: float = 120) -> int:
        """SIGINT, then the exit code; the rest of its output read."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        import queue
        try:
            while (line := self._q.get(timeout=10)) is not None:
                self.lines.append(line)
        except queue.Empty:
            pass
        return self.proc.returncode

    def line_after(self, prefix: str):
        """The JSON after ``prefix`` on the first line that starts with it,
        or None."""
        return next((json.loads(line[len(prefix):]) for line in self.lines
                     if line.startswith(prefix)), None)


def start_servers(tmp) -> dict:
    """11a: the three servers, started together; {name: (Service, URL)}
    with each URL from the server's first line."""
    argv = {"nats": ["nats-server", "--port", "0"],
            "qdrant": ["qdrant-server", "--port", "0", "--persist",
                       f"{tmp}/vectors.json"],
            "pg": ["pg-server", "--port", "0", "--path", f"{tmp}/db.sqlite",
                   "--user", PG_USER, "--password", PG_PASSWORD]}
    services = {name: Service(f"{name} server", a) for name, a in
                argv.items()}
    urls = {}
    for name, svc in services.items():
        first = svc.expect(lambda line: "://" in line, 180)
        urls[name] = first.split()[-1].replace("***", PG_PASSWORD)
    return services, urls


def worker_job(eng, tmp, src, services, urls) -> tuple:
    """11b: the worker on the card, driven over the NATS socket only, held
    against ``process_video_file`` of the same upload on ``eng`` (the same
    seed-0 weights and calibrated YOLO, which the worker restored from
    ``<data>/models/yolo``); then the back half of a walking video whose
    cow the worker names, its lameness record read from the pg-server.
    Returns (ok, the worker's launch counts, its peak GB)."""
    import threading
    from datetime import datetime, timezone
    from pathlib import Path
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.io import schemas
    from lameness_tpu_torch.io.db import open_database
    from lameness_tpu_torch.io.nats_wire import NatsClient
    from lameness_tpu_torch.serve.driver import PipelineDriver
    data, vid = Path(tmp) / "data", COMPOSE_VIDEO
    t0 = time.perf_counter()
    worker = services["worker"] = Service(
        "worker", ["--data", str(data), "worker", "--nats-url",
                   urls["nats"], "--warmup"],
        env={**os.environ, "DATABASE_URL": urls["pg"]})
    bridge = worker.expect(lambda line: line.startswith("NATS bridge:"), 300)
    worker.expect(lambda line: line == "worker ready", 600)
    ready_s = time.perf_counter() - t0
    seen = collections.defaultdict(list)
    analysed = collections.defaultdict(threading.Event)
    ended = threading.Event()
    nc = NatsClient(urls["nats"], name="chip-smoke").connect(timeout_s=30)
    try:
        for subject in vars(Config().subjects).values():
            if subject.startswith("pipeline.") or \
                    subject == "analysis.complete":
                nc.subscribe(subject, lambda m, s=subject: seen[s].append(m))
        nc.subscribe("analysis.complete",
                     lambda m: analysed[m.get("video_id")].set())
        # the bus dispatches synchronously: video.preprocessed's handler
        # runs the engine and the back half (analysis.complete goes out
        # from inside it), and the bridge mirrors video.preprocessed itself
        # last, once that handler has returned
        nc.subscribe("video.preprocessed", lambda m: ended.set())
        nc.flush(30)
        # what PipelineDriver.ingest does: the upload into data/videos, then
        # video.uploaded
        dest = data / "videos" / f"{vid}.y4m"
        shutil.copyfile(src, dest)
        t1 = time.perf_counter()
        nc.publish("video.uploaded", {
            "video_id": vid, "filename": src.name, "path": str(dest),
            "uploaded_at": datetime.now(timezone.utc).isoformat()})
        done = analysed[vid].wait(600)
        to_analysis = time.perf_counter() - t1
        done &= ended.wait(300)
        to_end = time.perf_counter() - t1
        # the back half over the socket for a video whose cow the worker
        # names: phase 7's result files of one walking video written into
        # its data root, then pipeline.yolo (tracking and Re-ID) and
        # pipeline.dinov3 (the graph heads, ML, fusion) published, as 11c
        # does in process.  The upload's curation (YOLO, from the restored
        # checkpoint) gives ByteTrack no confirmed track, so it names no cow
        (walk,) = write_cow_videos(data, cows=1, per_cow=1, tracking=False)
        t2 = time.perf_counter()
        nc.publish("pipeline.yolo", {"video_id": walk})
        nc.publish("pipeline.dinov3", {"video_id": walk})
        walked = analysed[walk].wait(300)
        walk_s = time.perf_counter() - t2
    finally:
        nc.close()
    # the reference: process_video_file of the same upload under the same
    # id on the in-process engine (TF32 off here, as in the worker)
    reset_counts()
    drv = PipelineDriver(config=Config(dirs=DataDirs(root=f"{tmp}/ref")),
                         engine=eng)
    drv.process_video_file(src, vid)
    ref_launches = read_counts()
    drv.bus.shutdown()
    ref_pipeline = {m["subject"] for m in drv.bus.history
                    if m["subject"].startswith("pipeline.")}
    seen_pipeline = {s for s, ms in seen.items() if s.startswith("pipeline.")
                     and any(m.get("video_id") == vid for m in ms)}
    files = chain_files(data, vid)
    invalid = [k for k, v in files.items()
               if v is None or schemas.validate(k, v)]
    same, worst, equal = same_files(
        (f"{tmp}/ref", vid, chain_files(f"{tmp}/ref", vid)),
        (data, vid, files))
    if not same:                      # the first leaves of each kind apart
        ref = chain_files(f"{tmp}/ref", vid)
        apart = {}
        for k in CHAIN_FILES:
            got = dict(json_leaves(files[k] or {}))
            apart[k] = [(key, x, got.get(key)) for key, x in
                        json_leaves(ref[k] or {}) if got.get(key) != x][:3]
        log("  11b differing leaves " + json.dumps(apart, default=str))
    cow = (files["fusion"] or {}).get("cow_id")
    fusion = json.loads((data / "results" / "fusion"
                         / f"{walk}_fusion.json").read_text()) if walked \
        else {}
    walk_cow = fusion.get("cow_id")
    # the job row and the walking video's lameness record, read back from
    # the pg-server through the port's client
    t3 = time.perf_counter()
    db = open_database(urls["pg"])
    job = db.one("SELECT status FROM processing_jobs WHERE video_id=?",
                 (vid,))
    read_s = time.perf_counter() - t3
    records = [r for r in db.lameness_history(walk_cow or "")
               if r["video_id"] == walk]
    record_ok = walk_cow == "COW-0001" and len(records) == 1 and abs(
        records[0]["fusion_score"]
        - fusion["fusion_result"]["final_probability"]) < 1e-12
    rc = worker.stop()
    stop = worker.line_after("worker stopped ") or {
        "launches": {}, "timers": {}, "peak_gb": None}
    launches, timers = stop["launches"], stop["timers"]
    checks = {
        f"the worker joined the broker ({bridge})": bridge.endswith(
            "connected"),
        "analysis.complete and the job's last message seen": done,
        f"the subscriber saw the reference's pipeline.* "
        f"({len(seen_pipeline)}) and analysis.complete once":
        seen_pipeline == ref_pipeline
        and sum(m.get("video_id") == vid
                for m in seen["analysis.complete"]) == 1,
        "every result file written and valid": not invalid,
        "the SHAP and LLM files": all(any(
            (data / "results" / k).glob(f"{vid}_*.json")) for k in APP_FILES),
        "the files equal process_video_file's (1e-4)": same,
        "the job row, read from the pg-server, completed": bool(job)
        and job["status"] == "completed",
        f"the walking video's fusion names its cow ({walk_cow}), its "
        f"lameness record read from the pg-server ({len(records)})":
        record_ok,
        "the reference's K1-K3 at the default engine's counts":
        expect_launches(ref_launches, BASE_LAUNCHES),
        "the worker's K1-K3 at the default engine's counts":
        expect_launches(launches, BASE_LAUNCHES),
        "the worker exited with 0": rc == 0}
    log("compose worker record " + json.dumps({
        "ready_s": ready_s, "publish_to_analysis_complete_s": to_analysis,
        "publish_to_last_message_s": to_end,
        "stage_s": {k: timers[k]["last_s"] if timers[k]["count"] == 1
                    else timers[k]["mean_s"] * timers[k]["count"]
                    for k in UPLOAD_TIMERS if k in timers},
        "messages_seen": {s: len(m) for s, m in sorted(seen.items()) if m},
        "cow_named_by_reid": cow, "files_bit_for_bit": equal,
        "walking_video": {"cow": walk_cow, "records": len(records),
                          "publish_to_analysis_complete_s": walk_s},
        "max_abs_diff_vs_driver": worst, "pg_readback_s": read_s,
        "launches": {k: v for k, v in launches.items() if v},
        "worker_peak_gb": stop["peak_gb"], "worker_rc": rc}))
    ok = True
    for what, good in checks.items():
        log(f"  11b {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok, launches, stop["peak_gb"]


def reid_over_wire(eng, tmp, urls) -> bool:
    """11c: an in-process app on the card whose store is the qdrant-server
    (``reid.vector_url``), whose database is the pg-server (``db.url``, as
    ``DATABASE_URL`` sets it) and whose bus is bridged to the broker, over
    phase 7's walking videos of WALK_COWS cows: Re-ID names each video's
    cow as phase 7's in-process store does, the identities land on the
    server, the lameness records read back from the pg-server through the
    port's pg client, and a search over the wire equals the
    card store's holding the same points."""
    from lameness_tpu_torch.core.config import Config, DataDirs, DbConfig
    from lameness_tpu_torch.io.db import open_database
    from lameness_tpu_torch.io.bus import NatsBridge
    from lameness_tpu_torch.io.nats_wire import NatsClient
    from lameness_tpu_torch.io.qdrant_wire import QdrantRestStore
    from lameness_tpu_torch.io.vecstore import VectorStore, _Collection
    from lameness_tpu_torch.serve.app import LamenessApp
    from lameness_tpu_torch.track.reid import COLLECTION_NAME
    root = f"{tmp}/reid"
    vids = write_cow_videos(root, cows=WALK_COWS, per_cow=VIDEOS_PER_COW,
                            tracking=False)
    base = Config()
    cfg = Config(dirs=DataDirs(root=root), db=DbConfig(url=urls["pg"]),
                 reid=dataclasses.replace(base.reid,
                                          vector_url=urls["qdrant"]))
    app = LamenessApp(config=cfg, engine=eng, reactive=True)
    remote = isinstance(app.store, QdrantRestStore)
    subjects = [v for v in vars(cfg.subjects).values() if isinstance(v, str)]
    bridge = NatsBridge(app.bus, urls["nats"], subjects=subjects)
    nc = NatsClient(urls["nats"], name="chip-smoke").connect(timeout_s=30)
    complete = []
    try:
        nc.subscribe("analysis.complete", complete.append)
        nc.flush(30)
        joined = bridge.start()
        t0 = time.perf_counter()
        for vid in vids:
            app.bus.publish_sync(cfg.subjects.pipeline_yolo,
                                 {"video_id": vid})
            app.bus.publish_sync(cfg.subjects.pipeline_dinov3,
                                 {"video_id": vid})
        wall = time.perf_counter() - t0
        bridge.flush(30)
        nc.flush(30)
    finally:
        bridge.stop()
        nc.close()
        app.close()
    errors = app.bus.errors

    def reid(vid):
        path = app.dirs.results_for("tracking") / f"{vid}_tracking.json"
        return [r["cow_id"] for r in json.loads(path.read_text())[
            "reid_results"]] if path.exists() else []
    named = sum(reid(v)[:1] == [f"COW-{int(v[3:5]) + 1:04d}"] for v in vids)
    # the lameness records, read back from the pg-server: one for each
    # video whose fusion file names a cow.  FusionService reads the video ->
    # cow map of the tracking files once, at its first use (both packages),
    # so in one app only the first video's fusion names its cow
    db = open_database(urls["pg"])
    recorded = {r["video_id"]: (f"COW-{c + 1:04d}", r["fusion_score"])
                for c in range(WALK_COWS)
                for r in db.lameness_history(f"COW-{c + 1:04d}")}
    fused = {}
    for v in vids:
        f = json.loads((app.dirs.results_for("fusion")
                        / f"{v}_fusion.json").read_text())
        if f.get("cow_id"):
            fused[v] = (f["cow_id"], f["fusion_result"]["final_probability"])
    records_ok = bool(fused) and sorted(recorded) == sorted(fused) and all(
        recorded[v][0] == fused[v][0]
        and abs(recorded[v][1] - fused[v][1]) < 1e-12 for v in fused)
    client = QdrantRestStore(urls["qdrant"], timeout_s=30)
    n_remote = client.count(COLLECTION_NAME)
    # the same points in a card store: a search over the wire against it
    pts = client.export_collection(COLLECTION_NAME)
    local = VectorStore(device="cuda")
    local._collections[COLLECTION_NAME] = _Collection(
        dim=pts["vectors"].shape[1], ids=pts["ids"], vectors=pts["vectors"],
        payloads=pts["payloads"])
    rng = np.random.default_rng(SEED + 11)
    queries = list(pts["vectors"]) + list(rng.standard_normal(
        (8, pts["vectors"].shape[1])))
    same_ids, worst = True, 0.0
    for q in queries:
        got = client.search(COLLECTION_NAME, q, top_k=len(pts["ids"]))
        want = local.search(COLLECTION_NAME, q, top_k=len(pts["ids"]),
                            use_device=True)
        same_ids &= [h.id for h in got] == [h.id for h in want]
        worst = max(worst, max(abs(a.score - b.score)
                               for a, b in zip(got, want)))
    checks = {
        "make_store gave a QdrantRestStore": remote,
        "the bridge joined the broker": joined,
        f"Re-ID named each video's cow ({named}/{len(vids)})":
        named == len(vids),
        f"the identities on the server ({n_remote}, counted over the wire)":
        n_remote == WALK_COWS,
        f"analysis.complete of every video on the socket "
        f"({len(complete)})": len(complete) == len(vids),
        f"the lameness records read back from the pg-server, one for each "
        f"fusion file naming a cow ({len(recorded)}/{len(fused)})":
        records_ok,
        f"a search over the wire = the card store's (ids; scores within "
        f"{SCORE_TOL:g}: {worst:.3g})": same_ids and worst <= SCORE_TOL,
        "no handler failed": not errors}
    log("compose reid record " + json.dumps({
        "clips": len(vids), "wall_s": wall, "clips_s": len(vids) / wall,
        "named": named, "fusion_named_a_cow": len(fused),
        "records_on_pg_server": len(recorded),
        "identities_on_server": n_remote,
        "max_score_diff": worst, "bus_errors": errors[:3]}))
    ok = True
    for what, good in checks.items():
        log(f"  11c {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def median_ms(fn, reps: int = WIRE_REPS) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def wire_costs(urls) -> dict:
    """11d (measured, not gated): NATS publish to delivery at 1 KB and 64
    KB; a Qdrant search over the wire beside the in-process card store's,
    at the Re-ID collection's size (the qdrant-server) and at WIRE_VECTORS
    of 768 (a QdrantRestServer in this process over a card store filled
    in bulk; its first search copies the collection to the card); a pg
    query's round trip.  Host clocks, medians of WIRE_REPS."""
    import threading
    import torch
    from lameness_tpu_torch.io import pg_wire
    from lameness_tpu_torch.io.nats_wire import NatsClient
    from lameness_tpu_torch.io.qdrant_wire import (QdrantRestServer,
                                                   QdrantRestStore)
    from lameness_tpu_torch.io.vecstore import (VectorStore, _Collection,
                                                _normalize)
    from lameness_tpu_torch.track.reid import COLLECTION_NAME
    out = {}
    a = NatsClient(urls["nats"], name="probe-a").connect(timeout_s=30)
    b = NatsClient(urls["nats"], name="probe-b").connect(timeout_s=30)
    try:
        got = threading.Event()
        b.subscribe("cost.probe", lambda m: got.set())
        b.flush(30)
        for size in (1024, 65536):
            msg = {"p": "x" * (size - 9)}         # size bytes of JSON

            def one():
                got.clear()
                a.publish("cost.probe", msg)
                if not got.wait(10):
                    raise RuntimeError("a NATS probe was not delivered")
            out[f"nats_publish_to_delivery_ms_{size // 1024}kb"] = \
                median_ms(one)
    finally:
        a.close()
        b.close()
    rng = np.random.default_rng(SEED + 12)
    client = QdrantRestStore(urls["qdrant"], timeout_s=30)
    pts = client.export_collection(COLLECTION_NAME)
    local = VectorStore(device="cuda")
    local._collections[COLLECTION_NAME] = _Collection(
        dim=768, ids=pts["ids"], vectors=pts["vectors"])
    q = rng.standard_normal(768)
    out["qdrant_search_ms_reid"] = {
        "points": len(pts["ids"]),
        "wire": median_ms(lambda: client.search(COLLECTION_NAME, q, 5)),
        "in_process_card": median_ms(lambda: local.search(
            COLLECTION_NAME, q, 5, use_device=True))}
    big = VectorStore(device="cuda")
    vecs = _normalize(rng.standard_normal((WIRE_VECTORS, 768),
                                          dtype=np.float32))
    big._collections["big"] = _Collection(
        dim=768, ids=[f"p{i}" for i in range(WIRE_VECTORS)], vectors=vecs)
    srv = QdrantRestServer(store=big)
    srv.start()
    try:
        wire = QdrantRestStore(f"http://127.0.0.1:{srv.port}", timeout_s=60)
        t0 = time.perf_counter()
        first = wire.search("big", q, 5)
        first_ms = (time.perf_counter() - t0) * 1e3
        n_pad = 1 << (WIRE_VECTORS - 1).bit_length()   # as _device_topk
        out["qdrant_search_ms_100k"] = {
            "points": WIRE_VECTORS, "first_wire_search_ms": first_ms,
            "copied_to_card_mb_per_search": n_pad * 768 * 4 / 1e6,
            "wire": median_ms(lambda: wire.search("big", q, 5)),
            "in_process_card": median_ms(lambda: big.search(
                "big", q, 5, use_device=True)),
            "in_process_host": median_ms(lambda: big.search("big", q, 5)),
            "wire_equals_card": [h.id for h in first] == [
                h.id for h in big.search("big", q, 5, use_device=True)]}
    finally:
        srv.stop()
        del big, vecs
        torch.cuda.empty_cache()
    conn = pg_wire.connect(urls["pg"], timeout=30)
    try:
        out["pg_round_trip_ms"] = median_ms(
            lambda: conn.execute("SELECT COUNT(*) AS n FROM lameness_records")
            .fetchall())
    finally:
        conn.close()
    return out


def trace_batch(eng, clip, tmp) -> bool:
    """11e: ``device_trace`` around one default-engine batch (the walking
    clip): the trace file names K1, K2 and K3 (TRACE_KERNELS); its kernel
    events of each beside the wrappers' launch counts.  A session that
    recorded no kernel is asked again (as ``kernel_names`` does), up to
    three."""
    from lameness_tpu_torch.utils.timing import device_trace
    frames = clip[None]
    eng.process_clip_batch(frames)                       # warm
    for _ in range(3):
        reset_counts()
        with device_trace(f"{tmp}/trace") as path:
            eng.process_clip_batch(frames)
        launches = read_counts()
        events = json.loads(path.read_text())["traceEvents"]
        kernels = collections.Counter(e.get("name", "") for e in events
                                      if e.get("cat") == "kernel")
        found = {kid: sum(n for name, n in kernels.items() if pat in name)
                 for kid, pat in TRACE_KERNELS.items()}
        if sum(kernels.values()):
            break
    counted = {kid: launches[name] for kid, name, *_ in KERNEL_TABLE
               if kid in TRACE_KERNELS}
    ok = all(found.values())
    log("compose trace record " + json.dumps({
        "trace_mb": path.stat().st_size / 1e6,
        "kernel_events": sum(kernels.values()), "by_kernel": found,
        "launches": counted, "events_equal_launches": found == counted}))
    log(f"  11e the trace names K1, K2 and K3 ({found})  "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def compose_phase(tmp) -> tuple:
    """Phase 11: 11a-11e.  Returns (ok, the worker's launch counts: the
    compose topology's main path, one engine call)."""
    from pathlib import Path
    import torch
    from lameness_tpu_torch.pipeline.checkpoint import (restore_engine,
                                                        save_params)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = default_engine()
    rng = np.random.default_rng(SEED + 6)
    clip, cow = walking_clip(rng, eng.spec)       # phase 6's calibration
    calibrate_yolo(eng, clip, cow)
    # the worker restores YOLO from its models directory, as a deployment
    # restores a trained checkpoint, and with YOLO's weights loaded curates
    # with it (BatchedYoloDetector); the engine here restores the same file
    models = Path(tmp) / "data" / "models"
    save_params(models, "yolo", eng.yolo)
    ok = restore_engine(eng, models) == {**dict.fromkeys(
        ("yolo", "dino", "sam", "tcn", "gait"), False), "yolo": True}
    src, _ = upload_clip(f"{tmp}/upload", UPLOAD_FRAMES, UPLOAD_COW)
    log(f"  11 YOLO restored from {models}  {'ok' if ok else 'FAIL'}")
    services, launches = {}, {}
    t = [time.perf_counter()]
    try:
        services, urls = start_servers(tmp)
        log("  11a " + ", ".join(f"{n} at {u.replace(PG_PASSWORD, '***')}"
                                 for n, u in urls.items()))
        t.append(time.perf_counter())
        good, launches["compose, worker over NATS"], worker_gb = \
            worker_job(eng, tmp, src, services, urls)
        ok &= good
        src.unlink()
        t.append(time.perf_counter())
        ok &= reid_over_wire(eng, tmp, urls)
        t.append(time.perf_counter())
        costs = wire_costs(urls)
        t.append(time.perf_counter())
        ok &= trace_batch(eng, clip, tmp)
        t.append(time.perf_counter())
    finally:
        rcs = {name: svc.stop() for name, svc in services.items()}
    qdrant = services["qdrant"].line_after("qdrant-server stopped ") or {}
    costs["peak_gb"] = {
        "worker": worker_gb, "qdrant_server": qdrant.get("peak_gb"),
        "chip_smoke": torch.cuda.max_memory_allocated() / 1e9,
        "nats_server": "no CUDA context", "pg_server": "no CUDA context"}
    log("compose costs record " + json.dumps(costs))
    servers_ok = all(rcs[n] == 0 for n in ("nats", "qdrant", "pg"))
    log(f"  11a the servers exited with 0 ({rcs})  "
        f"{'ok' if servers_ok else 'FAIL'}")
    ok &= servers_ok
    log(f"phase 11: {time.perf_counter() - t0:.1f} s (engine, calibration "
        f"and upload {t[0] - t0:.1f}, 11a {t[1] - t[0]:.1f}, 11b "
        f"{t[2] - t[1]:.1f}, 11c {t[3] - t[2]:.1f}, 11d {t[4] - t[3]:.1f}, "
        f"11e {t[5] - t[4]:.1f})")
    return ok, launches

# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------
# the mesh on the one card: every mesh repeats cuda:0 (NCCL takes no two
# ranks on one GPU; the port's single-controller mesh splits the batch, the
# heads, the layers and the sequence there, and runs K1-K3 in each shard).
# 12a: the default engine over dp 2 at B = MESH_BATCH, RGB and yuv420
# transfer, at dropout 0 and at MC dropout, bit for bit the unsharded engine
# on each shard's clips alone fed their rows of the whole batch's draws
# (JAX's MC-dropout rule; the libraries round a clip's floats differently
# at another batch size, so the unsharded engine at the whole batch is a
# printed difference), each shard's draws its rows of the unsharded draw
# bit for bit; B = 3 the same way on the batch padded with a zero clip;
# pair and monolith over dp 2 the same way and bit for bit the sharded
# staged run; dp 2 x tp 2
# against the replicated layout on an f32 engine, DINO embeddings within
# JAX's atol (shard_inference's docstring), and the bf16 default's
# difference reported.  12b: the train step at DINOv2 ViT-B/14 width, one
# device, then dp 2 x tp 2 with FSDP against it (f32, TF32 off: the losses
# within MESH_LOSS_RTOL, the gradients summing in another order).  12c:
# sam_encoder_pipeline, sam_ring_attention and mc_dropout_sharded.  12d:
# the command line's --dp.
MESH_BATCH = 4
MESH_TP_ATOL = 1e-4
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS = 8, 3
MESH_LOSS_RTOL = 1e-4
MESH_RING_BATCH = 2        # (MESH_RING_BATCH·12, 4096, 64) over a 4-ring


def mesh_of(dp, tp=1):
    import torch
    from lameness_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(dp * tp, model_parallel=tp,
                     devices=[torch.device("cuda", 0)] * (dp * tp))


def mesh_engine(frames) -> tuple:
    """12a.  Returns (ok, {path: launches})."""
    import torch
    from lameness_tpu_torch.core.config import ComputeConfig, Config
    from lameness_tpu_torch.parallel.same_batch import (batch_difference,
                                                        differing_leaves,
                                                        same_batch)
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    eng = default_engine()
    eng.warmup(batch=2)
    ok, launches = True, {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    refs = {}

    def reference(clips, transfer):
        """``same_batch``'s references for ``clips`` with the heads at
        dropout 0 and at MC dropout, and the generator's state after the
        whole-batch call: computed once a (batch, transfer)."""
        key = (len(clips), transfer)
        if key not in refs:
            with heads_dropout0(eng):
                ref0 = same_batch(eng, clips, gen(), 2, transfer=transfer)
            g_one = gen()
            ref = same_batch(eng, clips, g_one, 2, transfer=transfer)
            refs[key] = ref0, ref, g_one.get_state()
        return refs[key]

    def same_batch_run(name, m, clips, transfer="rgb", mode="staged"):
        """``m`` (dp 2) against the unsharded engine on each shard's clips
        alone, fed their rows of the whole padded batch's draws
        (``parallel/same_batch.py``): every output bit for bit, with the
        heads at dropout 0 (staged; the modes share staged's run) and at
        MC dropout (``mode``), and the generator left where the
        whole-batch call leaves it.  The batch-size difference to the
        unsharded engine at the whole batch is printed, not gated."""
        (whole0, alone0, _), (whole, alone, draws), g_state = \
            reference(clips, transfer)
        differ0 = []
        if mode == "staged":
            with heads_dropout0(eng):
                got0 = m.process_clip_batch(clips, gen(), transfer=transfer)
            differ0 = differing_leaves(got0, alone0)
        g_shard = gen()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = m.process_clip_batch(clips, g_shard, transfer=transfer,
                                   mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        differ = differing_leaves(got, alone)
        good = not differ0 and not differ and bool(draws) \
            and torch.equal(g_shard.get_state(), g_state) \
            and all(v.shape[0] == len(clips) for _, v in leaves(got))
        log(f"  12a {name}: each shard's clips alone (fed their rows of the "
            f"whole batch's {len(draws)} draws), leaves not bit for bit: at "
            f"dropout 0 {differ0 if mode == 'staged' else 'as staged'}, at "
            f"MC dropout ({mode}) {differ}; the "
            f"generator left where the unsharded call leaves it; the "
            f"batch-size difference to the unsharded engine at the whole "
            f"batch ({len(clips) + len(clips) % 2} clips, not gated): at "
            f"dropout 0 {json.dumps(batch_difference(alone0, whole0))}, at "
            f"MC dropout {json.dumps(batch_difference(alone, whole))}; "
            f"{wall:.3f} s  {'ok' if good else 'FAIL'}")
        return good, counts, got

    for transfer in ("rgb", "yuv420"):
        m = eng.with_spec(eng.spec)
        m.shard_inference(mesh_of(2))
        good, counts, got = same_batch_run(
            f"dp 2, B={MESH_BATCH}, {transfer}", m, frames, transfer)
        good &= expect_launches(counts, {k: 2 * v for k, v in
                                         BASE_LAUNCHES.items()})
        ok &= good
        if transfer == "rgb":
            launches["mesh"] = counts
            rgb_out = got
        log(f"  12a dp 2, B={MESH_BATCH}, {transfer}: K1-K3 "
            f"{[counts[n] for n in ('attention', 'sam_window_attention_v3', 'sam_global_attention_v4')]}"
            f" (2 shards x 12/10/4)  {'ok' if good else 'FAIL'}")
    good = draws_are_rows(eng, m, frames)
    ok &= good
    log(f"  12a dp 2, B={MESH_BATCH}: each shard's MC-dropout draws, site by "
        f"site, its clips' rows of each sample's block of the unsharded "
        f"engine's draw, bit for bit  {'ok' if good else 'FAIL'}")
    good, _, got3 = same_batch_run("B=3 over dp 2 (one zero clip, trimmed)",
                                   m, frames[:3])
    ok &= good
    a, b = dict(leaves(got3)), dict(leaves(rgb_out))
    agree = float((a["masks"][:3] == b["masks"][:3]).mean())
    log(f"  12a B=3: mask agreement with the B=4 run's first 3 clips "
        f"{agree:.5f} (not gated)")
    for mode in ("pair", "monolith"):
        m.warmup(batch=MESH_BATCH, mode=mode)
        good, counts, got = same_batch_run(
            f"{mode} over dp 2, B={MESH_BATCH}", m, frames, mode=mode)
        good &= expect_launches(counts, {k: 2 * v for k, v in
                                         BASE_LAUNCHES.items()})
        staged = same_leaves(got, rgb_out)
        good &= staged
        ok &= good
        launches[f"mesh {mode}"] = counts
        log(f"  12a {mode} over dp 2: every output bit for bit the sharded "
            f"staged run's {staged}; K1-K3 "
            f"{[counts[n] for n in ('attention', 'sam_window_attention_v3', 'sam_global_attention_v4')]}"
            f" (2 shards x 12/10/4, counted from the captures)  "
            f"{'ok' if good else 'FAIL'}")
        m.drop_graphs()
    del m
    gc.collect()
    torch.cuda.empty_cache()
    # dp x tp: f32 engine, the DINO embeddings against the replicated layout
    for name, cfg in (("f32", Config(compute=ComputeConfig(dtype="float32"))),
                      ("bf16", None)):
        e = LamenessEngine(cfg or Config(), EngineSpec(),
                           generator=torch.Generator().manual_seed(SEED)) \
            if cfg is not None else eng
        rep = e.with_spec(e.spec)
        rep.shard_inference(mesh_of(2))
        tp = e.with_spec(e.spec)
        tp.shard_inference(mesh_of(2, 2))
        want = rep.process_clip_batch(frames, generator=gen())
        reset_counts()
        got = tp.process_clip_batch(frames, generator=gen())
        counts = read_counts()
        diff = float(np.abs(got["embeddings"] - want["embeddings"]).max())
        rel = float(np.linalg.norm(got["embeddings"] - want["embeddings"])
                    / np.linalg.norm(want["embeddings"]))
        good = expect_launches(counts, {"K1": 48, "K2": 20, "K3": 8})
        if name == "f32":
            good &= diff <= MESH_TP_ATOL
            launches["mesh dp x tp"] = counts
        ok &= good
        log(f"  12a dp 2 x tp 2 ({name}), DINO 6 of 12 heads a model shard: "
            f"embeddings max |tp - replicated| {diff:.3e}, relative L2 "
            f"{rel:.3e}" + (f" (gate <= {MESH_TP_ATOL:g})" if name == "f32"
                            else " (not gated)")
            + f"; K1 {counts['attention']} (2 x 2 x 12)  "
            f"{'ok' if good else 'FAIL'}")
        del rep, tp
        if cfg is not None:
            del e
        gc.collect()
        torch.cuda.empty_cache()
    return ok, launches


def mesh_train(smi) -> bool:
    """12b: the train step at ViT-B width, one device, then dp 2 x tp 2 with
    FSDP from the same weights and batches."""
    import torch
    from lameness_tpu_torch.parallel.fsdp import (shard_train_state_fsdp,
                                                  state_shardings)
    from lameness_tpu_torch.parallel.mesh import DATA_AXIS, leaves as leaves_of
    from lameness_tpu_torch.pipeline import train as T

    def tp_spec(path, leaf):
        return T._dino_param_spec(path[1:], leaf) if path[0] == "dino" \
            else None

    def block_shape(leaf, mesh):
        """The shape of one position's block of ``leaf`` by its spec."""
        shape = list(leaf.shape)
        for dim, entry in enumerate(leaf.spec):
            for axis in (entry,) if isinstance(entry, str) else entry or ():
                shape[dim] //= mesh.shape[axis]
        return tuple(shape)

    def run(mesh, fsdp):
        models = T.make_models(hidden=768, layers=12, heads=12)
        state, tx = T.init_train_state(torch.Generator().manual_seed(SEED),
                                       mesh, models, image_size=224)
        pinned = None
        if fsdp:
            state = shard_train_state_fsdp(state, mesh, tp_spec=tp_spec)
            pinned = state_shardings(state)
        step, _ = T.make_train_step(mesh, models, tx, state_shardings=pinned)
        rng = np.random.default_rng(SEED + 12)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, kept = [], [], True
        for _ in range(MESH_TRAIN_STEPS):
            batch = T.make_batch(rng, MESH_TRAIN_BATCH, image_size=224)
            t0 = time.perf_counter()
            state, loss, _ = step(state, batch, g)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
            for leaf in leaves_of(state.params):
                adam = state.opt_state.adamw.state
                for pos in mesh.positions():
                    t = leaf.shards[pos]
                    kept &= (t.device == mesh.devices[pos]
                             and t.shape == block_shape(leaf, mesh)
                             and adam[t]["exp_avg"].device == t.device
                             and adam[t]["exp_avg"].shape == t.shape)
                    if DATA_AXIS in leaf.spec and pos[0] > 0:
                        # a data-split block is its own tensor, not its
                        # neighbour's (every position is the one card)
                        other = leaf.shards[(0,) + pos[1:]]
                        kept &= (t is not other
                                 and t.data_ptr() != other.data_ptr())
        peak = torch.cuda.max_memory_allocated() / 1e9
        sharded = sum(DATA_AXIS in leaf.spec for leaf in leaves_of(
            state.params))
        n = len(leaves_of(state.params))
        del state, models
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ms, peak, kept, sharded, n

    one = run(mesh_of(1), False)
    fs = run(mesh_of(2, 2), True)
    finite = all(math.isfinite(x) for x in one[0] + fs[0])
    rel = max(abs(a - b) / abs(b) for a, b in zip(fs[0], one[0]))
    ok = finite and rel <= MESH_LOSS_RTOL and fs[3] and fs[4] > 0
    log(f"  12b train step, ViT-B/14 width (768, 12 layers, 12 heads), 224, "
        f"batch {MESH_TRAIN_BATCH}, f32: one device losses "
        f"{[round(x, 6) for x in one[0]]}, ms a step "
        f"{[round(x, 1) for x in one[1]]}, peak {one[2]:.2f} GB; dp 2 x tp 2 "
        f"FSDP ({fs[4]} of {fs[5]} leaves split over data) losses "
        f"{[round(x, 6) for x in fs[0]]}, ms a step "
        f"{[round(x, 1) for x in fs[1]]}, peak {fs[2]:.2f} GB; largest "
        f"relative loss difference {rel:.3e} (gate <= {MESH_LOSS_RTOL:g}); "
        f"after each step every shard of its block's shape, each data-split "
        f"block its own tensor, the moments with their shard (every "
        f"position is cuda:0, so the device part holds trivially) "
        f"{fs[3]}  {'ok' if ok else 'FAIL'}")
    log("mesh train record " + json.dumps({
        "card": smi, "batch": MESH_TRAIN_BATCH,
        "one_device": {"loss": one[0], "ms": one[1], "peak_gb": one[2]},
        "dp2_tp2_fsdp": {"loss": fs[0], "ms": fs[1], "peak_gb": fs[2],
                         "leaves_split_over_data": fs[4], "leaves": fs[5]}}))
    return ok


def mesh_axes() -> bool:
    """12c: the pipeline, ring and ensemble axes."""
    import torch
    from lameness_tpu_torch.models.tcn import TCN
    from lameness_tpu_torch.ops.sam_attention import (project_rel_tables,
                                                      sam_attention_reference)
    from lameness_tpu_torch.parallel.ensemble_parallel import (
        make_ensemble_mesh, mc_dropout_sharded)
    from lameness_tpu_torch.parallel.pipeline_parallel import (
        STAGE_AXIS, sequential_reference, stack_stage_params)
    from lameness_tpu_torch.parallel.ring_attention import SEQ_AXIS
    from lameness_tpu_torch.parallel.mesh import Mesh
    from lameness_tpu_torch.parallel.sam_parallel import (
        encoder_stages, sam_encoder_pipeline, sam_ring_attention)
    cuda0 = torch.device("cuda", 0)
    ok = True
    eng = default_engine()
    enc = eng.sam.vision_encoder
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    images = torch.randn((4, 1024, 1024, 3), generator=g, device="cuda"
                         ).to(eng.spec.dtype)
    stages = Mesh([cuda0] * 4, (STAGE_AXIS,))
    with torch.no_grad():
        sam_encoder_pipeline(enc, None, images[:2], stages, 2)   # warm
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sam_encoder_pipeline(enc, None, images, stages, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stage_fn, per_stage = encoder_stages(enc, 4)
        stacked = stack_stage_params(per_stage)

        def stage(s, tree=stacked):
            return {k: stage(s, v) if isinstance(v, dict) else v[s]
                    for k, v in tree.items()}
        ref = torch.cat([enc.neck(sequential_reference(
            stage_fn, [stage(s) for s in range(4)], enc.embed(mb)))
            for mb in images.chunk(2)])
        plain = enc(images)
    good = torch.equal(got, ref) and expect_launches(
        counts, {"K2": 16, "K3": 8})
    ok &= good
    log(f"  12c sam_encoder_pipeline, ViT-B at 1024², 4 stages x [w, w, g], "
        f"2 microbatches of 2: bit for bit sequential_reference on each "
        f"microbatch; K2 {counts['sam_window_attention_v3']}, K3 "
        f"{counts['sam_global_attention_v4']} (8 and 4 layers x 2); "
        f"{wall * 1e3:.1f} ms; against the encoder on the whole batch max "
        f"|diff| {float((got.float() - plain.float()).abs().max()):.3e}  "
        f"{'ok' if good else 'FAIL'}")
    del eng, enc, images, got, ref, plain, stacked
    gc.collect()
    torch.cuda.empty_cache()
    # ring attention over the SAM global grid, float32
    bh, gsz, d = MESH_RING_BATCH * 12, 64, 64
    q, k, v = (torch.randn((bh, gsz * gsz, d), generator=g, device="cuda")
               for _ in range(3))
    rel_h, rel_w = (torch.randn((2 * gsz - 1, d), generator=g,
                                device="cuda") * 0.2 for _ in range(2))
    rh, rw = project_rel_tables(q, rel_h, rel_w, gsz)
    ring = Mesh([cuda0] * 4, (SEQ_AXIS,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sam_ring_attention(q, k, v, rh, rw, ring)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = sam_attention_reference(q, k, v, rh, rw)
    atol, rtol = TOL["float32"]
    err = (got - want).abs()
    good = bool((err <= atol + rtol * want.abs()).all())
    ok &= good
    log(f"  12c sam_ring_attention over a 4-ring at {tuple(q.shape)}, f32: "
        f"max |ring - K3's plain version| {float(err.max()):.3e} (gate "
        f"{atol:g} + {rtol:g}·|plain|); {wall * 1e3:.1f} ms  "
        f"{'ok' if good else 'FAIL'}")
    del q, k, v, rh, rw, got, want, err
    torch.cuda.empty_cache()
    # MC-dropout samples over an ensemble axis
    tcn = TCN(input_dim=44)
    feats = torch.randn((2, 125, 44), generator=g, device="cuda")

    def one(gen):
        with torch.no_grad():
            return tcn(feats.to(gen.device), generator=gen)
    sharded = mc_dropout_sharded(one, make_ensemble_mesh(4, [cuda0] * 4),
                                 torch.Generator().manual_seed(SEED), 8)
    alone = mc_dropout_sharded(one, make_ensemble_mesh(1, [cuda0]),
                               torch.Generator().manual_seed(SEED), 8)
    full = sharded.full()
    good = torch.equal(full, alone.full()) and float(full.std(0).max()) > 0
    ok &= good
    log(f"  12c mc_dropout_sharded: TCN's 8 samples over 4 positions bit "
        f"for bit the stack on one (std over samples max "
        f"{float(full.std(0).max()):.3e})  {'ok' if good else 'FAIL'}")
    return ok


def mesh_cli(tmp) -> bool:
    """12d: ``--dp auto process`` as a dp-1 mesh; ``--dp 2`` refused."""
    u = SMALL_UPLOAD
    src, _ = upload_clip(f"{tmp}/up", u["n"], u["cow"], h=u["h"], w=u["w"],
                         fps=u["fps"])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    runs = {}
    for name, dp in (("auto", "auto"), ("2", "2")):
        runs[name] = subprocess.run(
            [sys.executable, "-m", "lameness_tpu_torch", "--dp", dp, "--data",
             f"{tmp}/data{name}", "process", str(src), "--small"],
            capture_output=True, text=True, timeout=300, env=env)
    a, b = runs["auto"], runs["2"]
    good_a = a.returncode == 0 and ("mesh: inference sharded over 1 devices "
                                    "(data=1, model=1)") in a.stdout
    good_b = b.returncode != 0 and "needs 2 devices, only 1 visible" in \
        (b.stdout + b.stderr)
    if not good_a:
        log(a.stdout[-2000:], a.stderr[-2000:])
    log(f"  12d python -m lameness_tpu_torch --dp auto process (tiny "
        f"engine): exit {a.returncode}, a (data=1, model=1) mesh; --dp 2: "
        f"exit {b.returncode}, '{(b.stdout + b.stderr).strip().splitlines()[-1] if (b.stdout + b.stderr).strip() else ''}'"
        f"  {'ok' if good_a and good_b else 'FAIL'}")
    return good_a and good_b


def mesh_phase(counts_path) -> bool:
    """Phase 12 (in a process of its own: ``chip_smoke.py --mesh``)."""
    import torch
    from lameness_tpu_torch.ops import _cuda
    _cuda.build(["attention", "sam_window_attention", "sam_global_attention"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"  card: {smi}")
    t = [time.perf_counter()]
    from lameness_tpu_torch.pipeline.engine import EngineSpec
    s = EngineSpec()
    rng = np.random.default_rng(SEED + 12)
    frames = rng.integers(0, 256, (MESH_BATCH, s.clip_frames, s.frame_height,
                                   s.frame_width, 3), dtype=np.uint8)
    with switches({}):
        ok, launches = mesh_engine(frames)
    del frames
    gc.collect()
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    ok &= mesh_train(smi)
    t.append(time.perf_counter())
    with switches({}):
        ok &= mesh_axes()
    t.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as tmp:
        ok &= mesh_cli(tmp)
    t.append(time.perf_counter())
    with open(counts_path, "w") as f:
        json.dump(launches, f)
    log(f"phase 12: {t[-1] - t[0]:.1f} s (12a {t[1] - t[0]:.1f}, 12b "
        f"{t[2] - t[1]:.1f}, 12c {t[3] - t[2]:.1f}, 12d {t[4] - t[3]:.1f}); "
        f"card {smi}")
    return ok


def mesh_in_fresh_process() -> tuple:
    """Phase 12 in a process of its own (its engines, train states and
    ring operands go with the process); returns (ok, its launch counts)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/launches.json"
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--mesh", path], timeout=600)
        launches = {}
        if os.path.exists(path):
            with open(path) as f:
                launches = json.load(f)
    return res.returncode == 0, launches


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------
# the engine's modes on phase 3's engine (its weights, warm, and its two
# seeded 720p clips, B = 2, bf16): pair is two captured CUDA graphs, monolith
# one.  (a) pair and monolith bit for bit staged, RGB and yuv420 transfer;
# (b) K1 12, K2 10, K3 4 a call in each mode, by the wrappers' counts (a
# replay adds the launches recorded in the capture) and by the device
# functions one profiled call ran (DEVICE_FUNCTIONS); (c) two calls in a row with one generator equal
# two staged calls, the generator advanced alike; (d) after install_state_
# dict with other seeded DINO weights, a call (captured anew) equals
# run_staged with them; (e) a readback=False tree held across the next call
# unchanged.  Then the per-call times of the three modes (not gated), in the
# order staged pair monolith monolith pair staged: wall and CUDA-event ms,
# device busy of one profiled call, and each graph's capture seconds.
MODE_TURNS = ("staged", "pair", "monolith", "monolith", "pair", "staged")


@contextlib.contextmanager
def heads_dropout0(eng):
    """``eng``'s sequence heads at dropout 0 (every ``rate`` attribute of
    the TCN and the GaitTransformer, shared by its with_spec engines and
    replicas on its device), restored afterwards."""
    mods = [m for head in (eng.tcn, eng.gait) for m in head.modules()
            if hasattr(m, "rate")]
    saved = [m.rate for m in mods]
    try:
        for m in mods:
            m.rate = 0.0
        yield
    finally:
        for m, rate in zip(mods, saved):
            m.rate = rate


def draws_are_rows(eng, m, frames) -> bool:
    """Each data shard of ``m`` (``eng`` over dp 2) consumes, site by site,
    its clips' rows of every MC sample's block of the draw the unsharded
    engine makes at the same batch, bit for bit."""
    import torch
    from lameness_tpu_torch.parallel.same_batch import (RecordedDraws,
                                                        shard_draws_are_rows)
    from lameness_tpu_torch.pipeline.train import RowDraws
    whole = RecordedDraws(torch.Generator(device="cuda").manual_seed(SEED))
    eng.process_clip_batch(frames, whole)
    shard_draws = []
    rand = RowDraws.rand

    def spy(self, shape, device):
        u = rand(self, shape, device)
        shard_draws.append((self.lo, self.hi, u))
        return u
    RowDraws.rand = spy
    try:
        m.process_clip_batch(frames, torch.Generator(device="cuda"
                                                     ).manual_seed(SEED))
    finally:
        RowDraws.rand = rand
    return shard_draws_are_rows(whole.draws, shard_draws, len(frames), 2)


def engine_modes(eng, frames, smi) -> tuple:
    """Phase 13 on phase 3's engine.  Returns (ok, {path: launches})."""
    import torch
    from lameness_tpu_torch.pipeline.engine import _flat_items
    from lameness_tpu_torch.weights import seeded_state_dict

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)
    ok, launches, capture = True, {}, {}
    for mode in ("pair", "monolith"):
        t0 = time.perf_counter()
        eng.warmup(batch=len(frames), mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        [cap] = [c for c in eng._graphs.values() if c.mode == mode]
        capture[mode] = {"warmup_s": round(wall, 3), "graphs": cap.seconds,
                         "recorded": cap.launches}
        log(f"  13 warmup(mode={mode!r}): {wall:.2f} s, {len(cap.graphs)} "
            f"graph(s), eager run + capture s {json.dumps(cap.seconds)}, "
            f"launches recorded in the capture {json.dumps(cap.launches)}; "
            f"card {smi}")
    # (a)
    for transfer in ("rgb", "yuv420"):
        want = eng.process_clip_batch(frames, gen(), transfer=transfer)
        for mode in ("pair", "monolith"):
            got = eng.process_clip_batch(frames, gen(), mode=mode,
                                         transfer=transfer)
            good = same_leaves(got, want) and check_outputs(
                got, eng.spec, len(frames))
            ok &= good
            log(f"  13a {mode}, {transfer}: every output bit for bit "
                f"staged's  {'ok' if good else 'FAIL'}")
    # (b)
    for mode in ("staged", "pair", "monolith"):
        reset_counts()
        eng.process_clip_batch(frames, gen(), mode=mode)
        counts = read_counts()
        ran = device_launches(lambda: eng.process_clip_batch(
            frames, gen(), mode=mode))
        good = expect_launches(counts, BASE_LAUNCHES) \
            and ran == BASE_LAUNCHES
        ok &= good
        launches[f"mode {mode}"] = counts
        log(f"  13b {mode}: K1 {counts['attention']}, K2 "
            f"{counts['sam_window_attention_v3']}, K3 "
            f"{counts['sam_global_attention_v4']} in one call (12/10/4"
            f"{'' if mode == 'staged' else ', counted from the capture'}); "
            f"the card ran K1-K3 {json.dumps(ran)} in one profiled call, "
            f"counted by device-function name  {'ok' if good else 'FAIL'}")
    # (c)
    g_ref = gen()
    ref = [eng.process_clip_batch(frames, g_ref) for _ in range(2)]
    for mode in ("pair", "monolith"):
        g = gen()
        got = [eng.process_clip_batch(frames, g, mode=mode) for _ in range(2)]
        good = all(same_leaves(a, b) for a, b in zip(got, ref)) \
            and torch.equal(g.get_state(), g_ref.get_state()) \
            and not np.array_equal(got[0]["tcn_probability"],
                                   got[1]["tcn_probability"])
        ok &= good
        log(f"  13c {mode}: two calls with one generator bit for bit two "
            f"staged calls (the second's MC dropout another draw), the "
            f"generator advanced alike  {'ok' if good else 'FAIL'}")
    # (d)
    orig = {k: v.detach().clone() for k, v in eng.dino.state_dict().items()}
    dev = eng.to_device(frames)
    before = eng.process_clip_batch(dev, gen(), mode="monolith")
    eng.install_state_dict("dino", seeded_state_dict(
        eng.dino, torch.Generator().manual_seed(SEED + 13)))
    dropped = not eng._graphs
    want = eng.process_clip_batch(dev, gen())
    moved = not np.array_equal(want["embeddings"], before["embeddings"])
    for mode in ("pair", "monolith"):
        got = eng.process_clip_batch(dev, gen(), mode=mode)
        good = dropped and moved and same_leaves(got, want)
        ok &= good
        log(f"  13d {mode} after install_state_dict('dino', other seeded "
            f"weights): graphs dropped {dropped}, embeddings moved {moved}, "
            f"every output bit for bit run_staged's with the new weights  "
            f"{'ok' if good else 'FAIL'}")
    eng.install_state_dict("dino", orig)
    # (e)
    other = eng.to_device(frames[::-1].copy())
    for mode in ("pair", "monolith"):
        held = eng.process_clip_batch(dev, gen(), mode=mode, readback=False)
        snap = {k: v.clone() for k, v in _flat_items(held)}
        eng.process_clip_batch(other, gen(), mode=mode, readback=False)
        torch.cuda.synchronize()
        good = all(torch.equal(v, snap[k]) for k, v in _flat_items(held))
        ok &= good
        log(f"  13e {mode}: a readback=False tree held across the next call "
            f"unchanged  {'ok' if good else 'FAIL'}")
    del held, snap, other, dev
    # times, not gated
    times = {mode: {"wall_ms": [], "event_ms": []} for mode in MODE_TURNS}
    for mode in MODE_TURNS:
        for _ in range(REPEATS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng.process_clip_batch(frames, gen(), mode=mode)
            end.record()
            torch.cuda.synchronize()
            times[mode]["wall_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
            times[mode]["event_ms"].append(round(start.elapsed_time(end), 3))
    for mode in ("staged", "pair", "monolith"):
        wall, share = busy_share(lambda: eng.process_clip_batch(
            frames, gen(), mode=mode))
        times[mode]["profiled_wall_ms"] = round(wall, 3)
        times[mode]["device_busy_ms"] = None if share is None \
            else round(wall * share, 3)
        log(f"  13 {mode}: wall ms {times[mode]['wall_ms']}, CUDA-event ms "
            f"{times[mode]['event_ms']} (turns {MODE_TURNS}); profiled "
            f"call {wall:.1f} ms, device busy "
            + ("not measured" if share is None else
               f"{wall * share:.1f} ms ({100 * share:.1f}%)")
            + f"; card {smi}")
    log("modes record " + json.dumps({"card": smi, "batch": len(frames),
                                      "order": MODE_TURNS, "times": times,
                                      "capture": capture}))
    eng.drop_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------
# the tools (no kernel of their own; the engines they drive run K1-K3).
# (a) the image codec: seeded frames at 1280x720 and 640x480 encoded by the
# port at 4:4:4, 4:2:0 and gray on the card and on the CPU (the same
# quantised blocks, the same bytes), decoded on both (the same pixels: the
# arithmetic is integer); ms an image of each half alone (the device half
# by CUDA events and the host clock, the host's Huffman coding by the host
# clock); a PNG round trip through the card bit for bit.  (b) the tools of
# lameness_tpu_torch/tools/, each a subprocess with --device cuda, gated on
# its exit code and its files: a seeded 32-image COCO-keypoints set written
# by imwrite; prepare_pose_dataset coco --flip-augment, then
# analyze_training_orientation; train_pose_model (2 epochs) and
# compare_pose_models on its checkpoint beside the heuristic;
# train_detector --synthetic and --data on the set (1 epoch); the seeded
# default engine's YOLO, SAM and DINO written as ultralytics,
# segment-anything and HF files and converted by convert_weights, then
# installed by restore_engine into an engine of other seeds, whose outputs
# must equal the seeded engine's bit for bit; profile_stages --runs 2 with a
# trace; run_pipeline_example on a .y4m upload.
CODEC_SIZES = ((720, 1280), (480, 640))
CODEC_MODES = ("4:4:4", "4:2:0", "gray")
CODEC_REPS = 5
TOOL_IMAGES = 32                # the COCO-keypoints set of 14b
TOOL_IMAGE_SIZE = (480, 640)
TOOL_TIMEOUT = 300


def codec_frame(rng, h, w):
    """A seeded picture: smooth colour waves, edges and noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


def host_ms(fn, reps: int = CODEC_REPS) -> float:
    """Host-clock ms per call of ``fn`` (ending in a synchronise)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def codec_phase(smi) -> bool:
    """14a.  Returns ok."""
    import torch
    from lameness_tpu_torch.video import image as im
    ok = True
    rng = np.random.default_rng(SEED + 14)
    records = []
    for h, w in CODEC_SIZES:
        rgb = codec_frame(rng, h, w)
        for mode in CODEC_MODES:
            src = rgb[..., 0] if mode == "gray" else rgb
            sub = "4:2:0" if mode == "gray" else mode
            card = im.jpeg_forward(src, 95, sub, device="cuda")
            cpu = im.jpeg_forward(src, 95, sub, device="cpu")
            same_blocks = all(np.array_equal(a.coefs, b.coefs)
                              for a, b in zip(card.components,
                                              cpu.components))
            data = im.jpeg_bytes(card)
            same_bytes = data == im.jpeg_bytes(cpu)
            jf = im.parse_jpeg(data, "frame.jpg")
            px = im.jpeg_pixels(jf, "cuda")
            same_px = torch.equal(px.cpu(), im.jpeg_pixels(jf, "cpu"))
            rec = {
                "size": f"{w}x{h}", "mode": mode, "bytes": len(data),
                "encode_device_ms": round(cuda_ms(
                    lambda: im.jpeg_forward(src, 95, sub, device="cuda"),
                    CODEC_REPS), 3),
                "encode_device_host_ms": round(host_ms(
                    lambda: im.jpeg_forward(src, 95, sub, device="cuda")), 3),
                "encode_entropy_host_ms": round(host_ms(
                    lambda: im.jpeg_bytes(card)), 3),
                "decode_entropy_host_ms": round(host_ms(
                    lambda: im.parse_jpeg(data, "frame.jpg")), 3),
                "decode_device_ms": round(cuda_ms(
                    lambda: im.jpeg_pixels(jf, "cuda"), CODEC_REPS), 3),
                "decode_device_host_ms": round(host_ms(
                    lambda: im.jpeg_pixels(jf, "cuda")), 3)}
            good = same_blocks and same_bytes and same_px \
                and tuple(px.shape) == (h, w, 3)
            ok &= good
            records.append(rec)
            log(f"  14a {w}x{h} {mode}: card blocks = CPU's {same_blocks}, "
                f"bytes {same_bytes}, pixels {same_px}; "
                + json.dumps({k: v for k, v in rec.items()
                              if k not in ("size", "mode")})
                + f"  {'ok' if good else 'FAIL'}")
    with tempfile.TemporaryDirectory() as tmp:
        frame = torch.from_numpy(codec_frame(rng, 480, 640)).cuda()
        im.imwrite(f"{tmp}/f.png", frame)
        back = im.imread(f"{tmp}/f.png", "cuda")
        good = torch.equal(back, frame)
    ok &= good
    log(f"  14a PNG 640x480 through the card and back bit for bit {good}  "
        f"{'ok' if good else 'FAIL'}")
    log("codec record " + json.dumps({"card": smi, "reps": CODEC_REPS,
                                      "images": records}))
    return ok


def start_tool(name, *args, argv=None):
    """Start ``python -m lameness_tpu_torch.tools.<name> args --device
    cuda`` (or ``python argv``); returns its handle for ``finish_tool``.  A
    thread reads its output and notes when it exits (killed after
    TOOL_TIMEOUT s), so its seconds are its own however late it is waited
    for."""
    import threading
    here = os.path.dirname(os.path.abspath(__file__))
    if argv is None:
        argv = ["-m", f"lameness_tpu_torch.tools.{name}", *map(str, args),
                "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    done = {}

    def wait():
        try:
            done["out"] = proc.communicate(timeout=TOOL_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            done["out"] = proc.communicate()
            done["killed"] = True
        done["s"] = time.perf_counter() - t0
    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return proc, name, args, waiter, done


def finish_tool(handle):
    """Wait for a started tool; returns (exit code, stdout)."""
    proc, name, args, waiter, done = handle
    waiter.join()
    out, err = done["out"]
    if done.get("killed"):
        log(f"  14b {name}: killed after {TOOL_TIMEOUT} s")
    tail = out.strip().splitlines()[-1:] or [""]
    log(f"  14b {name} {' '.join(map(str, args[:2]))}: exit "
        f"{proc.returncode} in {done['s']:.1f} s; {tail[0][:160]}")
    if proc.returncode != 0:
        log(err[-3000:])
    return proc.returncode, out


def tool(name, *args):
    return finish_tool(start_tool(name, *args))


def coco_keypoint_set(root, n: int = TOOL_IMAGES):
    """A seeded COCO-keypoints set (AP-10K names) of n JPEGs written by the
    port's imwrite on the card: a textured cow block on a seeded picture,
    17 keypoints in the block, three of four facing right."""
    from pathlib import Path
    from lameness_tpu_torch.tools.prepare_pose_dataset import AP10K_NAMES
    from lameness_tpu_torch.video.image import imwrite
    root = Path(root)
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(SEED + 141)
    h, w = TOOL_IMAGE_SIZE
    images, anns = [], []
    for i in range(1, n + 1):
        im = codec_frame(rng, h, w)
        bw, bh = rng.integers(160, 320), rng.integers(100, 200)
        x, y = rng.integers(0, w - bw), rng.integers(0, h - bh)
        im[y:y + bh, x:x + bw] = rng.integers(170, 256, (bh, bw, 3))
        imwrite(root / "images" / f"c{i:03d}.jpg", im, device="cuda")
        images.append({"id": i, "file_name": f"c{i:03d}.jpg", "width": w,
                       "height": h})
        k = np.zeros((17, 3), np.float32)
        k[:, 0] = rng.uniform(x, x + bw, 17)
        k[:, 1] = rng.uniform(y, y + bh, 17)
        k[:, 2] = 2
        right = i % 4 != 0
        k[2, 0] = x + (bw - 2 if right else 2)           # nose
        k[4, 0] = x + (2 if right else bw - 2)           # tail root
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "bbox": [float(x), float(y), float(bw), float(bh)],
                     "keypoints": [float(v) for v in k.ravel()],
                     "num_keypoints": 17})
    json.dump({"images": images, "annotations": anns,
               "categories": [{"id": 1, "name": "cow",
                               "keypoints": AP10K_NAMES}]},
              open(root / "ann.json", "w"))
    return root / "ann.json", root / "images"


def hf_layout(convert, name, state_dict):
    """``state_dict`` (the port's, of sub-model ``name``) under the key
    names ``convert`` (an HF converter of the port) reads.  The converters
    only rename and transpose (the way back through the flax tree leaves
    every tensor as it was), so each key's source is found by converting a
    state dict of numbered one-element arrays, its keys taken from the
    converter's KeyErrors."""
    from lameness_tpu_torch.weights import from_jax_params
    keys = []
    while True:
        probe = {k: np.full((1, 1, 1, 1), i, np.float64)
                 for i, k in enumerate(keys)}
        try:
            tree = convert(probe)
            break
        except KeyError as exc:
            keys.append(exc.args[0])
    numbered = from_jax_params({name: tree})[name]
    source = {k: keys[int(v.reshape(-1)[0])] for k, v in numbered.items()}
    return {source[k]: v for k, v in state_dict.items()}


def reference_files(root) -> tuple:
    """The seeded default engine's YOLO, SAM and DINO (fp32, before the
    bf16 policy) written in the reference's layouts: an ultralytics ``.pt``,
    a segment-anything ``.pth`` and an HF directory.  Returns ({kind:
    path}, the seeded state dicts, whether the segment-anything file reads
    back as the HF names)."""
    import functools
    from pathlib import Path
    import torch
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.models import dino as dino_mod
    from lameness_tpu_torch.models import sam as sam_mod
    from lameness_tpu_torch.models.yolo import export_ultralytics_state_dict
    from lameness_tpu_torch.pipeline.engine import EngineSpec
    from lameness_tpu_torch.weights import (conv_tree_from_state_dict,
                                            init_params)
    root = Path(root)
    seeded = init_params(EngineSpec(), Config(),
                         torch.Generator().manual_seed(SEED))
    files = {"yolo": root / "yolov8n.pt",
             "sam": root / "sam_vit_b_01ec64.pth",
             "dino": root / "dinov2-base"}
    files["dino"].mkdir(parents=True)
    torch.save({k: torch.as_tensor(v) for k, v in export_ultralytics_state_dict(
        conv_tree_from_state_dict(seeded["yolo"])).items()}, files["yolo"])
    hf_sam = hf_layout(functools.partial(sam_mod.convert_hf_state_dict,
                                         depth=12), "sam", seeded["sam"])
    sa = sam_mod.hf_to_sa_state_dict(hf_sam)
    torch.save(sa, files["sam"])
    torch.save(hf_layout(dino_mod.convert_hf_state_dict, "dino",
                         seeded["dino"]),
               files["dino"] / "pytorch_model.bin")
    sa_ok = set(sam_mod.sa_to_hf_state_dict(sa)) == set(hf_sam) \
        and sam_mod.detect_sam_layout(sa) == "sa"
    log(f"  14b reference files: ultralytics ({len(seeded['yolo'])} "
        f"tensors), segment-anything ({len(sa)} keys, renamed back to the HF "
        f"names {sa_ok}), HF DINOv2 ({len(seeded['dino'])} keys)")
    return files, seeded, sa_ok


def converted_engine(models, seeded) -> tuple:
    """An engine of other seeds with the converted checkpoints (and the
    seeded TCN and GaitTransformer through save_params) installed by
    restore_engine, against the seeded default engine: every output bit for
    bit.  Returns (ok, launches)."""
    import torch
    from lameness_tpu_torch.core.config import Config
    from lameness_tpu_torch.pipeline.checkpoint import (restore_engine,
                                                        save_params)
    from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
    for name in ("tcn", "gait"):
        save_params(models, name, seeded[name])
    ref = LamenessEngine(Config(), EngineSpec(),
                         generator=torch.Generator().manual_seed(SEED))
    eng = LamenessEngine(Config(), EngineSpec(),
                         generator=torch.Generator().manual_seed(SEED + 14))
    loaded = restore_engine(eng, models)
    ok = loaded == {n: True for n in ("yolo", "dino", "sam", "tcn", "gait")}
    s = ref.spec
    frames = np.random.default_rng(SEED + 142).integers(
        0, 256, (1, s.clip_frames, s.frame_height, s.frame_width, 3),
        dtype=np.uint8)
    _, want, _ = counted_run(ref, frames)
    launches, got, _ = counted_run(eng, frames)
    same = same_leaves(got, want)
    ok &= same and expect_launches(launches, BASE_LAUNCHES)
    log(f"  14b restore_engine {json.dumps(loaded)}; every output of the "
        f"converted engine bit for bit the seeded engine's {same}  "
        f"{'ok' if ok else 'FAIL'}")
    del ref, eng
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches


def tools_phase(tmp, smi) -> tuple:
    """14b.  The tools that depend on nothing else start at once and run
    beside the pose chain (prepare, then analyze, train_pose_model and
    train_detector --data together, then compare).  Beside them a process
    that only imports a tool and touches the card reads what a tool's
    start costs.  Returns (ok, launches of the converted engine's run)."""
    from pathlib import Path
    tmp = Path(tmp)
    ann, images = coco_keypoint_set(tmp / "src")
    files, seeded, ok = reference_files(tmp / "ref")
    src, _ = upload_clip(tmp / "upload", UPLOAD_FRAMES, UPLOAD_COW)
    models, ds, pose_models = tmp / "models", tmp / "ds", tmp / "models_pose"
    side = {kind: start_tool("convert_weights", kind, path, "--out", models)
            for kind, path in files.items()}
    side["synthetic"] = start_tool("train_detector", "--synthetic",
                                   "--epochs", 1, "--out",
                                   tmp / "detector_synthetic")
    side["profile"] = start_tool("profile_stages", "--runs", 2, "--trace",
                                 tmp / "trace")
    side["example"] = start_tool("run_pipeline_example", src, "--data",
                                 tmp / "data")
    side["start"] = start_tool("process start", argv=[
        "-c", "import torch, lameness_tpu_torch.tools.train_detector; "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"])
    rc, _ = tool("prepare_pose_dataset", "coco", ann, images, "--out", ds,
                 "--flip-augment")
    doc = json.load(open(ds / "annotations.json")) if rc == 0 else {}
    ok &= rc == 0 and len(doc.get("images", [])) == 2 * TOOL_IMAGES \
        and len(list((ds / "images").glob("flip_*.jpg"))) == TOOL_IMAGES
    chain = {"analyze": start_tool("analyze_training_orientation", ds),
             "pose": start_tool("train_pose_model", ds, "--epochs", 2,
                                "--img-size", 320, "--models-dir",
                                pose_models),
             "data": start_tool("train_detector", "--data", ds, "--epochs",
                                1, "--out", tmp / "detector_data")}
    rc, out = finish_tool(chain["pose"])
    ok &= rc == 0 and "completed: final loss" in out \
        and (pose_models / "pose" / "params.torch").exists()
    rc, out = tool("compare_pose_models", ds, "--model", pose_models,
                   "--img-size", 320)
    ok &= rc == 0 and "heuristic" in out and str(pose_models) in out
    rc, out = finish_tool(chain["analyze"])
    ok &= rc == 0 and f"over {2 * TOOL_IMAGES} annotations" in out
    for name, handle in (("data", chain["data"]),
                         ("synthetic", side["synthetic"])):
        rc, out = finish_tool(handle)
        last = out.strip().splitlines()[-1:] or ["{}"]
        ok &= rc == 0 and "best_mAP50_95" in json.loads(last[0]) \
            and (tmp / f"detector_{name}" / "detector_best"
                 / "params.torch").exists()
    for kind in files:
        rc, _ = finish_tool(side[kind])
        ok &= rc == 0 and (models / kind / "params.torch").exists()
    rc, out = finish_tool(side["profile"])
    ok &= rc == 0 and "run_staged" in out \
        and len(list((tmp / "trace").glob("trace_*.json"))) == 1
    log("\n".join("    " + ln for ln in out.splitlines()[-7:]))
    rc, _ = finish_tool(side["start"])
    ok &= rc == 0
    rc, out = finish_tool(side["example"])
    ok &= rc == 0 and "final probability:" in out and "MISSING" not in out
    log("\n".join("    " + ln for ln in out.splitlines()[:16]))
    good, launches = converted_engine(models, seeded)
    ok &= good
    log(f"  14b tools on {smi}  {'ok' if ok else 'FAIL'}")
    return ok, launches


def tools_and_codec(smi) -> tuple:
    """Phase 14.  Returns (ok, {path: launches})."""
    t0 = time.perf_counter()
    ok = codec_phase(smi)
    with tempfile.TemporaryDirectory() as tmp:
        good, launches = tools_phase(tmp, smi)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s; card {smi}")
    return ok and good, {"tools": launches}


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------
# mp4 (no kernel of its own): the first MP4_FRAMES of phase 8's 720p upload
# encoded as intra-only mp4v by write_video on the card and on the CPU (the
# same bytes: the transforms are integer), that file and the committed
# fixture tests/torch_fixtures/mp4v_gop12.mp4 (cv2's mp4v writer, I+P,
# GOP 12) decoded on both (the same planes), the fixture's luma equal to
# cv2's hashes beside it, and the card's reconstruction the encoder's own.
# Then ms a frame of each half at 1280x720 and 640x480 (the device half by
# CUDA events, the host bitstream half by the host clock, one thread), on
# MP4_TIMED of phase 8's frames and on 8 of phase 14's codec frames, and
# bytes a frame against a .y4m frame's.
MP4_FRAMES = 50
MP4_TIMED = 10                  # of them timed, each half alone
MP4_REPS = 2
MP4_FIXTURE = "tests/torch_fixtures/mp4v_gop12.mp4"


def mp4_timing(frames, label: str) -> dict:
    """ms a frame of the mp4 codec's halves on ``frames`` ((n, h, w, 3) on
    the card), and its bytes a frame."""
    import torch
    from lameness_tpu_torch.video import mpeg4
    from lameness_tpu_torch.video.yuv import rgb_to_i420
    n, h, w = frames.shape[:3]
    i420 = rgb_to_i420(frames)
    enc = mpeg4.encode_forward(i420)
    coefs, acpred = enc.coefs.cpu().numpy(), enc.acpred.cpu().numpy()
    samples = [mpeg4.encode_ivop(w, h, 25, 0, 0, c, a)
               for c, a in zip(coefs, acpred)]
    layer = mpeg4.read_config(mpeg4.write_config(w, h, 25))
    vops = [mpeg4.decode_vop(layer, x) for x in samples]
    dec = mpeg4.Mpeg4Decoder(layer, "cuda", batch=n)
    return {
        "frames": label, "size": f"{w}x{h}", "n": n,
        "bytes_a_frame": sum(map(len, samples)) / n,
        "y4m_bytes_a_frame": h * w * 3 // 2,
        "encode_device_ms": cuda_ms(lambda: mpeg4.encode_forward(i420),
                                    MP4_REPS) / n,
        "encode_host_ms": host_ms(lambda: [
            mpeg4.encode_ivop(w, h, 25, 0, 0, c, a)
            for c, a in zip(coefs, acpred)], MP4_REPS) / n,
        "decode_host_ms": host_ms(lambda: [
            mpeg4.decode_vop(layer, x) for x in samples], MP4_REPS) / n,
        "decode_device_ms": cuda_ms(lambda: dec.reconstruct(vops),
                                    MP4_REPS) / n}


def mp4_phase(smi) -> bool:
    """Phase 15.  Returns ok."""
    import torch
    from lameness_tpu_torch.video import mpeg4
    from lameness_tpu_torch.video.decode import VideoReader, write_video
    from lameness_tpu_torch.video.yuv import rgb_to_i420
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    frames, _ = upload_frames(MP4_FRAMES, UPLOAD_COW)
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        card = write_video(f"{tmp}/card.mp4", frames, UPLOAD_FPS)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = write_video(f"{tmp}/cpu.mp4", frames.cpu(), UPLOAD_FPS)
        cpu_s = time.perf_counter() - t
        checks["the card's bytes equal the CPU's"] = \
            card.read_bytes() == cpu.read_bytes()
        fixture = os.path.join(here, MP4_FIXTURE)
        planes = {}
        for name, path in (("written", card), ("fixture", fixture)):
            for dev in ("cuda", "cpu"):
                with VideoReader(path, device=dev) as vr:
                    planes[name, dev] = np.concatenate(
                        [c for _, c in vr.i420_chunks(16)])
            checks[f"the {name} file's planes: card = CPU"] = np.array_equal(
                planes[name, "cuda"], planes[name, "cpu"])
        recon = mpeg4.encode_forward(rgb_to_i420(frames)).recon
        recon = recon.cpu().numpy()
        checks["the written file decodes to the encoder's reconstruction"] \
            = np.array_equal(planes["written", "cuda"], recon)
        meta = json.loads(open(os.path.splitext(fixture)[0] + ".json").read())
        hashes = [hashlib.sha256(np.ascontiguousarray(f[:meta["height"]])
                                 .tobytes()).hexdigest()
                  for f in planes["fixture", "cuda"]]
        checks["the fixture's luma = cv2's hashes"] = \
            hashes == meta["luma_sha256"]
        size = card.stat().st_size
    records = [mp4_timing(frames[:MP4_TIMED], "phase 8 upload")]
    rng = np.random.default_rng(SEED + 15)
    for h, w in CODEC_SIZES:
        wave = torch.from_numpy(np.stack([codec_frame(rng, h, w)
                                          for _ in range(8)])).cuda()
        records.append(mp4_timing(wave, "codec waves"))
    log("mp4 record " + json.dumps({
        "card": smi, "qp": mpeg4.QP, "reps": MP4_REPS,
        "write_card_s": card_s, "write_cpu_s": cpu_s,
        "file_bytes_a_frame": size / MP4_FRAMES, "timing": records}))
    ok = True
    for what, good in checks.items():
        log(f"  15 {what}  {'ok' if good else 'FAIL'}")
        ok &= good
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s; card {smi}")
    return ok


def header(title: str, t_start: float) -> None:
    """A phase's header line, with the seconds since the script started."""
    log(f"== {title} [{time.perf_counter() - t_start:.1f} s in]")


def main() -> int:
    t_start = time.perf_counter()
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
    if sys.argv[1:2] == ["--mesh"]:          # mesh_in_fresh_process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return 0 if mesh_phase(sys.argv[2] if len(sys.argv) > 2
                               else os.devnull) else 1
    smi, hgmma = setup()
    ok_build = all(hgmma[name] > 0 for name in HOPPER_SOURCES)
    if not ok_build:
        log("a library of K1 or K3-K6 holds no HGMMA: its wgmma route was "
            "not built " + json.dumps({n: hgmma[n] for n in HOPPER_SOURCES}))
    header("phase 2: kernels against their plain versions", t_start)
    records, ok_k = check_kernels()
    header("phase 3: engine", t_start)
    ok_small = True
    for sel, env, _ in SELECTIONS:
        with switches(env):
            log(f"small engine, {sel}:")
            ok_small &= check_small_engine()
    launches, ok_e, (eng, frames, *ref) = run_engine()
    header("phase 4: serving modes", t_start)
    ok_m = run_modes(eng, frames, *ref)
    for name, _, small_kw, env, _ in MODES:
        with switches(env):
            log(f"small engine, {name}:")
            ok_m &= check_small_engine(small_kw)
    header("phase 13: the engine's modes (phase 3's engine)", t_start)
    with switches({}):
        ok_13, mode_launches = engine_modes(eng, frames, smi)
    launches.update(mode_launches)
    header("phase 5: checkpoints", t_start)
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
    header("phase 6: serving", t_start)
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
    header("phase 7: analysis", t_start)
    with work:
        gc.collect()            # phase 6's engine, held by reference cycles
        torch.cuda.empty_cache()
        ok_a = analysis(work.name, f"{work.name}/stream", cow, stream)
    header("phase 8: upload", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, switches({}):
        ok_u, upload_launches = upload_phase(tmp)
    launches.update(upload_launches)
    header("phase 9: training", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ok_t = training_in_fresh_process()
    header("phase 10: platform", t_start)
    with tempfile.TemporaryDirectory() as tmp, switches({}):
        ok_p, platform_launches = platform_phase(tmp)
    launches.update(platform_launches)
    header("phase 11: the compose topology", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, switches({}):
        ok_w, compose_launches = compose_phase(tmp)
    launches.update(compose_launches)
    header("phase 12: the mesh", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ok_x, mesh_launches = mesh_in_fresh_process()
    launches.update(mesh_launches)
    header("phase 14: the tools and the image codec", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    with switches({}):
        ok_14, tool_launches = tools_and_codec(smi)
    launches.update(tool_launches)
    header("phase 15: mp4", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ok_15 = mp4_phase(smi)
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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    if not (ok_build and ok_k and ok_small and ok_e and ok_m and ok_c
            and ok_s and ok_a and ok_u and ok_t and ok_p and ok_w
            and ok_x and ok_13 and ok_14 and ok_15):
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
