#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lameness_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing loudly (no exception is swallowed):
  1. setup: card name and power limit, versions, TF32 off, build the
     kernels from csrc/ with nvcc (one process per source, in parallel);
     per library the registers and spills ptxas reports and the HGMMA
     (wgmma) instructions in its SASS -- those of K1 (its Hopper routine)
     and of K3, K4, K5 and K6 (one Hopper routine) must have them;
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
     default (K2, K3) and under v1/v1 (K7, K4), each against the other,
     its record, K2, K3, K4 and K7 at ViT-H's shapes against their plain
     versions beside their bounds and SDPA, and the tiny engine with a SAM
     at head dim 80, card against CPU.
The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
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
            lines = path.read_text().splitlines()
            regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                    if "registers" in ln]
            spills = [ln.strip() for ln in lines
                      if "spill" in ln and "0 bytes spill stores" not in ln]
            log(f"  ptxas {name}: {len(regs)} kernels, registers "
                f"{min(regs, default=0)}-{max(regs, default=0)}, "
                f"{len(spills)} with spills {spills[:2]}; HGMMA in SASS "
                f"{hgmma[name]}")
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


def foreign_kernels(fn) -> list:
    """Names of the device kernels and copies one call of ``fn`` runs
    besides the port's own (``lameness::``), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "lameness::" not in e.key})


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
)
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
    """K2, K3, K4 and K7 at ViT-H's shapes (16 heads of 80) in bf16: each
    against its plain version on one image's slice (the batch's plain K3
    would hold about 24 GB of f32 scores), its device time (the profiler's,
    and by CUDA events around back-to-back calls) beside its bound and one
    SDPA call; one ``kernel shape record`` line each."""
    import torch
    from lameness_tpu_torch.ops import sam_attention as sa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {kid: (name, entry, layout) for kid, name, entry, layout, *_
               in KERNEL_TABLE}
    ok = True
    for kid in ("K2", "K3", "K4", "K7"):
        name, entry, layout = entries[kid]
        fn = getattr(sa, entry)
        args = kernel_inputs(layout, torch.bfloat16, batch, gen, heads=16,
                             hd=80)
        one = 25 if layout.startswith("window") else 16    # one image
        out = fn(*args)
        ref = plain_version(kid, tuple(a[:one] for a in args))()
        torch.cuda.synchronize()
        err, good = agree(f"{kid} hd 80", "bfloat16", out[:one], ref)
        ok &= good
        reps = 5 if layout.startswith("global") else 20
        ms = device_ms(lambda: fn(*args), reps, only="lameness::")
        call = cuda_ms(lambda: fn(*args), reps)
        library = library_call(layout, args)
        lib = device_ms(library, 3)
        lib_call = cuda_ms(library, 3)
        del library
        flops, nbytes = kernel_work(layout, args)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS_S["bfloat16"] * 1e3
        bound = max(t_bytes, t_ops)
        log("kernel shape record " + json.dumps({
            "id": kid, "name": name, "shapes": [tuple(a.shape) for a in args],
            "ms": ms, "call_ms": call, "launches": launches.get(name, 0),
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
    weights, by default and under WIN=v1 GLB=v1, and its kernels at hd 80."""
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
    return ok & hd80_kernels(counts, batch)


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
    if not (ok_build and ok_k and ok_small and ok_e and ok_m and ok_c):
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
