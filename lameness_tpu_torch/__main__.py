"""``python -m lameness_tpu_torch`` (port of ``lameness_tpu/__main__.py``).

  python -m lameness_tpu_torch serve [--port 8000] [--data DIR] [--async]
                                     [--small] [--no-resume] [--batch N]
  python -m lameness_tpu_torch process VIDEO [--data DIR] [--small]
  python -m lameness_tpu_torch resume [--data DIR] [--small]

``serve`` boots the reactive app (``serve/app.py`` ``LamenessApp``) with the
admin API and its SPA, resumes stranded jobs and warms the engine up in the
background; ``process`` runs one video through the app and prints the
fusion result; ``resume`` replays the jobs a crash left ``processing``.
The engine runs on the card (with ``--cpu``, on the CPU), in bf16 unless
``--f32``.  An upload is a ``.y4m`` file, or any container the ``ffmpeg``
binary decodes.

Not ported yet: the NATS bridge (``--nats-url``), the ``worker``,
``nats-server``, ``qdrant-server`` and ``pg-server`` subcommands (ROADMAP.md
§1 item 2(d)), and the mesh (``--dp``/``--tp``, §1 item 5).  Those
arguments raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time
from pathlib import Path


def ingest_spec(cfg=None):
    """EngineSpec honoring LAMENESS_INGEST:

    - ``WxH`` (e.g. ``1024x576``): process at a reduced ingest resolution.
      The driver decodes, resizes to the engine's geometry and maps results
      back to native coordinates.
    - ``WxH+WlxHl`` (e.g. ``1024x576+640x360``): split-resolution ingest:
      det/SAM frames at the first geometry (the coordinate space),
      dino/pose frames at the second.

    ``pose_pixels`` follows whether a trained pose checkpoint
    (``<models>/pose``) exists: the heuristic keypoint path never reads
    pose pixels, so pose-only frames are left off the wire (the same
    outputs).  ``LAMENESS_POSE_PIXELS=1/0`` overrides; ``LAMENESS_SAM_RECT=1``
    selects the rect SAM canvas."""
    from .pipeline.engine import EngineSpec
    rect = os.environ.get("LAMENESS_SAM_RECT") == "1"
    env_pp = os.environ.get("LAMENESS_POSE_PIXELS")
    if env_pp is not None:
        pose_pixels = env_pp != "0"
    elif cfg is not None:
        pose_pixels = (Path(cfg.dirs.models) / "pose").exists()
    else:
        pose_pixels = True
    ingest = os.environ.get("LAMENESS_INGEST")
    if not ingest:
        return EngineSpec(sam_rect=rect, pose_pixels=pose_pixels)
    parts = ingest.lower().split("+")
    w, h = (int(v) for v in parts[0].split("x"))
    if len(parts) > 1:
        lw, lh = (int(v) for v in parts[1].split("x"))
        return EngineSpec(frame_height=h, frame_width=w,
                          lo_height=lh, lo_width=lw, sam_rect=rect,
                          pose_pixels=pose_pixels)
    return EngineSpec(frame_height=h, frame_width=w, sam_rect=rect,
                      pose_pixels=pose_pixels)


def _refuse_unported(args):
    """The NATS bridge and the mesh are not ported: their arguments raise
    (and ``LAMENESS_DP``/``LAMENESS_TP``, which the JAX command reads in
    their place)."""
    if getattr(args, "nats_url", None):
        raise SystemExit(
            "--nats-url: the NATS bridge is not ported to lameness_tpu_torch "
            "yet (ROADMAP.md §1 item 2(d)); serve runs on its in-process bus")
    dp = args.dp or os.environ.get("LAMENESS_DP")
    tp = args.tp or os.environ.get("LAMENESS_TP")
    if dp or (tp and int(tp) > 1):
        raise SystemExit(
            f"--dp {dp} --tp {tp}: multi-GPU serving is not ported to "
            f"lameness_tpu_torch yet (ROADMAP.md §1 item 5); it runs on one "
            f"card")


def _build(args):
    """(config, engine) of the command line: the test-geometry engine with
    ``--small``, else the full engine at ``ingest_spec``'s geometry, in
    bf16 on the card unless ``--f32``."""
    from .core.config import ComputeConfig, Config
    from .pipeline.engine import LamenessEngine, make_test_engine
    _refuse_unported(args)
    device = "cpu" if args.cpu else None
    cfg = Config.load(data_root=args.data) if args.data else Config()
    if args.f32:
        cfg = dataclasses.replace(cfg, compute=ComputeConfig(dtype="float32"))
    if getattr(args, "small", False):
        engine = make_test_engine(device=device)
    else:
        engine = LamenessEngine(config=cfg, spec=ingest_spec(cfg),
                                device=device)
        if engine.precision:
            print("precision:", engine.precision, flush=True)
    return cfg, engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lameness_tpu_torch")
    ap.add_argument("--data", help="data root directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    ap.add_argument("--f32", action="store_true",
                    help="disable the bf16 engine policy (card default: "
                         "encoders bf16 per config.compute.dtype)")
    ap.add_argument("--dp", default=None,
                    help="data-parallel serving: not ported (raises)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel serving: not ported (raises)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="reactive app + admin API")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--async", dest="async_dispatch", action="store_true",
                   help="worker-pool bus dispatch")
    s.add_argument("--small", action="store_true",
                   help="test-geometry engine")
    s.add_argument("--no-resume", action="store_true")
    s.add_argument("--batch", type=int, default=1,
                   help="group queued clips into engine batches of N")
    s.add_argument("--nats-url", default=None,
                   help="NATS bridge: not ported (raises)")

    p = sub.add_parser("process", help="one video through the pipeline")
    p.add_argument("video", type=Path)
    p.add_argument("--small", action="store_true",
                   help="test-geometry engine")

    rs = sub.add_parser("resume", help="replay stranded processing jobs")
    rs.add_argument("--small", action="store_true",
                    help="test-geometry engine (tiny frames; for tests only "
                         "— production resumes use the full engine)")
    args = ap.parse_args(argv)

    from .serve.app import LamenessApp
    if args.cmd == "serve":
        cfg, engine = _build(args)
        app = LamenessApp(config=cfg, engine=engine, reactive=True,
                          serve_api=True, api_port=args.port,
                          async_dispatch=args.async_dispatch,
                          resume_inflight=not args.no_resume,
                          clip_batch=args.batch)
        print(f"admin UI at http://127.0.0.1:{app.server.port}", flush=True)
        # build the kernels and run each stage once (at the batch size the
        # batcher pads to) off the request path
        threading.Thread(
            target=lambda: print("warmup:", engine.warmup(
                batch=max(1, args.batch)), flush=True),
            daemon=True, name="engine-warmup").start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            app.close()
        return 0
    if args.cmd == "process":
        cfg, engine = _build(args)
        app = LamenessApp(config=cfg, engine=engine, reactive=True)
        try:
            vid = app.submit_video(args.video)
            result = app.wait_for_analysis(vid, timeout_s=600)
        finally:
            app.close()
        print(result and result.get("fusion_result"))
        return 0 if result else 1
    if args.cmd == "resume":
        # stranded jobs replay through the same geometry serve and process
        # use: the tiny engine would overwrite real result files
        cfg, engine = _build(args)
        app = LamenessApp(config=cfg, engine=engine, reactive=True)
        try:
            n = app.resume_inflight_jobs()
        finally:
            app.close()
        print(f"resumed {n} job(s)")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
