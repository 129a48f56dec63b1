"""``python -m lameness_tpu_torch`` (port of ``lameness_tpu/__main__.py``).

  python -m lameness_tpu_torch [--data DIR] [--cpu] process VIDEO [--small]

``process`` runs one video through the whole chain on the card (with
``--cpu``, on the CPU) and prints the fusion result, as the JAX command
prints it.  The JAX command goes through its app (``LamenessApp``), which
is not ported: here it calls ``PipelineDriver.process_video_file``.  The
upload is a ``.y4m`` file, or any container the ``ffmpeg`` binary decodes.
"""
from __future__ import annotations

import argparse
import os
import sys
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


def _build(args):
    """(config, engine) of the command line: the test-geometry engine with
    ``--small``, else the full engine at ``ingest_spec``'s geometry."""
    from .core.config import Config
    from .pipeline.engine import LamenessEngine, make_test_engine
    device = "cpu" if args.cpu else None
    cfg = Config.load(data_root=args.data) if args.data else Config()
    if args.small:
        engine = make_test_engine(device=device)
    else:
        engine = LamenessEngine(config=cfg, spec=ingest_spec(cfg),
                                device=device)
    return cfg, engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lameness_tpu_torch")
    ap.add_argument("--data", help="data root directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("process", help="one video through the pipeline")
    p.add_argument("video", type=Path)
    p.add_argument("--small", action="store_true",
                   help="test-geometry engine")
    args = ap.parse_args(argv)
    if args.cmd == "process":
        from .serve.driver import PipelineDriver
        cfg, engine = _build(args)
        driver = PipelineDriver(config=cfg, engine=engine)
        try:
            fusion = driver.process_video_file(args.video)["fusion"]
        finally:
            driver.bus.shutdown()
        print(fusion and fusion.get("fusion_result"))
        return 0 if fusion else 1
    return 2


if __name__ == "__main__":
    sys.exit(main())
