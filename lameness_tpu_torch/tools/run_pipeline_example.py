"""End-to-end demo driver: upload a video, watch every result land (port
of ``scripts/run_pipeline_example.py``).  Builds the full engine on
``--device`` (or the small test engine with ``--small``), restores the
checkpoints under the data root's models directory, submits the clip
through the reactive app and prints each pipeline's headline numbers.
Uploads are mp4v ``.mp4`` or ``.y4m`` (other codecs through an ``ffmpeg``
binary):

  python -m lameness_tpu_torch.tools.run_pipeline_example VIDEO.mp4 [--small] [--data DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import add_device_arg, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_pipeline_example")
    ap.add_argument("video", help="path to a video file")
    ap.add_argument("--small", action="store_true",
                    help="small test-geometry engine")
    ap.add_argument("--data", default="data", help="data root directory")
    ap.add_argument("--video-id", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    import torch
    from ..core.config import Config
    from ..pipeline.checkpoint import restore_engine
    from ..pipeline.engine import LamenessEngine, make_test_engine
    from ..serve.app import LamenessApp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = Config.load(data_root=args.data)
    if args.small:
        engine = make_test_engine(device=device)
    else:
        engine = LamenessEngine(device=device)
        loaded = restore_engine(engine, config.dirs.models)
        print(f"checkpoints restored: {loaded}")

    app = LamenessApp(config=config, engine=engine, reactive=True)
    try:
        t0 = time.time()
        vid = app.submit_video(Path(args.video), args.video_id)
        result = app.wait_for_analysis(vid, timeout_s=600)
        elapsed = time.time() - t0

        print(f"\nvideo_id: {vid}   ({elapsed:.1f}s end-to-end)")
        if result is None:
            print("analysis did not complete — check bus errors:")
            for e in app.bus.errors:
                print(" ", e)
            return 1

        d = config.dirs
        print(f"cow_id: {result.get('cow_id')}")
        fr = result["fusion_result"]
        print(f"final probability: {fr['final_probability']:.3f} "
              f"({fr['decision_mode']}, confidence {fr['confidence']:.2f})")
        print(f"recommendation: {fr['recommendation']}")
        print("\nper-pipeline results:")
        for kind in ("yolo", "sam3", "dinov3", "tleap", "tcn", "transformer",
                     "gnn", "graph_transformer", "ml", "tracking"):
            f = d.results_for(kind) / f"{vid}_{kind}.json"
            status = "ok" if f.exists() else "MISSING"
            extra = ""
            if f.exists():
                data = json.load(open(f))
                for key in ("severity_score", "graph_prediction",
                            "neighbor_evidence", "total_tracks"):
                    if key in data:
                        extra = f"{key}={data[key]:.3f}" \
                            if isinstance(data[key], float) else \
                            f"{key}={data[key]}"
                        break
            print(f"  {kind:18s} {status:8s} {extra}")
        exp = d.results / "explanations" / f"{vid}_explanation.json"
        if exp.exists():
            print("\nexplanation:\n")
            print(json.load(open(exp))["explanation"])
    finally:
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
