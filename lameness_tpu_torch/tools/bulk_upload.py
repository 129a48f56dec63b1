"""Bulk dataset loader: a labeled train split and unlabeled test videos
(port of ``scripts/bulk_upload.py``).  Walks ``<root>/{lame,sound,test}/``,
submits every video through the app (the engine on ``--device``), records
the labels, and with ``--train-after`` trains the tabular ensemble, the
sequence heads and the graph heads.  Uploads are ``.y4m``; ``.mp4``,
``.avi`` and ``.mov`` go through an ``ffmpeg`` binary:

  python -m lameness_tpu_torch.tools.bulk_upload DATASET [--small] [--data DIR] [--train-after]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from . import add_device_arg, device_of

VIDEO_SUFFIXES = (".y4m", ".mp4", ".avi", ".mov")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bulk_upload")
    ap.add_argument("dataset", help="dir with lame/ sound/ test/ subdirs")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--data", default="data")
    ap.add_argument("--train-after", action="store_true",
                    help="train GBDT ensemble + DL heads after upload")
    ap.add_argument("--limit", type=int, default=None,
                    help="max videos per split")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    import torch
    from ..core.config import Config
    from ..pipeline.engine import LamenessEngine, make_test_engine
    from ..serve.app import LamenessApp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = make_test_engine(device=device) if args.small \
        else LamenessEngine(device=device)
    config = Config.load(data_root=args.data)
    app = LamenessApp(config=config, engine=engine, reactive=True)
    root = Path(args.dataset)
    try:
        counts = {}
        t0 = time.time()
        for split, label in (("lame", 1), ("sound", 0), ("test", None)):
            d = root / split
            if not d.exists():
                continue
            videos = sorted(p for p in d.iterdir()
                            if p.suffix.lower() in VIDEO_SUFFIXES)
            if args.limit:
                videos = videos[:args.limit]
            counts[split] = len(videos)
            for i, v in enumerate(videos):
                vid = app.submit_video(v)
                if label is not None:
                    app.training.add_label(vid, label)
                print(f"[{split} {i + 1}/{len(videos)}] {v.name} -> {vid}",
                      flush=True)
        elapsed = time.time() - t0
        total = sum(counts.values())
        print(f"\nuploaded {total} videos in {elapsed:.1f}s "
              f"({total / max(elapsed, 1e-9) * 60:.1f} videos/min): "
              f"{counts}")

        if args.train_after:
            print("\ntraining tabular ensemble...")
            status = app.training.run_training()
            print(f"  {status['status']}: "
                  f"{status.get('report', status.get('error'))}")
            print("training sequence heads...")
            from ..pipeline.head_training import train_heads
            report = train_heads(config.dirs, config.dirs.models,
                                 device=device)
            print(f"  {report['status']}: "
                  f"acc={report.get('train_accuracy')}")
            print("training graph heads...")
            from ..pipeline.graph_training import train_graph_heads
            report = train_graph_heads(config.dirs, config.dirs.models,
                                       device=device)
            print(f"  {report['status']}: "
                  f"acc={report.get('train_accuracy')}")
    finally:
        app.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
