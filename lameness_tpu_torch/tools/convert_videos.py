"""Batch re-encode videos to pipeline-friendly mp4 (port of
``scripts/convert_videos.py``): walks a directory and writes every video
in it (``.mp4``, ``.avi``, ``.mov``, ``.mkv``, ``.webm``, ``.mpg``,
``.wmv``) as ``DST_DIR/<stem>.mp4``, decoded by the port's reader (mp4v
itself, other codecs through an ``ffmpeg`` binary) and written by its
mp4v encoder, the transforms on ``--device``.  DST_DIR defaults to
SRC_DIR/converted.  Each file prints an ``ok`` or a ``FAIL`` line, then the
counts, as the JAX script prints them.

Usage: python -m lameness_tpu_torch.tools.convert_videos SRC_DIR [DST_DIR]
       [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import add_device_arg, device_of

EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".mpg", ".wmv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_videos")
    ap.add_argument("src", nargs="?")
    ap.add_argument("dst", nargs="?")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.src is None:
        print(__doc__)
        return 1
    device = device_of(args)
    src = Path(args.src)
    dst = Path(args.dst) if args.dst else src / "converted"
    dst.mkdir(parents=True, exist_ok=True)

    from ..video.decode import VideoReader, write_video
    done = failed = 0
    for f in sorted(src.iterdir()):
        if f.suffix.lower() not in EXTENSIONS or f.is_dir():
            continue
        out = dst / (f.stem + ".mp4")
        try:
            with VideoReader(f, device=device) as vr:
                info = vr.info
                frames = [fr for _, fr in vr.frames()]
            if not frames:
                raise IOError("no frames decoded")
            write_video(out, frames, info["fps"] or 25, device=device)
            done += 1
            print(f"ok   {f.name} -> {out.name} "
                  f"({len(frames)} frames @ {info['fps']:.1f} fps)")
        except Exception as e:
            failed += 1
            print(f"FAIL {f.name}: {e}")
    print(f"\nconverted {done}, failed {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
