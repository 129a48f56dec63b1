"""Write ``lameness_tpu_torch/serve/font_simplex.npz``: OpenCV's
``FONT_HERSHEY_SIMPLEX`` glyphs at scale 0.5, thickness 1, ``LINE_AA``, as
the port's text rasteriser (``serve/raster.py`` ``text``) composites them.

Needs OpenCV (it renders the glyphs); the port itself never imports it.

    python scripts/make_font_table.py [OUT.npz]

OpenCV 5 moves the pen in whole pixels (each glyph's advance rounded), so
a glyph looks the same wherever it stands: the table holds, for each
printable ASCII glyph, its advance in pixels (measured: the shift of an
``l`` drawn after it) and, for each pixel it touches, one blend weight
``a`` (0..256, ``v += ((c - v) * a + 127) >> 8``) chosen so that white
text on black and black text on white come out as OpenCV draws them.
OpenCV blends each stroke pixel twice a stroke, so a pixel two strokes
cross can differ from it by a few levels on other colours.  The script also
checks every glyph and a few strings against OpenCV and prints the largest
difference.
"""
from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FONT = cv2.FONT_HERSHEY_SIMPLEX
SCALE = 0.5
PAD = 24                      # canvas margin around the pen origin


def render(s: str, bg: int, fg: int, org=(PAD, 2 * PAD),
           size=(4 * PAD, 4 * PAD + 40)) -> np.ndarray:
    img = np.full((size[0], size[1], 3), bg, np.uint8)
    cv2.putText(img, s, org, FONT, SCALE, (fg, fg, fg), 1, cv2.LINE_AA)
    return img[..., 0].astype(np.int64)


def blend(v, c, a):
    return v + (((c - v) * a + 127) >> 8)


def weights(white: np.ndarray, black: np.ndarray) -> np.ndarray:
    """Per pixel, the weight in 0..256 whose single blend best gives both
    renders (white on black, black on white)."""
    a = np.arange(257)[:, None, None]
    err = (np.abs(blend(0, 255, a) - white[None])
           + np.abs(blend(255, 0, a) - black[None]))
    return err.argmin(0)


def glyph(ch: str):
    """(oy, ox, weights) of ``ch`` relative to the pen."""
    w = weights(render(ch, 0, 255), render(ch, 255, 0))
    ys, xs = np.nonzero(w)
    if len(ys) == 0:
        return 0, 0, np.zeros((0, 0), np.uint16)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return int(y0 - 2 * PAD), int(x0 - PAD), w[y0:y1, x0:x1].astype(np.uint16)


def _centroid(img: np.ndarray) -> float:
    cols = img.sum(0).astype(float)
    return float((cols * np.arange(len(cols))).sum() / cols.sum())


def advance(ch: str) -> int:
    """The pen's move over ``ch`` in whole pixels: how far an ``l`` drawn
    after it lands from one drawn alone."""
    after = render(ch + "l", 0, 255) - render(ch, 0, 255)
    shift = _centroid(np.clip(after, 0, None)) - _centroid(render("l", 0, 255))
    assert abs(shift - round(shift)) < 0.05, (ch, shift)
    return int(round(shift))


def main(out: Path) -> None:
    codes = list(range(32, 127))
    arrays = {"codes": np.asarray(codes, np.int32),
              "advance": np.asarray([advance(chr(c)) for c in codes],
                                    np.int32)}
    for c in codes:
        oy, ox, w = glyph(chr(c))
        arrays[str(c)] = w
        arrays[f"{c}_origin"] = np.asarray([oy, ox], np.int32)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    check()


def check() -> None:
    """Every glyph and some strings, white on black and on a random
    background in colour, against OpenCV."""
    import torch
    sys.path.insert(0, str(ROOT))
    from lameness_tpu_torch.serve import raster
    raster.font_table.cache_clear()
    raster.text.cache_clear()
    rng = np.random.default_rng(0)
    strings = [chr(c) for c in range(32, 127)] + [
        "video: 3f2a9c1e-77b0", "frame: 124", "direction: left_to_right",
        "lameness: 63.2%", "cow 0.87", "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"]
    worst = 0
    for s in strings:
        for color in ((255, 255, 255), (0, 200, 0)):
            bg = rng.integers(0, 256, (48, 320, 3), dtype=np.uint8)
            ref = bg.copy()
            cv2.putText(ref, s, (5, 30), FONT, SCALE, color, 1, cv2.LINE_AA)
            got = torch.from_numpy(bg[None].copy())
            raster.apply(got, [(0, raster.text(320, 48, s, (5, 30)),
                                color)])
            d = np.abs(got[0].numpy().astype(int) - ref.astype(int)).max()
            worst = max(worst, int(d))
    print(f"largest difference from OpenCV over {len(strings)} strings: "
          f"{worst}")


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1
         else ROOT / "lameness_tpu_torch" / "serve" / "font_simplex.npz")
