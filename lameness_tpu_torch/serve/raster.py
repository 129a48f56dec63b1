"""OpenCV's drawing primitives without OpenCV, for ``serve/annotation.py``.

The JAX renderer draws with ``cv2.line``/``cv2.circle`` (``LINE_AA``),
``cv2.rectangle`` (outlined at thickness 2 and filled, 8-connected),
``cv2.addWeighted`` and ``cv2.putText`` (``FONT_HERSHEY_SIMPLEX`` at scale
0.5).  The machine with the card has no OpenCV, so this module renders the
same pixels in two halves:

- the geometry, on the host: each primitive becomes a list of pixel
  blends ``v += ((c - v) * a + 127) >> 8`` (OpenCV's anti-aliased pixel
  rule, which ``LineAA`` applies twice a pixel; ``a = 256`` sets the pixel
  to ``c``), in OpenCV's drawing order.
  The line, convex-polygon and ellipse rasterisers are OpenCV's
  ``LineAA``, ``FillConvexPoly`` and ``ellipse2Poly`` in its 16-bit fixed
  point.  Text composites each glyph from ``font_simplex.npz``, a table of
  OpenCV's glyphs at scale 0.5 (``scripts/make_font_table.py`` writes it):
  each glyph's advance, and one blend weight for each pixel it touches;
- the pixels, on the frames' device: ``apply`` runs a list's blends in
  order over a batch of frames (blends that hit one pixel twice are split
  into rounds), ``add_weighted`` is ``cv2.addWeighted``'s arithmetic
  (``fma(a, alpha, b * beta)`` in float32, rounded half to even).

The geometry depends only on the primitives' arguments, so it is cached.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's LineAA tables (imgproc/src/drawing.cpp)
SLOPE_CORR = np.array([
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254], np.int64)
FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], np.int64)

FONT_TABLE = Path(__file__).with_name("font_simplex.npz")

# one primitive's blends: (flat pixel index y * W + x, weight 0..256, with
# TWICE set for a blend applied twice, as LineAA does)
Ops = Tuple[np.ndarray, np.ndarray]
TWICE = 0x200
_EMPTY: Ops = (np.zeros(0, np.int64), np.zeros(0, np.int64))


def _cat(parts: Sequence[Ops]) -> Ops:
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return _EMPTY
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine`` on a (w, h) box (fixed point in, fixed point
    out); None when the segment misses it."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


@functools.lru_cache(maxsize=4096)
def line_aa(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int]) -> Ops:
    """OpenCV's ``LineAA`` (a one-pixel anti-aliased line) between two
    fixed-point points on a (w, h) image."""
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return _EMPTY
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2 = x2, x1
            y1, y2 = y2, y1
        step = (dy << XY_SHIFT) // (ax | 1) if dy >= 0 else \
            -((-dy << XY_SHIFT) // (ax | 1))
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        j = -(x1 & (XY_ONE - 1))
        y1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (step >> (XY_SHIFT - 5)) & 0x3f
        slope ^= 0x3f if step < 0 else 0
        i = (x1 >> (XY_SHIFT - 7)) & 0x78
        j = ((x2 - XY_ONE) >> (XY_SHIFT - 7)) & 0x78
        major0, minor0 = x1 >> XY_SHIFT, y1
    else:
        if dy < 0:
            dx = -dx
            x1, x2 = x2, x1
            y1, y2 = y2, y1
        step = (dx << XY_SHIFT) // (ay | 1) if dx >= 0 else \
            -((-dx << XY_SHIFT) // (ay | 1))
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        j = -(y1 & (XY_ONE - 1))
        x1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (step >> (XY_SHIFT - 5)) & 0x3f
        slope ^= 0x3f if step < 0 else 0
        i = (y1 >> (XY_SHIFT - 7)) & 0x78
        j = ((y2 - XY_ONE) >> (XY_SHIFT - 7)) & 0x78
        major0, minor0 = y1 >> XY_SHIFT, x1
    slope = 0x100 if slope & 0x20 else int(SLOPE_CORR[slope])
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = np.zeros(9, np.int64)
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff
    ep[2] = (t1 >> 8) & 0x1ff
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff
    ep[5] = ((t1 + t0) >> 8) & 0x1ff
    ep[6] = (t2 >> 8) & 0x1ff
    ep[7] = ((t2 + t0) >> 8) & 0x1ff

    n = ecount + 1
    k = np.arange(n, dtype=np.int64)
    major = major0 + k
    minor_fx = minor0 + step * k            # exact in int64
    scount, ecnt = k, ecount - k
    fs = np.minimum(scount, 2)
    fe = np.minimum(ecnt, 2)
    corr = ep[fs * 3 + fe]
    dist = (minor_fx >> (XY_SHIFT - 5)) & 31
    base = (minor_fx >> XY_SHIFT) - 1
    idx, wt = [], []
    size_major, size_minor = (w, h) if ax > ay else (h, w)
    ok = (major >= 0) & (major < size_major)
    for off, tab in ((0, FILTER[dist + 32]), (1, FILTER[dist]),
                     (2, FILTER[63 - dist])):
        m = base + off
        a = (corr * tab >> 8) & 0xff
        keep = ok & (m >= 0) & (m < size_minor)
        if ax > ay:
            flat = m * w + major
        else:
            flat = major * w + m
        # the three pixels of a step are blended in this order
        idx.append(np.where(keep, flat, -1))
        wt.append(a | TWICE)
    idx = np.stack(idx, 1).ravel()
    wt = np.stack(wt, 1).ravel()
    keep = idx >= 0
    return idx[keep], wt[keep]


def _hline(w: int, y: int, x1: int, x2: int) -> Ops:
    xs = np.arange(x1, x2 + 1, dtype=np.int64)
    return y * w + xs, np.full(len(xs), 256, np.int64)


def fill_convex_poly(w: int, h: int, pts: Sequence[Tuple[int, int]]) -> Ops:
    """OpenCV's anti-aliased ``FillConvexPoly`` of fixed-point points: the
    outline by ``LineAA``, then the scanline fill between the edges."""
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    parts: List[Ops] = []
    delta = 1 << XY_SHIFT >> 1
    delta1, delta2 = XY_ONE - 1, 0
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        parts.append(line_aa(w, h, p0, p))
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return _cat(parts)
    ymax = min(ymax, h - 1)
    edges = npts
    # [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        if y < ymax or y == ymin:
            for e in edge:
                if y >= e[4]:
                    idx0, di = e[0], e[1]
                    idx = idx0 + di
                    if idx >= npts:
                        idx -= npts
                    while True:
                        edges -= 1
                        if edges < 0:
                            break
                        ty = (v[idx][1] + delta) >> XY_SHIFT
                        if ty > y:
                            xs, xe = v[idx0][0], v[idx][0]
                            num = (xe - xs) * 2 + (ty - y)
                            den = 2 * (ty - y)
                            e[4] = ty
                            e[3] = _cdiv(num, den)
                            e[2] = xs
                            e[0] = idx
                            break
                        idx0 = idx
                        idx += di
                        if idx >= npts:
                            idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta1) >> XY_SHIFT
            xx2 = (edge[right][2] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                parts.append(_hline(w, y, max(xx1, 0), min(xx2, w - 1)))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    return _cat(parts)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# degrees -> sin, as the float literals of OpenCV's SinTable
def _sin_table(deg: int) -> float:
    return float(np.float32(round(math.sin(math.radians(deg)), 7)))


def ellipse_poly(cx: int, cy: int, axes: int) -> List[Tuple[int, int]]:
    """OpenCV's ``EllipseEx`` polygon of a full circle: ``ellipse2Poly``
    (angle 0, 0..360) in fixed point, rounded, consecutive repeats
    dropped."""
    r = abs(axes)
    d = (r + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    pts = []
    for ang in range(0, 360 + delta, delta):
        ang = min(ang, 360)
        x = r * _sin_table(450 - ang)
        y = r * _sin_table(ang)
        pts.append((cx + x, cy + y))
    out: List[Tuple[int, int]] = []
    for px, py in pts:
        qx = (_round(px / XY_ONE) << XY_SHIFT)
        qy = (_round(py / XY_ONE) << XY_SHIFT)
        q = (qx + _round(px - qx), qy + _round(py - qy))
        if not out or q != out[-1]:
            out.append(q)
    if len(out) == 1:
        out = [(cx, cy)] * 2
    return out


def _round(x: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(round(x))


@functools.lru_cache(maxsize=4096)
def thick_line_aa(w: int, h: int, p0: Tuple[int, int], p1: Tuple[int, int],
                  thickness: int) -> Ops:
    """``cv2.line(img, p0, p1, color, thickness, LINE_AA)`` for integer
    points: the points clipped to the image grown by ``thickness`` on each
    side, then the anti-aliased quad and a round cap at each end."""
    if thickness <= 1:
        return line_aa(w, h, (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT),
                       (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT))
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, (p0[0] + m, p0[1] + m),
                         (p1[0] + m, p1[1] + m))
    if clipped is None:
        return _EMPTY
    (x0, y0), (x1, y1) = clipped
    fp0 = ((x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT)
    fp1 = ((x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT)
    parts: List[Ops] = []
    dx = (fp0[0] - fp1[0]) / XY_ONE
    dy = (fp1[1] - fp0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (th + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        quad = [(fp0[0] + dpx, fp0[1] + dpy), (fp0[0] - dpx, fp0[1] - dpy),
                (fp1[0] - dpx, fp1[1] - dpy), (fp1[0] + dpx, fp1[1] + dpy)]
        parts.append(fill_convex_poly(w, h, quad))
    for c in (fp0, fp1):
        parts.append(fill_convex_poly(w, h, ellipse_poly(c[0], c[1], th)))
    return _cat(parts)


@functools.lru_cache(maxsize=4096)
def circle_aa(w: int, h: int, center: Tuple[int, int], radius: int,
              filled: bool) -> Ops:
    """``cv2.circle(img, center, radius, color, -1 or 1, LINE_AA)``."""
    poly = ellipse_poly(center[0] << XY_SHIFT, center[1] << XY_SHIFT,
                        radius << XY_SHIFT)
    if filled:
        return fill_convex_poly(w, h, poly)
    return _cat([line_aa(w, h, a, b) for a, b in zip(poly[:-1], poly[1:])])


def _box(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> Ops:
    """Every pixel of the box [x1, x2] x [y1, y2] inside the image."""
    x1, x2 = max(x1, 0), min(x2, w - 1)
    y1, y2 = max(y1, 0), min(y2, h - 1)
    if x1 > x2 or y1 > y2:
        return _EMPTY
    ys, xs = np.mgrid[y1:y2 + 1, x1:x2 + 1]
    idx = (ys * w + xs).ravel().astype(np.int64)
    return idx, np.full(len(idx), 256, np.int64)


@functools.lru_cache(maxsize=4096)
def rectangle(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int],
              thickness: int) -> Ops:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` (8-connected) for
    thickness -1 (filled) and 2: the box, or its four sides as bands
    three pixels wide with the corners' outermost pixel left out."""
    x1, x2 = sorted((p1[0], p2[0]))
    y1, y2 = sorted((p1[1], p2[1]))
    if thickness < 0:
        return _box(w, h, x1, y1, x2, y2)
    if thickness != 2:
        raise NotImplementedError("rectangle: thickness -1 or 2")
    parts = [_box(w, h, x1, y1 - 1, x2, y1 + 1),      # top
             _box(w, h, x1, y2 - 1, x2, y2 + 1),      # bottom
             _box(w, h, x1 - 1, y1, x1 + 1, y2),      # left
             _box(w, h, x2 - 1, y1, x2 + 1, y2)]      # right
    idx, wt = _cat(parts)
    idx = np.unique(idx)
    return idx, np.full(len(idx), 256, np.int64)


@functools.lru_cache(maxsize=1)
def font_table():
    """{char code: (advance in pixels, glyph's top-left (dy, dx) from the
    pen, weights)} from ``font_simplex.npz``."""
    data = np.load(FONT_TABLE)
    out = {}
    for i, code in enumerate(data["codes"]):
        oy, ox = (int(v) for v in data[f"{code}_origin"])
        out[int(code)] = (int(data["advance"][i]), oy, ox,
                          data[str(code)].astype(np.int64))
    return out


@functools.lru_cache(maxsize=4096)
def text(w: int, h: int, s: str, org: Tuple[int, int]) -> Ops:
    """``cv2.putText(img, s, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
    LINE_AA)``: each glyph's tabulated weights at its pen position."""
    table = font_table()
    parts: List[Ops] = []
    pen = org[0]
    for ch in s:
        code = ord(ch)
        if code not in table:
            # outside printable ASCII (the renderer's strings are ASCII);
            # OpenCV draws glyphs of its own for some of these
            code = ord("?")
        adv, oy, ox, wts = table[code]
        gy, gx = np.nonzero(wts)
        ys = org[1] + oy + gy
        xs = pen + ox + gx
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        parts.append(((ys * w + xs)[keep], wts[gy, gx][keep]))
        pen += adv
    return _cat(parts)


# ---------------------------------------------------------------- pixels ---
def _rounds(idx: np.ndarray) -> np.ndarray:
    """For each blend, how many earlier blends of the list hit its pixel."""
    order = np.argsort(idx, kind="stable")
    s = idx[order]
    start = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1]
    run = np.repeat(start, np.diff(np.r_[start, len(s)]))
    rank = np.empty(len(idx), np.int64)
    rank[order] = np.arange(len(s)) - run
    return rank


def apply(frames: torch.Tensor, ops: Sequence[Tuple[int, Ops,
                                                     Tuple[int, int, int]]]
          ) -> None:
    """In place on ``frames`` ((N, H, W, 3) uint8 on any device): for each
    (frame index, (pixels, weights), RGB colour) in order, blend every
    pixel toward the colour, ``v += ((c - v) * a + 127) >> 8`` (twice for
    a weight with ``TWICE`` set).  Blends of one pixel run in list order:
    the list goes to the device once, sorted into rounds that each touch a
    pixel at most once."""
    n, hh, ww, _ = frames.shape
    idx, wt, colors, sizes = [], [], [], []
    for fi, (pix, a), color in ops:
        if len(pix):
            idx.append(pix + fi * hh * ww)
            wt.append(a)
            colors.append(color)
            sizes.append(len(pix))
    if not idx:
        return
    idx = np.concatenate(idx)
    rank = _rounds(idx)
    order = np.argsort(rank, kind="stable")
    table = np.stack([idx, np.concatenate(wt),
                      np.repeat(np.arange(len(sizes)), sizes)], 1)[order]
    dev = frames.device
    table = torch.from_numpy(table).to(dev)
    palette = torch.tensor(colors, dtype=torch.int32).to(dev)
    flat = frames.view(-1, 3)
    start = 0
    for count in np.bincount(rank).tolist():
        part = table[start:start + count]
        start += count
        i = part[:, 0]
        w = part[:, 1:2].to(torch.int32)
        a = w & (TWICE - 1)
        c = palette[part[:, 2]]
        v = flat[i].to(torch.int32)
        v = v + (((c - v) * a + 127) >> 8)
        v = torch.where(w >= TWICE, v + (((c - v) * a + 127) >> 8), v)
        flat[i] = v.to(torch.uint8)


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` for uint8 tensors:
    ``round(fma(a, alpha, b * beta))`` in float32 (the product b * beta
    rounded to float32, the fused add once), ties to even."""
    fa = float(np.float32(alpha))
    fb = float(np.float32(beta))
    bb = (b.to(torch.float64) * fb).to(torch.float32).to(torch.float64)
    out = (a.to(torch.float64) * fa + bb).to(torch.float32)
    return torch.round(out).clamp(0, 255).to(torch.uint8)
