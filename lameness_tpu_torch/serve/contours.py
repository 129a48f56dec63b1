"""Mask shape measures without OpenCV: the parts of ``cv2.resize``
(INTER_NEAREST), ``cv2.findContours`` (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE),
``cv2.contourArea``, ``cv2.arcLength`` and ``cv2.boundingRect`` that the
result writer reads (``lameness_tpu/serve/driver.py`` ``_mask_features``),
in numpy and scipy.  The machine with the card has no OpenCV;
``tests/test_torch_serve.py`` holds these against cv2.

cv2 traces each outer border with Suzuki and Abe's rule: from the pixel
it came from, it turns counterclockwise around the current pixel to the
first foreground neighbour.  That rule is a bijection on the states
(pixel, direction it was entered from), so every border is one cycle of
states, and the next state depends only on the pixel's 8 neighbours.  Here
the successor of every state of the border pixels is computed at once, the
cycle through each component's first state (its first pixel in raster
order, entered as cv2 enters it) is a weakly connected component of the
successor graph (scipy's C routines: a component, a depth-first walk),
and:
- the area is the shoelace sum over the cycle's steps, exact in integers
  (CHAIN_APPROX_SIMPLE drops only collinear points, which add nothing);
- the perimeter is cv2's: one float32 ``sqrt`` per run of equal steps (the
  segments between the points CHAIN_APPROX_SIMPLE keeps), summed in
  float64;
- the bounding rectangle is the component's (the outer border holds its
  extreme pixels).
cv2 lists the contours in reverse order of discovery, so among equal areas
``max`` picks the component found last.  A component inside a hole of
another is not an outer contour for RETR_EXTERNAL, but its area is smaller
than its encloser's, so it never is the largest: components are not told
apart by nesting.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, depth_first_order

# chain code s -> step (dx, dy), cv2's order: right, then counterclockwise
# on the screen (y down)
DX = np.array([1, 1, 0, -1, -1, -1, 0, 1], np.int64)
DY = np.array([0, -1, -1, -1, 0, 1, 1, 1], np.int64)


def _turn_table() -> np.ndarray:
    """[neighbour bits, entry direction b] -> the first direction after b,
    counterclockwise (b + 1, ..., b + 8), whose neighbour is foreground."""
    bits = np.arange(256)[:, None, None] >> np.arange(8)[None, None, :] & 1
    order = (np.arange(8)[:, None] + np.arange(1, 9)[None, :]) & 7
    hit = bits[:, 0, :][:, order]                     # (256, 8 b, 8 k)
    first = np.argmax(hit, axis=-1)
    return np.take_along_axis(np.broadcast_to(order, (256, 8, 8)),
                              first[..., None], -1)[..., 0]


TURN = _turn_table()
# cv2's search for the direction a border's first pixel is entered from
START_ORDER = (3, 2, 1, 0, 7, 6, 5, 4)


def resize_nearest(mask: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(mask, (width, height), interpolation=INTER_NEAREST)``:
    destination x reads source ``floor(x * (1 / (width / src_w)))``, in
    float64 as cv2 computes it, clamped to the last column (rows alike)."""
    sh, sw = mask.shape[:2]

    def index(dst, src):
        i = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
        return np.minimum(i, src - 1)
    return np.take(np.take(mask, index(height, sh), axis=0),
                   index(width, sw), axis=1)


def _border(sub: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The foreground pixels with a background neighbour (outside the
    array counts as background), as flat indices in raster order, and
    their neighbour bits (bit s set when the neighbour at chain code s is
    foreground)."""
    h, w = sub.shape
    pad = np.zeros((h + 2, w + 2), np.uint8)
    pad[1:-1, 1:-1] = sub
    rows = pad[:-2] & pad[1:-1] & pad[2:]
    inner = rows[:, :-2] & rows[:, 1:-1] & rows[:, 2:]
    pix = np.flatnonzero(sub & (inner == 0))
    py, px = np.divmod(pix, w)
    at = (py + 1) * (w + 2) + px + 1
    flat = pad.ravel()
    code = np.zeros(len(pix), np.uint8)
    for s in range(8):
        code |= flat[at + DY[s] * (w + 2) + DX[s]] << np.uint8(s)
    return pix, code


def largest_external_contour(mask: np.ndarray
                             ) -> Optional[Tuple[float, float, Tuple]]:
    """For cv2's largest outer contour of a binary mask,
    ``max(findContours(m, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0],
    key=contourArea)``: (its ``contourArea``, its closed ``arcLength``, its
    ``boundingRect`` (x, y, w, h)), or None for an empty mask."""
    m = np.asarray(mask, bool)
    rows = np.flatnonzero(m.any(1))
    if rows.size == 0:
        return None
    cols = np.flatnonzero(m.any(0))
    y0, x0 = int(rows[0]), int(cols[0])
    sub = m[y0:rows[-1] + 1, x0:cols[-1] + 1]
    w = sub.shape[1]
    pix, code = _border(sub)
    py, px = np.divmod(pix, w)
    where = np.full(sub.size, -1, np.int64)
    where[pix] = np.arange(len(pix))
    # the states: (border pixel, direction of a foreground neighbour it
    # can be entered from), and the state each one leads to.  On an outer
    # border the turn from the entry passes background first, so only
    # entries whose next neighbour counterclockwise is background are kept
    # (a kept state's successor is one too)
    after = (code >> 1) | (code << 7)           # bit b: neighbour b + 1
    st_p, st_b = np.nonzero(np.unpackbits((code & ~after)[:, None], axis=1,
                                          bitorder="little"))
    n_st = len(st_p)
    dense = np.full(len(pix) * 8, n_st, np.int64)
    dense[st_p * 8 + st_b] = np.arange(n_st)
    d = TURN[code[st_p], st_b]
    q = where[(py[st_p] + DY[d]) * w + px[st_p] + DX[d]]
    # a step onto an interior pixel leaves the border states: to the sink
    succ = np.where(q >= 0, dense[q * 8 + ((d + 4) & 7)], n_st)
    graph = csr_matrix((np.ones(n_st, np.int8), (np.arange(n_st), succ)),
                       shape=(n_st + 1, n_st + 1))
    # each border is one cycle of states: a weak component apart from the
    # sink's (no state on a cycle is entered from off it)
    _, cycle = connected_components(graph, directed=True, connection="weak")
    sink = cycle[n_st]
    cycle = cycle[:n_st]
    area2 = np.bincount(cycle, weights=(px[st_p] * DY[d] - py[st_p] * DX[d]
                                        ).astype(np.float64))

    # A component's border starts at its first pixel in raster order,
    # entered as cv2 enters it (START_ORDER); such a pixel has no
    # foreground up-right, above, up-left or left (bits 1-4).  Every pixel
    # like that lies on a cycle -- an outer border, or a hole's where the
    # pixel pokes up into a hole -- and a cycle's least one is the
    # component's first pixel on an outer border.  Outer borders run
    # clockwise on the screen (negative shoelace sum), holes' the other way.
    top = np.flatnonzero(code & 0b11110 == 0)
    b0 = np.full(len(top), -1, np.int64)
    for s in START_ORDER[::-1]:
        b0 = np.where((code[top] >> s) & 1 == 1, s, b0)
    lone = top[b0 < 0]                  # one-pixel contours: area 0
    top, b0 = top[b0 >= 0], b0[b0 >= 0]
    first = np.full(len(area2), len(pix), np.int64)
    np.minimum.at(first, cycle[dense[top * 8 + b0]], top)
    outer = np.flatnonzero((first < len(pix)) & (area2 <= 0))
    outer = outer[outer != sink]
    # cv2 lists the contours in reverse discovery order and max keeps the
    # first: among equal areas, the last discovered
    area = np.concatenate([-area2[outer] / 2, np.zeros(len(lone))])
    start = np.concatenate([first[outer], lone])
    best = np.lexsort((-start, -area))[0]
    if best >= len(outer):
        x, y = px[lone[best - len(outer)]], py[lone[best - len(outer)]]
        return 0.0, 0.0, (int(x) + x0, int(y) + y0, 1, 1)

    # the cycle in order from its start: CHAIN_APPROX_SIMPLE keeps a point
    # where the step changes; each kept point's segment is its run of
    # equal steps, one float32 sqrt each, summed in float64
    p0 = start[best]
    order = depth_first_order(graph, dense[p0 * 8 + b0[top == p0][0]],
                              directed=True, return_predecessors=False)
    step = d[order]
    kept = np.flatnonzero(step != np.roll(step, 1))
    run = np.diff(np.append(kept, kept[0] + len(order)))
    sx = (run * DX[step[kept]]).astype(np.float32)
    sy = (run * DY[step[kept]]).astype(np.float32)
    perimeter = float(np.sqrt(sx * sx + sy * sy).astype(np.float64).sum())
    bx, by = px[st_p[order]], py[st_p[order]]
    return (float(area[best]), perimeter,
            (int(bx.min()) + x0, int(by.min()) + y0,
             int(bx.max() - bx.min()) + 1, int(by.max() - by.min()) + 1))


def first_moments(mask: np.ndarray) -> Tuple[int, int, int]:
    """``cv2.moments`` of a 0/1 mask, the three the writer reads: (m00,
    m10, m01) as exact integers."""
    m = np.asarray(mask, bool)
    cols = m.sum(0, dtype=np.int64)
    rows = m.sum(1, dtype=np.int64)
    return (int(cols.sum()), int(cols @ np.arange(len(cols))),
            int(rows @ np.arange(len(rows))))
