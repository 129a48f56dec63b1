"""Linear assignment for the host tracker (port of
``lameness_tpu/track/assignment.py``).

The reference calls ``lap.lapjv(cost, extend_cost=True,
cost_limit=100000)`` (``tracker/matching.py:91``).  The JAX package solves
with a native LAPJV and falls back to scipy's Hungarian solver; the port
solves with scipy only (the card's machine has no ``lap`` and no native
build).  Rectangular and limited problems are reduced to a square one by
the same constant padding; tracker costs are bounded by 2, so the limit
never binds and both solvers reach the same minimum.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def lapjv_square(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Solve a square assignment.  Returns (rowsol, colsol, total_cost)."""
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"lapjv_square: not square {cost.shape}")
    rows, cols = linear_sum_assignment(cost)
    rowsol = np.empty(n, np.int32)
    colsol = np.empty(n, np.int32)
    rowsol[rows] = cols
    colsol[cols] = rows
    return rowsol, colsol, float(cost[rows, cols].sum())


def solve(cost: np.ndarray, cost_limit: float = 1e5
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rectangular assignment with a cost cap, matching the reference's
    ``lap.lapjv(extend_cost=True, cost_limit=...)`` output convention.

    Returns (matched (K, 2) of (row, col), unmatched_rows, unmatched_cols).
    """
    if cost.size == 0:
        return (np.empty((0, 2), int), np.arange(cost.shape[0]),
                np.arange(cost.shape[1]))
    n, m = cost.shape
    k = max(n, m)
    sq = np.full((k, k), cost_limit + 1.0, np.float64)
    sq[:n, :m] = cost
    rowsol, _, _ = lapjv_square(sq)
    matched, un_rows, un_cols = [], [], []
    used_cols = set()
    for i in range(n):
        j = int(rowsol[i])
        if j < m and cost[i, j] <= cost_limit:
            matched.append([i, j])
            used_cols.add(j)
        else:
            un_rows.append(i)
    for j in range(m):
        if j not in used_cols:
            un_cols.append(j)
    return (np.asarray(matched, int).reshape(-1, 2),
            np.asarray(un_rows, int), np.asarray(un_cols, int))
