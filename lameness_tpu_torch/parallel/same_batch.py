"""The sharded engine's reference: the unsharded engine at the same batch.

JAX draws a dropout mask as a function of the key and the global shape, so
a data shard of the sharded engine must consume its clips' rows of the
draws the unsharded engine makes at the whole, padded, batch
(``LamenessEngine._draws``).  The libraries round a clip's floats
differently at another batch size (a product's algorithm depends on M),
so the sharded engine cannot equal the unsharded engine at the whole batch
bit for bit.  It can equal, bit for bit, the unsharded engine run on each
shard's clips alone and fed that shard's rows of the whole batch's
recorded draws, at dropout 0 and at MC dropout alike.  ``same_batch``
gives both references; ``batch_difference`` the libraries' difference
between them, leaf by leaf, which is printed and gates nothing.

The helpers take the engine's host output trees (``readback=True``):
nested dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def leaf_items(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The leaves of a nested output dict, keys joined with '.'."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(leaf_items(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def rows_of(full: torch.Tensor, batch: int, lo: int, hi: int
            ) -> torch.Tensor:
    """Rows ``lo:hi`` of each of the blocks of ``batch`` rows that make up
    a draw (the heads' rows ``m·batch + i``: sample m of clip i), as one
    tensor of the shard's shape."""
    groups = full.shape[0] // batch
    if groups * batch != full.shape[0]:
        raise ValueError(f"a draw of {tuple(full.shape)} is not blocks of "
                         f"{batch} rows")
    rest = tuple(full.shape[1:])
    return full.view((groups, batch) + rest)[:, lo:hi].reshape(
        (groups * (hi - lo),) + rest)


class RecordedDraws:
    """A draw object (``models/tcn.py`` ``dropout`` calls ``rand``) that
    draws from ``generator`` as the generator itself would, and keeps each
    draw in order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: List[torch.Tensor] = []

    def rand(self, shape, device) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=device)
        self.draws.append(u)
        return u


class ReplayedRows:
    """A draw object that hands out, in order, rows ``lo:hi`` of each
    recorded draw of a ``batch``-clip run."""

    def __init__(self, draws: Sequence[torch.Tensor], batch: int, lo: int,
                 hi: int):
        self.draws, self.batch, self.lo, self.hi = list(draws), batch, lo, hi
        self.used = 0

    def rand(self, shape, device) -> torch.Tensor:
        if self.used == len(self.draws):
            raise ValueError("ReplayedRows: more draws than were recorded")
        u = rows_of(self.draws[self.used], self.batch, self.lo, self.hi)
        self.used += 1
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"ReplayedRows: a draw of {tuple(shape)}, the "
                             f"recorded rows are {tuple(u.shape)}")
        return u.to(device)


def _concat(trees):
    first = trees[0]
    return {k: _concat([t[k] for t in trees]) if isinstance(v, dict)
            else np.concatenate([t[k] for t in trees])
            for k, v in first.items()}


def _trim(tree, b: int):
    return {k: _trim(v, b) if isinstance(v, dict) else v[:b]
            for k, v in tree.items()}


def same_batch(eng, frames: np.ndarray, generator: torch.Generator,
               dp: int, **kw) -> Tuple[dict, dict, List[torch.Tensor]]:
    """The unsharded ``eng`` on ``frames`` padded with zero clips to a
    multiple of ``dp`` (what a dp-way sharded engine runs): (its outputs at
    the whole batch, its outputs on each of the dp blocks alone fed that
    block's rows of the whole batch's draws, the draws), both output trees
    trimmed to ``len(frames)``.  ``generator`` ends where the whole-batch
    call leaves it; ``kw`` goes to ``process_clip_batch``."""
    b = len(frames)
    padded = np.concatenate(
        [frames, np.zeros((-b % dp,) + frames.shape[1:], frames.dtype)])
    rec = RecordedDraws(generator)
    whole = eng.process_clip_batch(padded, rec, **kw)
    per = len(padded) // dp
    blocks = []
    for d in range(dp):
        rows = ReplayedRows(rec.draws, len(padded), d * per, (d + 1) * per)
        blocks.append(eng.process_clip_batch(padded[d * per:(d + 1) * per],
                                             rows, **kw))
        if rows.used != len(rec.draws):
            raise ValueError(f"block {d} drew {rows.used} times, the whole "
                             f"batch {len(rec.draws)}")
    return _trim(whole, b), _trim(_concat(blocks), b), rec.draws


def batch_difference(got, want) -> Dict[str, str]:
    """The leaves where ``got`` and ``want`` differ: the count of differing
    elements of an integer or boolean leaf, the largest |got - want| of a
    float leaf."""
    a, b = leaf_items(got), leaf_items(want)
    out = {}
    for key, w in b.items():
        if w.dtype.kind in "biu":
            n = int((a[key] != w).sum())
            if n:
                out[key] = f"{n} of {w.size}"
        else:
            d = float(np.abs(a[key].astype(np.float64) - w).max()) \
                if w.size else 0.0
            if d:
                out[key] = f"{d:.3e}"
    return out


def differing_leaves(got, want) -> List[str]:
    """The leaves of ``got`` that are not ``want``'s bit for bit (a leaf
    missing from either, or of another dtype or shape, counts)."""
    a, b = leaf_items(got), leaf_items(want)
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not np.array_equal(a[k], b[k]))


def shard_draws_are_rows(whole: Sequence[torch.Tensor], shard_draws,
                         batch: int, dp: int) -> bool:
    """``shard_draws``, (lo, hi, tensor) in the order the dp shards drew
    them, are each shard's rows of the whole batch's draws ``whole``, site
    by site, bit for bit."""
    n, per = len(whole), batch // dp
    if n == 0 or len(shard_draws) != dp * n:
        return False
    return all((lo, hi) == ((i // n) * per, (i // n + 1) * per)
               and torch.equal(u, rows_of(whole[i % n], batch, lo, hi))
               for i, (lo, hi, u) in enumerate(shard_draws))
