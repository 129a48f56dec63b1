"""Sequence parallelism: ring attention over a ``seq`` mesh axis (port of
``lameness_tpu/parallel/ring_attention.py``).

The sequence axis is split over the mesh positions.  Each position keeps its
query block and an online-softmax accumulator (running max, running sum and
the unnormalised output, in float32); the K/V blocks rotate around the ring,
each step moving every visiting block one position on (``.to`` the next
position's device: JAX's ``ppermute``), and each position folds the block it
holds into its accumulator.  After as many steps as positions every query
has seen every key.  Non-causal; equal to full softmax attention up to float
reassociation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import Mesh

SEQ_AXIS = "seq"


def make_seq_mesh(n_devices: int, devices=None) -> Mesh:
    """A 1-D ``seq`` mesh over the first ``n_devices`` of ``devices``
    (default: the visible cards, each once)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_seq_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} "
                         f"given")
    grid = np.empty(n_devices, object)
    grid[:] = [torch.device(d) for d in devices[:n_devices]]
    return Mesh(grid, (SEQ_AXIS,))


def fold_block(acc, s: torch.Tensor, v_blk: torch.Tensor):
    """One online-softmax step: fold the float32 scores ``s`` (..., q, k)
    of a visiting block with its values ``v_blk`` (..., k, d) into
    ``acc`` = (running max, running sum, unnormalised output)."""
    m, l, o = acc
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    o = alpha * o + p @ v_blk.float()
    return m_new, l, o


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, scale: Optional[float] = None) -> torch.Tensor:
    """Full (non-causal) attention with the sequence split over ``mesh``.

    q, k, v: (B, H, S, D) with S divisible by the mesh size.  Returns the
    same shape in q's dtype, on q's device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    devices = list(mesh.devices.flat)
    n = len(devices)
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} does not split over {n}")
    qs = [t.to(dev) for t, dev in zip(q.chunk(n, dim=2), devices)]
    kv = [(a.to(dev), b.to(dev)) for a, b, dev in
          zip(k.chunk(n, dim=2), v.chunk(n, dim=2), devices)]
    accs = []
    for qi in qs:
        shape = qi.shape[:-1] + (1,)
        accs.append((torch.full(shape, -torch.inf, device=qi.device),
                     torch.zeros(shape, device=qi.device),
                     torch.zeros(qi.shape, device=qi.device)))
    for step in range(n):
        for i, qi in enumerate(qs):
            k_blk, v_blk = kv[i]
            s = (qi.float() @ k_blk.float().transpose(-1, -2)) * scale
            accs[i] = fold_block(accs[i], s, v_blk)
        if step < n - 1:
            # every block one position on around the ring
            kv = [(a.to(devices[i]), b.to(devices[i]))
                  for i, (a, b) in enumerate(kv[-1:] + kv[:-1])]
    return torch.cat([(o / l).to(q.dtype).to(q.device)
                      for _, l, o in accs], dim=2)
