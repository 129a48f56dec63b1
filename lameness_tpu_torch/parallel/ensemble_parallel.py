"""Ensemble (MC-dropout) parallelism: the sample axis over a mesh (port of
``lameness_tpu/parallel/ensemble_parallel.py``).

No model here is a mixture of experts, so there are no expert weights to
shard; what the workload has is an ensemble axis: the temporal heads
estimate uncertainty from n-sample MC dropout.  Each sample's dropout comes
from its own ``torch.Generator``, seeded from the split key, so sharding
moves samples between devices but does not change their draws: the stack
equals the unsharded one.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, P, Sharded

ENSEMBLE_AXIS = "ensemble"


def make_ensemble_mesh(n_devices: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh whose one axis carries MC/ensemble samples (default: the
    visible cards, each once)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_ensemble_mesh: no CUDA device; pass "
                               "devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    grid = np.empty(n_devices, object)
    grid[:] = [torch.device(d) for d in devices[:n_devices]]
    return Mesh(grid, (ENSEMBLE_AXIS,))


def split_seeds(rng: torch.Generator, n: int) -> list:
    """``n`` seeds drawn from ``rng`` (JAX's ``random.split``)."""
    return torch.randint(0, 2 ** 62, (n,), generator=rng).tolist()


def mc_dropout_sharded(apply_one: Callable[[torch.Generator], torch.Tensor],
                       mesh: Mesh, rng: torch.Generator,
                       n_samples: int) -> Sharded:
    """``apply_one(generator)`` for ``n_samples`` generators with the sample
    axis split over ``mesh``: sample i runs on position i // (n_samples /
    mesh size), with a generator on that position's device seeded from the
    i-th split of ``rng``.  ``apply_one`` is one stochastic forward on the
    generator's device (it closes over the replicated params and inputs).
    Returns the stack (n_samples, ...) as a ``Sharded`` over the mesh
    (``.full()`` gathers it; mean and std reduce it)."""
    devices = list(mesh.devices.flat)
    if n_samples % len(devices):
        raise ValueError(f"n_samples={n_samples} not a multiple of mesh size "
                         f"{len(devices)}")
    per = n_samples // len(devices)
    seeds = split_seeds(rng, n_samples)
    shards = np.empty(mesh.devices.shape, object)
    for pos in mesh.positions():
        i = int(np.ravel_multi_index(pos, mesh.devices.shape))
        dev = mesh.devices[pos]
        outs = [apply_one(torch.Generator(device=dev).manual_seed(seed))
                for seed in seeds[i * per:(i + 1) * per]]
        shards[pos] = torch.stack(outs)
    first = shards.flat[0]
    return Sharded(mesh, P(mesh.axis_names), (n_samples,) + first.shape[1:],
                   shards)
