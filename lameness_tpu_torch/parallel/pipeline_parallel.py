"""Pipeline parallelism: GPipe microbatching over a ``stage`` mesh axis
(port of ``lameness_tpu/parallel/pipeline_parallel.py``).

Each mesh position holds one stage's weights (its slice of the stacked
parameters).  The batch is cut into M microbatches, and the schedule runs
S + M - 1 ticks (S stages): at tick t, stage s computes microbatch t - s
when that is in range, and hands its output on to stage s + 1's device.
Within a tick the stages are independent, so on separate devices they run
at once.  Equal to applying the stages one after another to each
microbatch.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from .mesh import Mesh, NamedSharding, P, device_put, map_tree

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, devices=None) -> Mesh:
    """A 1-D ``stage`` mesh over the first ``n_stages`` of ``devices``
    (default: the visible cards, each once)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_stage_mesh: no CUDA device; pass "
                               "devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_stages > len(devices):
        raise ValueError(f"{n_stages} stages, {len(devices)} devices")
    grid = np.empty(n_stages, object)
    grid[:] = [torch.device(d) for d in devices[:n_stages]]
    return Mesh(grid, (STAGE_AXIS,))


def stack_stage_params(per_stage_params: List[Any]) -> Any:
    """Per-stage parameter trees of one structure -> one tree whose leaves
    have a leading stage axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh: Mesh,
                   num_microbatches: int) -> torch.Tensor:
    """Run ``stage_fn`` S times over the stage mesh, microbatched.

    stage_fn(params_of_stage, micro_x) -> micro_y of micro_x's shape;
    stacked_params: a tree with leading stage axis S (position s holds
    slice s); x: (B, ...) with B divisible by ``num_microbatches``.
    Returns (B, ...) on x's device."""
    devices = list(mesh.devices.flat)
    n_stages = len(devices)
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{num_microbatches} microbatches")
    placed = map_tree(lambda _, leaf: device_put(
        leaf, NamedSharding(mesh, P(STAGE_AXIS))), stacked_params)

    def stage_params(s: int):
        return map_tree(lambda _, leaf: leaf.shards[s][0], placed)
    params = [stage_params(s) for s in range(n_stages)]
    micro = x.chunk(num_microbatches)
    outputs: List[torch.Tensor] = [None] * num_microbatches
    incoming: List[torch.Tensor] = [None] * n_stages
    for t in range(n_stages + num_microbatches - 1):
        arriving: List[torch.Tensor] = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < num_microbatches:
                continue
            inp = micro[mb].to(devices[0]) if s == 0 else incoming[s]
            out = stage_fn(params[s], inp)
            if s == n_stages - 1:
                outputs[mb] = out
            else:
                arriving[s + 1] = out.to(devices[s + 1])
        incoming = arriving
    return torch.cat([o.to(x.device) for o in outputs])


def sequential_reference(stage_fn, per_stage_params: list,
                         x: torch.Tensor) -> torch.Tensor:
    """Ground truth: the stages one after another."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x
