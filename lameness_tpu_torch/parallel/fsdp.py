"""FSDP (ZeRO-3) layout of the training state (port of
``lameness_tpu/parallel/fsdp.py``).

The train step (``pipeline/train.py``) runs dp over the clip batch and tp
over DINO's blocks; this adds the third memory axis: every large parameter
and its AdamW moments are split over the ``data`` axis as well, so each
position holds about 1/dp of the state.  Where JAX lets GSPMD insert the
all-gather on use and the reduce-scatter of the gradients, the port's step
gathers a leaf's data blocks onto each position that computes with it
(``Sharded.local``), and autograd sends each block its summed gradient back
through the gather.  The step updates the shards in place, so the layout it
is given is the layout it returns; ``state_shardings`` pins it (the step
checks it on the way in and out), as the JAX function pins the jit's
layouts.

Usage::

    state, tx = init_train_state(generator, mesh, models)
    state = shard_train_state_fsdp(state, mesh, tp_spec=tp_spec)
    step_fn, batch_sh = make_train_step(
        mesh, models, tx, state_shardings=state_shardings(state))
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..pipeline.optim import Optimizer
from .mesh import (DATA_AXIS, Mesh, NamedSharding, P, device_put, leaves,
                   map_tree, replica_groups)

__all__ = ["fsdp_leaf_spec", "shard_params_fsdp", "shard_train_state_fsdp",
           "state_shardings"]


def state_shardings(state):
    """The layout of a placed ``TrainState``'s parameters (a tree of
    ``NamedSharding``), for ``make_train_step(..., state_shardings=...)``;
    the moments follow their parameters."""
    return type(state)(map_tree(lambda _, leaf: leaf.sharding, state.params),
                       None, None)


def fsdp_leaf_spec(leaf, dp: int, base: Optional[P] = None,
                   min_size: int = 1024) -> P:
    """FSDP PartitionSpec for one parameter leaf: the largest axis whose
    size divides by ``dp`` and that ``base`` (a tensor-parallel spec) leaves
    free gets the data axis (ties: the later axis); leaves under
    ``min_size`` elements stay as ``base`` (replicated without one)."""
    shape = tuple(getattr(leaf, "shape", ()))
    ndim = len(shape)
    base_entries = tuple(base) if base is not None else ()
    if any(e == DATA_AXIS or (isinstance(e, tuple) and DATA_AXIS in e)
           for e in base_entries):
        # the base already takes the data axis: keep the caller's spec
        return P(*base_entries)
    base_entries = base_entries + (None,) * (ndim - len(base_entries))
    size = 1
    for d in shape:
        size *= d
    if ndim == 0 or size < min_size:
        return P(*base_entries) if base is not None else P()
    best = -1
    for ax in range(ndim):
        if base_entries[ax] is not None:
            continue
        if shape[ax] % dp == 0 and (best < 0 or shape[ax] >= shape[best]):
            best = ax
    if best < 0:
        return P(*base_entries) if base is not None else P()
    entries = list(base_entries)
    entries[best] = DATA_AXIS
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _fsdp_sharding(mesh: Mesh, path, leaf, tp_spec: Optional[Callable],
                   min_size: int) -> NamedSharding:
    """``tp_spec(path, leaf)`` (a tensor-parallel base spec, or None)
    composed with FSDP's data axis."""
    base = tp_spec(path, leaf) if tp_spec is not None else None
    return NamedSharding(mesh, fsdp_leaf_spec(
        leaf, mesh.shape[DATA_AXIS], base, min_size))


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(t.requires_grad)


def shard_params_fsdp(params, mesh: Mesh, tp_spec: Optional[Callable] = None,
                      min_size: int = 1024):
    """Re-place a parameter tree (tensors or ``Sharded``) with every large
    leaf split over the data axis, composing with ``tp_spec``'s axes."""
    return map_tree(lambda path, leaf: device_put(leaf, _fsdp_sharding(
        mesh, path, leaf, tp_spec, min_size)).map(_leaf), params)


MOMENTS = ("exp_avg", "exp_avg_sq")


def shard_train_state_fsdp(state, mesh: Mesh,
                           tp_spec: Optional[Callable] = None,
                           min_size: int = 1024):
    """ZeRO-3 placement of a ``pipeline.train.TrainState``: the parameters
    get the FSDP specs, and the AdamW moments of each parameter shard
    (``exp_avg``, ``exp_avg_sq``) the same blocks of the same specs, on the
    same devices; the step count is copied to every shard.  Raises
    ``TypeError`` when the optimiser's state holds a tensor it does not
    place."""
    opt: Optimizer = state.opt_state
    old_state = opt.adamw.state
    n_state = sum(isinstance(v, torch.Tensor)
                  for s in old_state.values() for v in s.values())
    placed = [0]
    new_state = {}

    def place(path, leaf):
        new = device_put(leaf, _fsdp_sharding(mesh, path, leaf, tp_spec,
                                              min_size)).map(_leaf)
        first = old_state.get(leaf.shards.flat[0], {})
        for key in MOMENTS:
            if key not in first:
                continue
            moment = leaf.map(lambda t: old_state[t][key])
            placed[0] += len(leaf.tensors())
            moved = device_put(moment, new.sharding)
            for pos in mesh.positions():
                new_state.setdefault(new.shards[pos], {})[key] = \
                    moved.shards[pos]
        if "step" in first:
            placed[0] += len(leaf.tensors())
            for t in new.tensors():
                new_state.setdefault(t, {})["step"] = first["step"].clone()
        return new

    params = map_tree(place, state.params)
    if placed[0] != n_state:
        raise TypeError(
            f"shard_train_state_fsdp placed {placed[0]} of {n_state} "
            "optimiser state tensors; the state holds entries other than "
            f"AdamW's {MOMENTS} and step")
    group = opt.adamw.param_groups[0]
    tensors = [t for leaf in leaves(params) for t in leaf.tensors()]
    new_opt = Optimizer(tensors, opt.lr, group["weight_decay"],
                        opt.max_norm, replicas=replica_groups(params),
                        count=opt.count)
    for t, entries in new_state.items():
        new_opt.adamw.state[t] = entries
    return type(state)(params, new_opt, state.step)

