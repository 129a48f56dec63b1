"""Device mesh and sharding helpers (port of ``lameness_tpu/parallel/mesh.py``).

The JAX package's mesh is single-controller: one process holds a grid of
devices, and every function takes and returns whole arrays.  The port keeps
that: a :class:`Mesh` is a numpy grid of ``torch.device`` entries with named
axes, and a sharded tensor is a :class:`Sharded` holder, one shard per mesh
position.  What XLA's collectives do becomes explicit tensor moves
(``.to(device)``) plus a sum or a concatenation, and autograd carries
gradients back through those moves.

Entries may repeat: a mesh over ``[cuda:0] * 4`` splits the batch, the heads
and the layers on one card, and a grid of CPU devices is the tests'
counterpart of the JAX tests' virtual CPU devices.  Where two positions hold
the same block on the same device they hold the same tensor (no copy).

Layouts.  A :class:`PartitionSpec` entry names the mesh axis (or axes) a
tensor dimension is split over, in contiguous blocks.  The port's ``Linear``
weights are ``(out, in)``, the transpose of flax's ``(in, out)`` kernels, so
:func:`dino_tp_spec` gives the transposed spec of the JAX function; it also
splits a column-parallel layer's bias with its columns (each shard adds the
bias of its own columns), where GSPMD slices the replicated bias itself.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "PartitionSpec", "P",
           "NamedSharding", "Sharded", "device_put", "make_mesh",
           "batch_sharding", "replicated", "shard_batch", "replicate_params",
           "dino_tp_spec", "shard_params_tp", "pad_batch_to_multiple",
           "mesh_context", "replica_groups", "map_tree", "leaves"]


class PartitionSpec(tuple):
    """Per tensor dimension: None (whole), an axis name, or a tuple of axis
    names (split over their product, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A grid of devices with one name per grid axis; ``shape`` maps each
    axis name to its size, as JAX's ``Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        if not isinstance(devices, np.ndarray):
            listed = list(devices)
            devices = np.empty(len(listed), object)
            devices[:] = listed
        grid = np.empty(devices.shape, object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(devices[pos])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis "
                             f"names, got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        return np.ndindex(self.devices.shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _entries(spec: PartitionSpec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    return tuple(_axes(e) for e in spec) + ((),) * (ndim - len(spec))


def _index(mesh: Mesh, pos, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(block index of ``pos`` along ``axes``, number of blocks)."""
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape[a]
        idx = idx * size + pos[mesh.axis_names.index(a)]
        n *= size
    return idx, n


class Sharded:
    """One tensor laid out over a mesh: ``shards[pos]`` is the block that
    mesh position ``pos`` holds, on ``mesh.devices[pos]``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shape, shards):
        self.mesh = mesh
        self.spec = spec
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def block(self, pos) -> Tuple[int, ...]:
        return tuple(_index(self.mesh, pos, axes)[0]
                     for axes in _entries(self.spec, len(self.shape)))

    def tensors(self):
        """The distinct shard tensors, in position order."""
        seen, out = set(), []
        for t in self.shards.flat:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """``fn`` applied to each distinct shard tensor; positions that
        shared a tensor share the result."""
        done: Dict[int, torch.Tensor] = {}
        shards = np.empty(self.shards.shape, object)
        for pos in self.mesh.positions():
            t = self.shards[pos]
            if id(t) not in done:
                done[id(t)] = fn(t)
            shards[pos] = done[id(t)]
        return Sharded(self.mesh, self.spec, self.shape, shards)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's),
        gathered from the blocks."""
        device = torch.device(device) if device is not None \
            else self.mesh.devices.flat[0]
        entries = _entries(self.spec, len(self.shape))
        counts = [_index(self.mesh, (0,) * self.mesh.devices.ndim, axes)[1]
                  for axes in entries]
        blocks = {}
        for pos in self.mesh.positions():
            blocks.setdefault(self.block(pos), self.shards[pos])

        def build(prefix: Tuple[int, ...]) -> torch.Tensor:
            dim = len(prefix)
            if dim == len(counts):
                return blocks[prefix].to(device)
            parts = [build(prefix + (i,)) for i in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        return build(())

    def local(self, pos, over: str = DATA_AXIS) -> torch.Tensor:
        """The tensor as position ``pos`` computes with it: the dims split
        over the mesh axis ``over`` gathered onto ``pos``'s device (the
        all-gather of FSDP), the other splits kept."""
        entries = _entries(self.spec, len(self.shape))
        dims = [d for d, axes in enumerate(entries) if over in axes]
        if not dims:
            return self.shards[pos]
        if len(dims) > 1 or entries[dims[0]] != (over,):
            raise NotImplementedError(
                f"local: {self.spec} splits a dim over {over} jointly")
        ax = self.mesh.axis_names.index(over)
        device = self.mesh.devices[pos]
        parts = []
        for i in range(self.mesh.devices.shape[ax]):
            p = list(pos)
            p[ax] = i
            parts.append(self.shards[tuple(p)].to(device))
        return torch.cat(parts, dims[0])

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, {self.spec}, "
                f"{self.mesh.shape})")


def device_put(x, sharding: NamedSharding) -> Sharded:
    """Lay ``x`` (a tensor or numpy array) out as ``sharding`` says: each
    position gets its block on its device.  A split dim must divide by its
    axes' size.  Blocks on the same device are one tensor (no copy when
    ``x`` is already there); a block is made contiguous."""
    if isinstance(x, Sharded):
        x = x.full()
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    mesh, spec = sharding.mesh, sharding.spec
    entries = _entries(spec, x.dim())
    shards = np.empty(mesh.devices.shape, object)
    made: Dict[Tuple, torch.Tensor] = {}
    for pos in mesh.positions():
        block = []
        for dim, axes in enumerate(entries):
            i, n = _index(mesh, pos, axes)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {axes} ({n})")
            block.append(i)
        key = (tuple(block), mesh.devices[pos])
        if key not in made:
            t = x
            for dim, axes in enumerate(entries):
                i, n = _index(mesh, pos, axes)
                if n > 1:
                    size = x.shape[dim] // n
                    t = t.narrow(dim, i * size, size)
            made[key] = t.contiguous().to(mesh.devices[pos])
        shards[pos] = made[key]
    return Sharded(mesh, spec, x.shape, shards)


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None,
              model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh.  ``devices`` defaults to every visible card,
    each once (raises without one); entries repeat only where the caller
    passes them so (``[cuda:0] * 4`` splits the work on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"{len(devices)} given")
    if data_parallel is None:
        data_parallel = max(1, n_devices // model_parallel)
    grid = np.empty(n_devices, object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(data_parallel, model_parallel),
                (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis split over data, the rest whole."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict; a state-dict key with dots
    adds each part to the path."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, depth first in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def shard_batch(mesh: Mesh, tree):
    """Every tensor leaf with its leading axis split over data."""
    sh = batch_sharding(mesh)
    return map_tree(lambda _, x: device_put(x, sh), tree)


def replicate_params(mesh: Mesh, params):
    sh = replicated(mesh)
    return map_tree(lambda _, x: device_put(x, sh), params)


def dino_tp_spec(path, leaf) -> PartitionSpec:
    """Megatron-style tensor-parallel layout for a ViT state-dict leaf, in
    the port's ``(out, in)`` Linear layout: QKV / MLP-in column-split
    (weight rows and bias), attention-out / MLP-out row-split (weight
    columns; the bias is added once, after the sum); everything else
    whole.  Matches the DINO tower (query/key/value, fc1/fc2) and the SAM
    encoder (qkv, lin1/lin2, proj) naming, as the JAX function does."""
    joined = "/".join(str(p) for p in path)
    column = any(k in joined for k in ("query", "key", "value", "fc1",
                                       "qkv", "lin1"))
    row = any(k in joined for k in ("out", "fc2", "lin2", "proj"))
    ndim = len(leaf.shape)
    if ndim == 2:
        if column:
            return P(MODEL_AXIS, None)
        if row:
            return P(None, MODEL_AXIS)
    if ndim == 1 and column and path and path[-1] == "bias":
        return P(MODEL_AXIS)
    return P()


def shard_params_tp(mesh: Mesh, params, subtrees=("dino",),
                    spec_fn=dino_tp_spec):
    """Lay a {name: state dict} tree out for tensor-parallel inference:
    leaves under the named top-level ``subtrees`` get ``spec_fn`` over the
    model axis (a split dim that does not divide by the axis size falls back
    to whole, as in JAX); everything else is replicated."""
    msize = mesh.shape[MODEL_AXIS]

    def place(path, leaf):
        spec = P()
        if path and path[0] in subtrees:
            spec = spec_fn(path[1:], leaf)
            for dim, entry in enumerate(spec):
                if entry is not None and leaf.shape[dim] % msize:
                    spec = P()
                    break
        return device_put(leaf, NamedSharding(mesh, spec))

    return {name: map_tree(lambda p, leaf, n=name: place((n,) + p, leaf),
                           sub)
            for name, sub in params.items()}


def pad_batch_to_multiple(tree, multiple: int) -> Tuple[Any, int]:
    """Pad every numpy leaf's leading dim with zeros to a multiple of
    ``multiple``.  Returns (padded tree, original batch)."""
    leaves = list(tree.values()) if isinstance(tree, dict) else [tree]
    if not leaves:
        return tree, 0
    b = leaves[0].shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return tree, b

    def pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, target - b)] + [(0, 0)] * (x.ndim - 1))
    if isinstance(tree, dict):
        return {k: pad(v) for k, v in tree.items()}, b
    return pad(tree), b


def replica_groups(tree):
    """Groups of distinct tensors that hold the same block of one leaf (on
    distinct devices): their gradients are summed across the group, the
    data-parallel all-reduce.  Empty when every replica shares a device."""
    groups = []
    for leaf in leaves(tree):
        by_block: Dict[Tuple, list] = {}
        for pos in leaf.mesh.positions():
            t = leaf.shards[pos]
            group = by_block.setdefault(leaf.block(pos), [])
            if all(t is not g for g in group):
                group.append(t)
        groups.extend(g for g in by_block.values() if len(g) > 1)
    return groups


@contextmanager
def mesh_context(mesh: Mesh):
    with mesh:
        yield mesh

