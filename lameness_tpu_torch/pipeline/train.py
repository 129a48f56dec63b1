"""The mesh train step for the lameness heads (port of
``lameness_tpu/pipeline/train.py``).

One step over a (data, model) mesh:
- **dp**: the clip batch is split over the ``data`` axis; each data row
  runs DINO, the TCN and the GaitTransformer on its own clips;
- **tp**: DINO's blocks are split over the ``model`` axis of each data row
  (``parallel/mesh.py`` ``dino_tp_spec``; ``models/dino.py``
  ``forward_tp``);
- the sequence heads are replicated (at 64-d width, splitting them would be
  all overhead);
- ``parallel/fsdp.py`` adds FSDP: the large leaves also split over
  ``data``, gathered onto each position that computes with them.

The shards' per-clip outputs meet on the first position's device, where
the loss is the global batch's: BCE of both heads' probabilities against
the labels, plus ``1e-4 · mean(emb²)`` on the DINO embeddings.  One
``backward()`` then gives every parameter shard its summed gradient on its
own device, and AdamW (``pipeline/optim.py``, optax's rule) updates the
shards in place.

DINO runs with ``use_kernel=False``: the step differentiates through its
attention, and kernel K1 has no backward (its wrapper refuses operands that
require grad; the JAX package's Pallas kernel has none either, and its
``make_models`` leaves ``use_pallas=None``, the plain path off the TPU).

Dropout: the step's ``generator`` draws the masks the whole batch would
draw on one device (TCN's first, then the GaitTransformer's); each data
shard takes its rows of those draws (``RowDraws``), so the step gives the
unsharded step's loss on any mesh.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models import dino as dino_mod
from ..models import sequence_features as seqf
from ..models.gait_transformer import GaitTransformer
from ..models.tcn import TCN
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, NamedSharding, P,
                             Sharded, device_put, dino_tp_spec, leaves,
                             map_tree, replica_groups)
from ..weights import seeded_state_dict
from .optim import Optimizer


class TrainState(NamedTuple):
    params: Any           # {"dino", "tcn", "gait"}: state-dict trees of Sharded
    opt_state: Any        # the Optimizer over the parameter shards
    step: int


def _dino_param_spec(path: Tuple, leaf) -> P:
    """Tensor-parallel layout of a DINO leaf (``dino_tp_spec``)."""
    return dino_tp_spec(path, leaf)


def make_models(hidden: int = 64, layers: int = 2, heads: int = 4,
                dino_patch: int = 14, device=None):
    """(DINO, TCN, GaitTransformer) on ``device`` (None: the card), DINO
    with the plain attention the step can differentiate."""
    dino = dino_mod.DinoV2(hidden_size=hidden, num_layers=layers,
                           num_heads=heads, patch_size=dino_patch,
                           pos_grid=4, ls_init=1.0, use_kernel=False,
                           device=device)
    tcn = TCN(input_dim=44, device=device)
    gait = GaitTransformer(input_dim=44, device=device)
    return dino, tcn, gait


def _param(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


def init_train_state(rng: Optional[torch.Generator], mesh: Mesh, models,
                     image_size: int = 56, lr: float = 1e-4
                     ) -> Tuple[TrainState, Any]:
    """The models' parameters laid out over ``mesh`` (DINO by
    ``dino_tp_spec``, the heads replicated) and AdamW over them.  ``rng``
    seeds the models' weights (``weights.seeded_state_dict``); None keeps
    the weights they have.  Returns (state, tx): ``tx(params, replicas=)``
    builds the optimiser (optax's ``adamw(lr)``: weight decay 1e-4)."""
    del image_size         # JAX's init traces the models at this size
    names = ("dino", "tcn", "gait")
    if rng is not None:
        for m in models:
            m.load_state_dict(seeded_state_dict(m, rng))
    tree = {name: {k: v.detach() for k, v in m.named_parameters()}
            for name, m in zip(names, models)}

    def place(path, leaf):
        spec = _dino_param_spec(path[1:], leaf) if path[0] == "dino" \
            else P()
        return device_put(leaf, NamedSharding(mesh, spec)).map(_param)
    params = map_tree(place, tree)
    tx = functools.partial(Optimizer, lr=lr)
    opt = tx([t for leaf in leaves(params) for t in leaf.tensors()],
             replicas=replica_groups(params))
    return TrainState(params, opt, 0), tx


class RowDraws:
    """A data shard's dropout draws: rows ``lo:hi`` of the uniforms the
    whole batch of ``batch`` clips draws from ``generator`` (``models/
    tcn.py`` ``dropout`` calls ``rand``).  Every dropout site's tensor has
    the batch leading, in ``groups`` blocks of the batch one after another
    (the engine's MC-dropout heads run ``groups`` = n_mc replicas of the
    batch as rows ``m·batch + i``): the shard's rows are ``lo:hi`` of
    each block."""

    def __init__(self, generator: torch.Generator, batch: int, lo: int,
                 hi: int, groups: int = 1):
        self.generator, self.batch, self.lo, self.hi = generator, batch, lo, hi
        self.groups = groups

    def rand(self, shape, device) -> torch.Tensor:
        rest = tuple(shape[1:])
        if shape[0] != self.groups * (self.hi - self.lo):
            raise ValueError(f"RowDraws: a draw of {tuple(shape)} for rows "
                             f"{self.lo}:{self.hi} of {self.groups} blocks")
        full = torch.rand((self.groups * self.batch,) + rest,
                          generator=self.generator, device=device)
        if self.groups == 1:
            return full[self.lo:self.hi]
        return full.view((self.groups, self.batch) + rest)[
            :, self.lo:self.hi].reshape(tuple(shape))


def _buffers(module: torch.nn.Module, device) -> Dict[str, torch.Tensor]:
    return {k: b.to(device) for k, b in module.named_buffers()}


def make_train_step(mesh: Mesh, models, tx, state_shardings=None):
    """(step, batch shardings).  ``step(state, batch, generator)`` ->
    (state, loss, metrics): the batch's leaves (numpy, tensors, or
    ``Sharded`` by ``batch_sharding``) split over data; ``generator`` the
    dropout draws (None: no dropout).  The state's shards are updated in
    place.  ``state_shardings`` (``parallel.fsdp.state_shardings``) pins
    the parameters' layout: the step raises if the state it gets or gives
    has another."""
    dino, tcn, gait = models
    dp = mesh.shape[DATA_AXIS]
    first = mesh.devices.flat[0]
    keys = ("frames", "seq_features", "seq_mask", "labels")
    batch_sharding = {k: NamedSharding(mesh, P(DATA_AXIS)) for k in keys}

    def loss_fn(params, batch, generator):
        b = batch["labels"].shape[0]
        per = b // dp
        embs, tcn_ps, gait_ps = [], [], []
        for d in range(dp):
            dev = mesh.devices[d, 0]
            frames, feats, mask = (batch[k].shards[d, 0] for k in
                                   ("frames", "seq_features", "seq_mask"))
            emb = dino_mod.forward_tp(
                dino, lambda key, m, d=d: params["dino"][key].local((d, m)),
                frames, list(mesh.devices[d]))["pooled"]
            draws = None
            if generator is not None:
                draws = generator
                if dp > 1:
                    g = torch.Generator(device=dev)
                    g.set_state(generator.get_state())
                    draws = RowDraws(g, b, d * per, (d + 1) * per)

            def local(name, module):
                return {**{k: v.local((d, 0)) for k, v in
                           params[name].items()}, **_buffers(module, dev)}
            tcn_ps.append(functional_call(
                tcn, local("tcn", tcn), (feats,),
                {"generator": draws})[:, 0].to(first))
            gait_ps.append(functional_call(
                gait, local("gait", gait), (feats, mask),
                {"generator": draws})["probability"][:, 0].to(first))
            embs.append(emb.to(first))
        if generator is not None and dp > 1:
            # the caller's generator moves on as the one-device step's does
            generator.set_state(draws.generator.get_state())
        labels = torch.cat([batch["labels"].shards[d, 0].to(first)
                            for d in range(dp)])
        emb, tcn_p, gait_p = (torch.cat(x) for x in (embs, tcn_ps, gait_ps))

        def bce(p):
            p = p.clamp(1e-6, 1 - 1e-6)
            return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
        loss = bce(tcn_p).mean() + bce(gait_p).mean() \
            + 1e-4 * (emb ** 2).mean()
        return loss, {"tcn_prob": tcn_p.mean(), "gait_prob": gait_p.mean(),
                      "emb_norm": torch.linalg.norm(emb, dim=-1).mean()}

    def check_layout(state, when: str) -> None:
        if state_shardings is None:
            return
        bad = sum(leaf.sharding != want or any(
            leaf.shards[pos].device != mesh.devices[pos]
            for pos in mesh.positions())
            for leaf, want in zip(leaves(state.params),
                                  leaves(state_shardings.params)))
        if bad:
            raise ValueError(f"train step {when}: {bad} parameter leaves "
                             f"are not laid out as state_shardings says")

    def train_step(state: TrainState, batch, generator=None):
        check_layout(state, "input")
        batch = {k: v if isinstance(v, Sharded)
                 else device_put(v, batch_sharding[k])
                 for k, v in batch.items()}
        loss, metrics = loss_fn(state.params, batch, generator)
        state.opt_state.step(loss)
        new = TrainState(state.params, state.opt_state, state.step + 1)
        check_layout(new, "output")
        return new, loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()}

    return train_step, batch_sharding


def make_batch(rng: np.random.Generator, batch: int, image_size: int = 56
               ) -> Dict[str, np.ndarray]:
    return {
        "frames": rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32),
        "seq_features": rng.standard_normal(
            (batch, seqf.TARGET_LEN, 44)).astype(np.float32),
        "seq_mask": np.zeros((batch, seqf.TARGET_LEN), bool),
        "labels": (rng.random(batch) < 0.5).astype(np.float32),
    }
