"""The trainers' optimiser rule: optax's ``chain(clip_by_global_norm(c),
adamw(lr, weight_decay))`` in PyTorch.

- ``torch.optim.AdamW`` with optax's defaults written out: betas (0.9,
  0.999), eps 1e-8 (added to the bias-corrected root, as optax does) and
  weight decay 1e-4 (torch's own default, 1e-2, is not optax's).  Decay
  and update are optax's ``p - lr·(adam + wd·p)``, in torch's order.
- :func:`clip_by_global_norm` is optax's formula: every gradient times
  ``c / norm`` where the global norm reaches ``c``, with no ``+1e-6`` (the
  difference from ``torch.nn.utils.clip_grad_norm_``).
- The rule covers a module's parameters, which are exactly the leaves of
  the JAX package's flax tree (YOLO's batch-norm ``scale``, ``bias``,
  ``mean`` and ``var`` are parameters on both sides, so all four are
  trained and decayed; buffers such as GaitTransformer's ``pe`` are not).
  A parameter that got no gradient gets a zero one: optax still decays it.
- ``lr`` is a number or, as optax's ``learning_rate``, a schedule: a
  function of the count of updates made before this one (0 for the first)
  that gives the step's rate, which scales the decay too.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    L2 norm is at least ``max_norm``; returns the norm (a device scalar:
    nothing waits for the card)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, weight_decay=
    weight_decay))`` over ``params`` (no clipping when ``max_norm`` is
    None).  ``step(loss)`` back-propagates ``loss`` and updates.

    ``replicas``: groups of tensors in ``params`` that are copies of one
    parameter on distinct devices (a mesh's data-parallel replicas,
    ``parallel/mesh.py`` ``replica_groups``).  Each group's gradients are
    summed into every member before the update (the all-reduce), and the
    global norm counts each group once, so the copies stay equal.
    ``count``: the updates already made, the schedule's place (a state
    moved to another layout keeps it)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LearningRate,
                 weight_decay: float = 1e-4,
                 max_norm: Optional[float] = None,
                 replicas: Sequence[Sequence[torch.Tensor]] = (),
                 count: int = 0):
        self.params = list(params)
        self.lr = lr
        self.count = count
        self.max_norm = max_norm
        self.replicas = [list(g) for g in replicas]
        self.adamw = torch.optim.AdamW(self.params, lr=self._rate(),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def _rate(self) -> float:
        return float(self.lr(self.count)) if callable(self.lr) else self.lr

    def step(self, loss: torch.Tensor) -> None:
        self.adamw.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.replicas:           # the all-reduce
            total = group[0].grad
            for p in group[1:]:
                total = total + p.grad.to(total.device)
            for p in group:
                p.grad = total.to(p.device)
        if self.max_norm is not None:
            copies = {id(p) for g in self.replicas for p in g[1:]}
            clip_by_global_norm([p.grad for p in self.params
                                 if id(p) not in copies], self.max_norm)
            for g in self.replicas:
                for p in g[1:]:
                    p.grad = g[0].grad.to(p.device)
        for group in self.adamw.param_groups:
            group["lr"] = self._rate()
        self.adamw.step()
        self.count += 1
