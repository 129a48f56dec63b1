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
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import torch


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
    None).  ``step(loss)`` back-propagates ``loss`` and updates."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-4,
                 max_norm: Optional[float] = None):
        self.params = list(params)
        self.max_norm = max_norm
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def step(self, loss: torch.Tensor) -> None:
        self.adamw.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            clip_by_global_norm([p.grad for p in self.params], self.max_norm)
        self.adamw.step()
