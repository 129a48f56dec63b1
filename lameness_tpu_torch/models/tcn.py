"""Temporal Convolutional Network lameness head (port of
``lameness_tpu/models/tcn.py``): 4 blocks of two weight-normalised causal
dilated conv1ds (64 ch, k=3, dilation 2^i), residuals, mean pool, sigmoid.

Dropout draws its masks from an explicit ``torch.Generator`` (the JAX
module takes a dropout rng); ``generator=None`` is the deterministic
forward.  Inputs are (B, T, F) as in the JAX package.  ``mc_dropout`` and
``predict_with_uncertainty`` run n MC-dropout samples as one batched
forward of n replicas of the batch.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout semantics: keep with prob 1-rate, scale 1/(1-rate);
    identity when ``generator`` is None (deterministic) or rate is 0.  A
    ``generator`` with a ``rand(shape, device)`` method draws the uniforms
    itself (``pipeline/train.py`` ``RowDraws``: a data shard's rows of the
    whole batch's draw)."""
    if generator is None or rate == 0.0:
        return x
    draw = getattr(generator, "rand", None)
    u = draw(x.shape, x.device) if draw is not None else \
        torch.rand(x.shape, generator=generator, device=x.device)
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class CausalConv1d(nn.Module):
    """Weight-normalised causal conv over (B, C, T): the norm runs over
    (in, k) per output channel (+1e-12), with left padding."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.v = nn.Parameter(torch.empty(cout, cin, kernel_size))
        self.g = nn.Parameter(torch.ones(cout))
        self.b = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_normal_(self.v)

    def forward(self, x):
        norm = torch.sqrt((self.v ** 2).sum(dim=(1, 2), keepdim=True)
                          + 1e-12)
        w = self.v / norm * self.g[:, None, None]
        x = F.pad(x, ((self.kernel_size - 1) * self.dilation, 0))
        return F.conv1d(x, w, self.b, dilation=self.dilation)


class TemporalBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 dilation: int = 1, rate: float = 0.2):
        super().__init__()
        self.rate = rate
        self.conv1 = CausalConv1d(cin, cout, kernel_size, dilation)
        self.conv2 = CausalConv1d(cout, cout, kernel_size, dilation)
        self.residual = nn.Linear(cin, cout) if cin != cout else None

    def forward(self, x, generator=None):            # (B, C, T)
        h = dropout(F.relu(self.conv1(x)), self.rate, generator)
        h = dropout(F.relu(self.conv2(h)), self.rate, generator)
        if self.residual is not None:
            x = self.residual(x.transpose(1, 2)).transpose(1, 2)
        return F.relu(h + x)


class TCN(nn.Module):
    def __init__(self, input_dim: int = 44,
                 channels: Sequence[int] = (64, 64, 64, 64),
                 kernel_size: int = 3, dropout: float = 0.2, device=None):
        super().__init__()
        self.rate = dropout
        self.num_blocks = len(channels)
        self.kernel_size = kernel_size
        cin = input_dim
        for i, ch in enumerate(channels):
            self.add_module(f"block{i}", TemporalBlock(
                cin, ch, kernel_size, 2 ** i, dropout))
            cin = ch
        self.fc1 = nn.Linear(cin, 32)
        self.fc2 = nn.Linear(32, 1)
        self.to(resolve_device(device))

    @property
    def receptive_field(self) -> int:
        rf = 1
        for i in range(self.num_blocks):
            rf += 2 * (self.kernel_size - 1) * (2 ** i)
        return rf

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, F) -> probability (B, 1); dropout on when a generator
        is given."""
        x = x.transpose(1, 2)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, generator)
        x = F.relu(self.fc1(x.mean(dim=2)))
        x = dropout(x, self.rate, generator)
        return torch.sigmoid(self.fc2(x))


def mc_dropout(fn: Callable, x: Union[torch.Tensor, Sequence[torch.Tensor]],
               generator: torch.Generator, n_samples: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MC dropout as ONE batched forward (as the engine's heads run it):
    each input of ``x`` (batch leading) repeated ``n_samples`` times along
    the batch, ``fn(*inputs, generator=generator) -> (n·B, 1)`` with
    dropout on, row m·B + i sample m of clip i.  Returns (mean, std) over
    the samples, (B, 1) each; std with ddof 1 (torch.std's unbiased
    default, reference tcn:192)."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    b = xs[0].shape[0]
    reps = [t.repeat((n_samples,) + (1,) * (t.dim() - 1)) for t in xs]
    preds = fn(*reps, generator=generator)
    preds = preds.reshape((n_samples, b) + tuple(preds.shape[1:]))
    return preds.mean(dim=0), preds.std(dim=0)


def predict_with_uncertainty(model: nn.Module, x: torch.Tensor,
                             generator: torch.Generator, n_samples: int = 10,
                             **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mc_dropout`` of a head whose forward returns the probability (the
    TCN): ``model(x, **kwargs, generator=...)`` over n_samples replicas."""
    return mc_dropout(lambda xs, generator: model(xs, generator=generator,
                                                  **kwargs),
                      x, generator, n_samples)
