"""Gait Transformer lameness head (port of
``lameness_tpu/models/gait_transformer.py``): input projection,
sinusoidal positions, 4 pre-norm encoder layers (d=64, 4 heads, ffn 256,
tanh-GELU as flax's default), masked mean pool, sigmoid head, and the last
layer's head-averaged attention column sums as temporal saliency.

Dropout masks come from an explicit ``torch.Generator``; ``None`` is the
deterministic forward.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .tcn import dropout


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class MHA(nn.Module):
    """Self-attention returning head-averaged attention probabilities.
    ``qkv`` packs (3, heads, hd) in that order along its output."""

    def __init__(self, d_model: int, heads: int, rate: float):
        super().__init__()
        self.heads = heads
        self.rate = rate
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, key_padding_mask=None, generator=None):
        b, t, d = x.shape
        hd = d // self.heads
        qkv = self.qkv(x).view(b, t, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if key_padding_mask is not None:
            s = torch.where(key_padding_mask[:, None, None, :],
                            torch.full_like(s, -1e30), s)
        p = torch.softmax(s, dim=-1)
        p_drop = dropout(p, self.rate, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", p_drop, v).reshape(b, t, d)
        return self.out(out), p.mean(dim=1)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int = 64, heads: int = 4, ffn_dim: int = 256,
                 rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.mha = MHA(d_model, heads, rate)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn1 = nn.Linear(d_model, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x, key_padding_mask=None, generator=None):
        attn_out, attn = self.mha(self.norm1(x), key_padding_mask, generator)
        x = x + dropout(attn_out, self.rate, generator)
        h = F.gelu(self.ffn1(self.norm2(x)), approximate="tanh")
        h = dropout(h, self.rate, generator)
        h = dropout(self.ffn2(h), self.rate, generator)
        return x + h, attn


class GaitTransformer(nn.Module):
    def __init__(self, input_dim: int = 44, d_model: int = 64,
                 heads: int = 4, num_layers: int = 4, ffn_dim: int = 256,
                 dropout: float = 0.1, max_seq_len: int = 150, device=None):
        super().__init__()
        self.rate = dropout
        self.d_model = d_model
        self.heads = heads
        self.num_layers = num_layers
        self.input_projection = nn.Linear(input_dim, d_model)
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_pe(max_seq_len, d_model)), persistent=False)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, heads,
                                                      ffn_dim, dropout))
        self.final_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.fc1 = nn.Linear(d_model, 32)
        self.fc2 = nn.Linear(32, 1)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x (B, T, F), key_padding_mask (B, T) True = masked ->
        dict(probability (B, 1), pooled (B, d), saliency (B, T))."""
        t = x.shape[1]
        x = self.input_projection(x) + self.pe[None, :t]
        x = dropout(x, self.rate, generator)
        attn = None
        for i in range(self.num_layers):
            x, attn = getattr(self, f"layer{i}")(x, key_padding_mask,
                                                 generator)
        x = self.final_norm(x)
        if key_padding_mask is not None:
            keep = (~key_padding_mask)[..., None].to(x.dtype)
            pooled = (x * keep).sum(dim=1) / keep.sum(dim=1).clamp(min=1.0)
        else:
            pooled = x.mean(dim=1)
        h = dropout(F.relu(self.fc1(pooled)), self.rate, generator)
        prob = torch.sigmoid(self.fc2(h))
        return {"probability": prob, "pooled": pooled,
                "saliency": attn.sum(dim=1)}
