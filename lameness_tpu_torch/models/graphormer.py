"""CowLamenessGraphormer (port of ``lameness_tpu/models/graphormer.py``):
input projection, centrality (degree embeddings) and temporal (sinusoidal
days) node encodings, 6 pre-LN layers of graph-biased multi-head attention
with SPD-bucket and edge-MLP biases and a virtual-node pass per layer, the
mean / virtual-node / attention-pool readout, and sigmoid graph and node
heads.

As in ``graphgps.py``, every activation carries a leading sample
dimension (MC-dropout is one forward over ``samples``, with masks from an
explicit ``torch.Generator``), and names mirror the flax tree.  The
attention is written as the JAX module writes it (matmul, bias, mask,
softmax, matmul): the runner ranks neighbours by the last layer's
probabilities, which a fused attention call does not return.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .graphgps import NEG_INF, LayerNorm
from .tcn import dropout


class BiasedMHA(nn.Module):
    """Multi-head attention with an additive (N, N, H) structural bias.
    q, k and v are flax ``DenseGeneral((heads, hd))``: Linear(D, H·hd)."""

    def __init__(self, dim: int = 128, heads: int = 8, rate: float = 0.1):
        super().__init__()
        self.heads = heads
        self.rate = rate
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, attention_bias, key_padding_mask, generator=None):
        """x (S, N, D); attention_bias (N, N, H); key_padding_mask (N,) True
        = padded -> (out (S, N, D), probabilities (S, H, N, N))."""
        s_, n, d = x.shape
        hd = d // self.heads
        q = self.q(x).view(s_, n, self.heads, hd)
        k = self.k(x).view(s_, n, self.heads, hd)
        v = self.v(x).view(s_, n, self.heads, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        s = s + attention_bias.permute(2, 0, 1)[None]
        s = torch.where(key_padding_mask[None, None, None, :], NEG_INF, s)
        p = dropout(torch.softmax(s, dim=-1), self.rate, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(s_, n, d)
        return dropout(self.out(out), self.rate, generator), p


class GraphormerLayer(nn.Module):
    def __init__(self, dim: int = 128, heads: int = 8, ffn_dim: int = 512,
                 rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.attn = BiasedMHA(dim, heads, rate)
        self.norm2 = LayerNorm(dim)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)

    def forward(self, x, attention_bias, key_padding_mask, generator=None):
        attn, probs = self.attn(self.norm1(x), attention_bias,
                                key_padding_mask, generator)
        x = x + attn
        h = F.gelu(self.ffn1(self.norm2(x)), approximate="tanh")
        h = dropout(h, self.rate, generator)
        h = dropout(self.ffn2(h), self.rate, generator)
        return x + h, probs


class VirtualNode(nn.Module):
    """Prepends a learnable virtual node, attends over [vn; nodes] and
    updates the virtual node through an MLP (attention.py:147-231), with the
    JAX module's residual on the real nodes."""

    def __init__(self, dim: int = 128, heads: int = 8, rate: float = 0.1):
        super().__init__()
        self.virtual_node = nn.Parameter(torch.randn(1, dim) * 0.02)
        self.attn = BiasedMHA(dim, heads, rate)
        self.vn_fc1 = nn.Linear(dim, dim * 2)
        self.vn_fc2 = nn.Linear(dim * 2, dim)
        self.vn_ln = LayerNorm(dim)

    def forward(self, x, attention_bias, key_padding_mask, generator=None):
        x_ext = torch.cat([self.virtual_node[None].expand(x.shape[0], -1, -1),
                           x], dim=1)
        ext_bias = F.pad(attention_bias, (0, 0, 1, 0, 1, 0))
        mask_ext = F.pad(key_padding_mask, (1, 0), value=False)
        out, _ = self.attn(x_ext, ext_bias, mask_ext, generator)
        x_out = x + out[:, 1:]
        h = F.gelu(self.vn_fc1(out[:, :1]), approximate="tanh")
        return x_out, self.vn_ln(self.vn_fc2(h))


class Readout(nn.Module):
    """Mean + virtual-node + attention pooling (layers.py:206-285)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.attn_fc1 = nn.Linear(dim, dim // 2)
        self.attn_fc2 = nn.Linear(dim // 2, 1)
        self.combine_fc = nn.Linear(dim * 3, dim)
        self.combine_ln = LayerNorm(dim)

    def forward(self, x, vn, node_mask):
        m = node_mask[None, :, None].to(x.dtype)
        mean_pool = (x * m).sum(dim=1, keepdim=True) / m.sum().clamp(min=1.0)
        a = self.attn_fc2(torch.tanh(self.attn_fc1(x)))
        w = torch.softmax(torch.where(node_mask[None, :, None], a, NEG_INF),
                          dim=1)
        attn_pool = (w * x).sum(dim=1, keepdim=True)
        combined = torch.cat([mean_pool, vn, attn_pool], dim=-1)
        return self.combine_ln(F.relu(self.combine_fc(combined)))


class CowLamenessGraphormer(nn.Module):
    def __init__(self, input_dim: int = 50, hidden_dim: int = 128,
                 num_layers: int = 6, heads: int = 8, ffn_dim: int = 512,
                 edge_dim: int = 3, dropout: float = 0.1,
                 max_degree: int = 50, max_spd: int = 10,
                 max_time_days: float = 365.0, device=None):
        super().__init__()
        self.rate = dropout
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.heads = heads
        self.max_degree = max_degree
        self.max_spd = max_spd
        self.max_time_days = max_time_days
        self.input_fc = nn.Linear(input_dim, hidden_dim)
        self.input_ln = LayerNorm(hidden_dim)
        self.degree_embed = nn.Parameter(
            torch.randn(max_degree + 1, hidden_dim) * 0.02)
        self.out_degree_embed = nn.Parameter(
            torch.randn(max_degree + 1, hidden_dim) * 0.02)
        self.time_proj = nn.Linear(hidden_dim, hidden_dim)
        self.spd_bias = nn.Parameter(torch.zeros(max_spd + 2, heads))
        self.edge_fc1 = nn.Linear(edge_dim, heads * 2)
        self.edge_fc2 = nn.Linear(heads * 2, heads)
        for i in range(num_layers):
            self.add_module(f"layer{i}", GraphormerLayer(
                hidden_dim, heads, ffn_dim, dropout))
            self.add_module(f"vnode{i}", VirtualNode(hidden_dim, heads,
                                                     dropout))
        self.final_norm = LayerNorm(hidden_dim)
        self.readout = Readout(hidden_dim)
        self.head_fc1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.head_fc2 = nn.Linear(hidden_dim // 2, hidden_dim // 4)
        self.head_fc3 = nn.Linear(hidden_dim // 4, 1)
        self.node_fc1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.node_fc2 = nn.Linear(hidden_dim // 2, 1)
        self.to(resolve_device(device))

    def temporal_encoding(self, timestamps, node_mask):
        """Sinusoids of the days since the earliest valid timestamp, in f32
        as in JAX (file mtimes: the f32 subtraction is part of the
        function)."""
        n, d = timestamps.shape[0], self.hidden_dim
        t0 = torch.where(node_mask, timestamps, math.inf).min()
        t0 = torch.where(torch.isfinite(t0), t0, 0.0)
        days = ((timestamps - t0) / 86400.0).clamp(0.0, self.max_time_days)
        div = torch.exp(torch.arange(0, d, 2, device=timestamps.device)
                        .float() * (-math.log(10000.0) / d))
        pe = torch.zeros(n, d, device=timestamps.device)
        pe[:, 0::2] = torch.sin(days[:, None] * div[None, :])
        pe[:, 1::2] = torch.cos(days[:, None] * div[None, :])
        return self.time_proj(pe)

    def forward(self, x, spd, edge_attr, edge_mask, degrees_in, degrees_out,
                timestamps, node_mask,
                generator: Optional[torch.Generator] = None,
                samples: int = 1) -> Dict[str, torch.Tensor]:
        """x (N, F); spd (N, N) int64 hop counts; edge_attr (N, N, 3);
        edge_mask (N, N) bool; degrees (N,) int64; timestamps (N,) f32
        seconds; node_mask (N,) bool -> graph_pred (S, 1, 1), node_pred (S,
        N, 1) and the last layer's attention_weights (S, H, N, N).  Dropout
        is on when a generator is given."""
        key_padding = ~node_mask
        h = self.input_ln(self.input_fc(x))[None].expand(samples, -1, -1)
        h = dropout(h, self.rate, generator)
        centrality = (
            self.degree_embed[degrees_in.clamp(0, self.max_degree)]
            + self.out_degree_embed[degrees_out.clamp(0, self.max_degree)])
        h = (h + centrality + self.temporal_encoding(timestamps, node_mask)) \
            * node_mask[:, None]

        spatial_bias = self.spd_bias[(spd + 1).clamp(0, self.max_spd + 1)]
        eb = self.edge_fc2(F.relu(self.edge_fc1(edge_attr)))
        bias = spatial_bias + eb * edge_mask[..., None]

        attn_probs = None
        for i in range(self.num_layers):
            h, attn_probs = getattr(self, f"layer{i}")(h, bias, key_padding,
                                                       generator)
            h, vn = getattr(self, f"vnode{i}")(h, bias, key_padding,
                                               generator)
        h = self.final_norm(h) * node_mask[:, None]
        g = self.readout(h, vn, node_mask)
        g = dropout(F.relu(self.head_fc1(g)), self.rate, generator)
        g = dropout(F.relu(self.head_fc2(g)), self.rate, generator)
        graph_pred = torch.sigmoid(self.head_fc3(g))
        n = dropout(F.relu(self.node_fc1(h)), self.rate, generator)
        node_pred = torch.sigmoid(self.node_fc2(n))
        return {"graph_pred": graph_pred, "node_pred": node_pred,
                "attention_weights": attn_probs}
