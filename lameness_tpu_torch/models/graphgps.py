"""EnhancedGraphGPS lameness head (port of ``lameness_tpu/models/graphgps.py``):
input projection reserving PE channels, learned Laplacian and random-walk
PEs, GatedGCN local message passing with edge gating, 8-head global
attention, GPS layers with the reference's residual wiring, SAGPool and the
multi-scale readout, and the attention-weighted prediction head.

The graph is dense and padded, (N, N) adjacency with node and edge masks,
as in JAX.  Every activation carries a leading sample dimension: the
deterministic forward has one sample, MC-dropout ``samples`` of them in one
forward (the JAX runner's ``vmap`` over 10 keys), with dropout masks drawn
from an explicit ``torch.Generator``.  Module and parameter names mirror
the flax tree (``weights.from_jax_params`` converts by structure);
``InferenceBN`` keeps its running statistics as the leaves
``scale``/``bias``/``mean``/``var``.  LayerNorm follows flax's (eps 1e-6,
one-pass variance) and GELU is its tanh approximation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .tcn import dropout

NEG_INF = -1e30


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``'s arithmetic: eps 1e-6 and the one-pass
    variance max(E[x²] - E[x]², 0).  ``nn.LayerNorm``'s two-pass variance
    rounds otherwise, and over Graphormer's 12 attention passes that puts
    its node predictions 3x further from JAX's (6e-6 against 2e-6 on a
    16-node test graph)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias




class InferenceBN(nn.Module):
    """BatchNorm1d at eval time: running stats stored as parameters."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return ((x - self.mean) * torch.rsqrt(self.var + self.eps)
                * self.scale + self.bias)


class PETransform(nn.Module):
    """Linear -> ReLU -> Linear -> LN over raw PE columns (gnn:242-247)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim * 2)
        self.fc2 = nn.Linear(hidden_dim * 2, hidden_dim)
        self.ln = LayerNorm(hidden_dim)

    def forward(self, pe_raw):
        return self.ln(self.fc2(F.relu(self.fc1(pe_raw))))


class EdgeEncoder(nn.Module):
    """(N, N, 3) raw edge attrs -> (N, N, D) (gnn:387-412)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim // 2)
        self.fc2 = nn.Linear(hidden_dim // 2, hidden_dim)
        self.ln = LayerNorm(hidden_dim)

    def forward(self, edge_attr):
        return self.ln(self.fc2(F.relu(self.fc1(edge_attr))))


class GatedGCN(nn.Module):
    """Dense masked GatedGCN with edge gating and edge update (gnn:419-496).
    Edge axes are (src, dst): e[b, i, j] is the edge i -> j of sample b."""

    def __init__(self, dim: int, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        for name in ("A", "B", "D", "E", "C"):
            self.add_module(name, nn.Linear(dim, dim))
        self.bn_node = InferenceBN(dim)
        self.edge_fc1 = nn.Linear(3 * dim, dim)
        self.edge_fc2 = nn.Linear(dim, dim)
        self.bn_edge = InferenceBN(dim)

    def forward(self, x, edge_feat, edge_mask, node_mask, generator=None):
        """x (S, N, D); edge_feat (S or 1, N, N, D); edge_mask (S or 1, N,
        N) bool; node_mask (S or 1, N) bool."""
        ax, bx, dx, ex = self.A(x), self.B(x), self.D(x), self.E(x)
        ce = self.C(edge_feat)
        gate = torch.sigmoid(ce + dx[:, None, :, :] + ex[:, :, None, :])
        em = edge_mask[..., None].to(x.dtype)
        msg = gate * bx[:, :, None, :] * em           # message src -> dst
        agg = msg.sum(dim=1)                          # (S, N_dst, D)
        deg = edge_mask.sum(dim=1).clamp(min=1)[..., None].to(x.dtype)
        h = ax + agg / deg
        h = dropout(F.relu(self.bn_node(h)), self.rate, generator)
        edge_in = torch.cat([dx[:, None, :, :].expand_as(gate),
                             ex[:, :, None, :].expand_as(gate),
                             ce.expand_as(gate)], dim=-1)
        e_new = self.edge_fc2(F.relu(self.edge_fc1(edge_in)))
        e_new = self.bn_edge(e_new) * em
        return h * node_mask[..., None], e_new


class GlobalAttention(nn.Module):
    """Masked multi-head self-attention with post-norm residual
    (gnn:499-561); ``qkv`` packs (3, heads, hd) along its output."""

    def __init__(self, dim: int, heads: int = 8, rate: float = 0.1):
        super().__init__()
        self.heads = heads
        self.rate = rate
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)
        self.norm = LayerNorm(dim)

    def forward(self, x, node_mask, generator=None):
        s_, n, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).view(s_, n, 3, self.heads, hd).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = torch.where(node_mask[:, None, None, :], s, NEG_INF)
        p = dropout(torch.softmax(s, dim=-1), self.rate, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(s_, n, d)
        out = dropout(self.out(out), self.rate, generator)
        return self.norm(x + out) * node_mask[..., None]


class GPSLayer(nn.Module):
    """Local GatedGCN + global attention + FFN with the reference's
    residual pattern (gnn:603-623)."""

    def __init__(self, dim: int, heads: int = 8, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.local = GatedGCN(dim, rate)
        self.norm2 = LayerNorm(dim)
        self.add_module("global", GlobalAttention(dim, heads, rate))
        self.norm3 = LayerNorm(dim)
        self.ffn1 = nn.Linear(dim, dim * 4)
        self.ffn2 = nn.Linear(dim * 4, dim)

    def forward(self, x, edge_feat, edge_mask, node_mask, generator=None):
        h_local, e_new = self.local(self.norm1(x), edge_feat, edge_mask,
                                    node_mask, generator)
        x = x + h_local
        xn = self.norm2(x)
        h_global = getattr(self, "global")(xn, node_mask, generator)
        x = x + (h_global - xn)        # reference's residual form (gnn:617)
        h = F.gelu(self.ffn1(self.norm3(x)), approximate="tanh")
        h = dropout(h, self.rate, generator)
        h = dropout(self.ffn2(h), self.rate, generator)
        return (x + h) * node_mask[..., None], e_new


class SAGPool(nn.Module):
    """Dense SAGPooling: GraphConv node scores, keep the top ``ratio`` of the
    valid nodes (ranks by stable sorts, as ``jnp.argsort``), kept features
    times tanh(score) (gnn:630-677).  Returns the pooled features, the
    pooled edge mask and the kept-node mask, per sample."""

    def __init__(self, dim: int, ratio: float = 0.5):
        super().__init__()
        self.ratio = ratio
        self.w_self = nn.Linear(dim, 1)
        self.w_nbr = nn.Linear(dim, 1, bias=False)
        self.proj_fc = nn.Linear(dim, dim)
        self.proj_ln = LayerNorm(dim)

    def forward(self, x, edge_mask, node_mask):
        em = edge_mask.to(x.dtype)
        agg = em.transpose(-1, -2) @ self.w_nbr(x)    # sum over incoming src
        score = (self.w_self(x) + agg).squeeze(-1)
        score = torch.where(node_mask, score, NEG_INF)
        n_keep = torch.ceil(self.ratio * node_mask.sum(dim=-1).float())
        order = torch.argsort(-score, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        keep = (rank < n_keep[:, None]) & node_mask
        gated = x * torch.tanh(score)[..., None] * keep[..., None]
        h = self.proj_ln(F.relu(self.proj_fc(gated))) * keep[..., None]
        return h, edge_mask & keep[:, :, None] & keep[:, None, :], keep


def masked_mean(x, mask):
    """x (S, N, D), mask (S or 1, N) -> (S, D)."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


class MultiScaleReadout(nn.Module):
    """Attention-weighted combination of per-scale mean pools (gnn:680-738)."""

    def __init__(self, dim: int, num_scales: int = 2):
        super().__init__()
        self.attn_fc1 = nn.Linear(dim * num_scales, dim)
        self.attn_fc2 = nn.Linear(dim, num_scales)
        self.out_fc = nn.Linear(dim, dim)
        self.out_ln = LayerNorm(dim)

    def forward(self, reps):
        pools = [masked_mean(x, m) for x, m in reps]
        w = self.attn_fc2(F.relu(self.attn_fc1(torch.cat(pools, dim=-1))))
        w = torch.softmax(w, dim=-1)
        mixed = sum(w[:, i:i + 1] * p for i, p in enumerate(pools))
        return self.out_ln(F.relu(self.out_fc(mixed)))


class PredictionHead(nn.Module):
    """Attention-weighted + mean pooling head (gnn:745-832)."""

    def __init__(self, dim: int, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.attn_fc1 = nn.Linear(dim, dim // 2)
        self.attn_fc2 = nn.Linear(dim // 2, 1)
        self.cls_fc1 = nn.Linear(dim * 2, dim)
        self.cls_fc2 = nn.Linear(dim, dim // 2)
        self.cls_fc3 = nn.Linear(dim // 2, 1)
        self.node_fc1 = nn.Linear(dim, dim // 2)
        self.node_fc2 = nn.Linear(dim // 2, 1)

    def forward(self, x, node_mask, generator=None):
        a = self.attn_fc2(torch.tanh(self.attn_fc1(x))).squeeze(-1)
        attn = torch.softmax(torch.where(node_mask, a, NEG_INF), dim=-1)
        weighted_pool = (x * attn[..., None]).sum(dim=1)
        g = torch.cat([masked_mean(x, node_mask), weighted_pool], dim=-1)
        h = dropout(F.relu(self.cls_fc1(g)), self.rate, generator)
        h = dropout(F.relu(self.cls_fc2(h)), self.rate, generator)
        graph_pred = torch.sigmoid(self.cls_fc3(h))
        n = dropout(F.relu(self.node_fc1(x)), self.rate, generator)
        node_pred = torch.sigmoid(self.node_fc2(n))
        return {"graph_pred": graph_pred, "node_pred": node_pred,
                "attention_weights": attn}


class EnhancedGraphGPS(nn.Module):
    def __init__(self, input_dim: int = 50, hidden_dim: int = 128,
                 num_layers: int = 4, heads: int = 8, dropout: float = 0.1,
                 pe_dim: int = 16, pooling_ratio: float = 0.5,
                 lap_dim: int = 8, rw_dim: int = 16, edge_dim: int = 3,
                 device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.heads = heads
        self.input_proj = nn.Linear(input_dim, hidden_dim - 2 * pe_dim)
        self.lap_pe = PETransform(lap_dim, pe_dim)
        self.rw_pe = PETransform(rw_dim, pe_dim)
        self.edge_encoder = EdgeEncoder(edge_dim, hidden_dim)
        self.n_pre = num_layers // 2
        for i in range(self.n_pre):
            self.add_module(f"pre{i}", GPSLayer(hidden_dim, heads, dropout))
        self.pool = SAGPool(hidden_dim, pooling_ratio)
        for i in range(num_layers - self.n_pre):
            self.add_module(f"post{i}", GPSLayer(hidden_dim, heads, dropout))
        self.ms_readout = MultiScaleReadout(hidden_dim, 2)
        self.final_norm = LayerNorm(hidden_dim)
        self.pred_head = PredictionHead(hidden_dim, dropout)
        self.to(resolve_device(device))

    def forward(self, x, lap_pe_raw, rw_pe_raw, edge_attr, edge_mask,
                node_mask, generator: Optional[torch.Generator] = None,
                samples: int = 1) -> Dict[str, torch.Tensor]:
        """x (N, 50); lap_pe_raw (N, 8); rw_pe_raw (N, 16); edge_attr (N, N,
        3); edge_mask (N, N) bool; node_mask (N,) bool -> every output with a
        leading dimension of ``samples``: graph_pred (S, 1), node_pred (S, N,
        1), attention_weights (S, N), multi_scale_repr (S, D).  Dropout is on
        when a generator is given."""
        node_mask, edge_mask = node_mask[None], edge_mask[None]
        pe = torch.cat([self.lap_pe(lap_pe_raw.abs()),
                        self.rw_pe(rw_pe_raw)], dim=-1)
        h = torch.cat([self.input_proj(x), pe], dim=-1)[None] \
            * node_mask[..., None]
        h = h.expand(samples, -1, -1)
        e = self.edge_encoder(edge_attr)[None] * edge_mask[..., None]
        for i in range(self.n_pre):
            h, e = getattr(self, f"pre{i}")(h, e, edge_mask, node_mask,
                                            generator)
        reps = [(h, node_mask)]
        hp, em_p, keep = self.pool(h, edge_mask, node_mask)
        ep = e * em_p[..., None]
        for i in range(self.num_layers - self.n_pre):
            hp, ep = getattr(self, f"post{i}")(hp, ep, em_p, keep, generator)
        reps.append((hp, keep))
        # reference only pools graphs with > 3 nodes (gnn:935)
        readout_pooled = self.ms_readout(reps)
        use_pool = node_mask.sum() > 3
        h = self.final_norm(h) * node_mask[..., None]
        out = self.pred_head(h, node_mask, generator)
        out["multi_scale_repr"] = torch.where(
            use_pool, readout_pooled, torch.zeros_like(readout_pooled))
        return out
