"""DINOv2 ViT (port of ``lameness_tpu/models/dino.py``).

ViT-B/14 by default (facebook/dinov2-base geometry): patch conv, cls token,
the 37x37 pretrain position grid resized bicubically to the input grid,
pre-norm blocks with layer scale, LayerNorm eps 1e-6, mean-pooled output.
Attention runs through ``ops.attention.flash_attention`` (kernel K1 on the
card).  Inputs are channels-last (B, H, W, 3), normalised.
``convert_hf_state_dict`` turns an HF ``Dinov2Model`` state dict into the
JAX package's flax tree (numpy leaves; ``weights.from_jax_params`` does the
rest).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.attention import flash_attention
from ..ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD, normalize,
                              resize_nhwc, to_float)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):                        # (B, H, S, hd) view, no copy
            return t.view(b, s, self.heads, hd).transpose(1, 2)
        o = flash_attention(split(self.query(x)), split(self.key(x)),
                            split(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 ls_init: float = 1.0):
        super().__init__()
        self.ls1 = nn.Parameter(torch.full((dim,), ls_init))
        self.ls2 = nn.Parameter(torch.full((dim,), ls_init))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1
        return x + self.mlp(self.norm2(x)) * self.ls2


class DinoV2(nn.Module):
    """forward(pixel_values (B, H, W, 3)) -> {"last_hidden_state"
    (B, 1+N, D), "pooled" (B, D)}."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 pos_grid: int = 37, mlp_ratio: int = 4,
                 ls_init: float = 1.0e-5, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.patch_embed = nn.Conv2d(3, hidden_size, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid ** 2, hidden_size))
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(hidden_size, num_heads,
                                               mlp_ratio, ls_init))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.to(resolve_device(device))

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, h, w, _ = pixel_values.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        d = self.hidden_size
        x = self.patch_embed(pixel_values.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                      # (B, N, D)
        pos_patch = self.pos_embed[:, 1:]
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            # bicubic; jax.image.resize antialiases this downscale (the
            # JAX comment says "no antialias", its code does) — matched
            g = self.pos_grid
            pos_patch = resize_nhwc(pos_patch.float().reshape(1, g, g, d),
                                    (gh, gw), mode="bicubic")
            pos_patch = pos_patch.reshape(1, gh * gw, d).to(x.dtype)
        x = x + pos_patch
        cls_tok = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, d)
        x = torch.cat([cls_tok, x], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x)
        return {"last_hidden_state": x, "pooled": x.mean(dim=1)}


def _lin(sd, prefix):
    return {"kernel": np.asarray(sd[prefix + ".weight"]).T,
            "bias": np.asarray(sd[prefix + ".bias"])}


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def convert_hf_state_dict(sd: Dict[str, Any], num_layers: int = 12) -> Dict:
    """An HF ``Dinov2Model.state_dict()`` (the 37x37+1 position grid) ->
    {"params": flax tree} with numpy leaves, as the JAX converter gives."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
          for k, v in sd.items()}
    p: Dict[str, Any] = {}
    p["patch_embed"] = {
        # torch conv OIHW -> flax HWIO
        "kernel": np.transpose(
            sd["embeddings.patch_embeddings.projection.weight"], (2, 3, 1, 0)),
        "bias": sd["embeddings.patch_embeddings.projection.bias"],
    }
    p["cls_token"] = sd["embeddings.cls_token"]
    p["pos_embed"] = sd["embeddings.position_embeddings"]
    for i in range(num_layers):
        t = f"encoder.layer.{i}"
        p[f"block{i}"] = {
            "norm1": _ln(sd, f"{t}.norm1"),
            "norm2": _ln(sd, f"{t}.norm2"),
            "ls1": sd[f"{t}.layer_scale1.lambda1"],
            "ls2": sd[f"{t}.layer_scale2.lambda1"],
            "attn": {
                "query": _lin(sd, f"{t}.attention.attention.query"),
                "key": _lin(sd, f"{t}.attention.attention.key"),
                "value": _lin(sd, f"{t}.attention.attention.value"),
                "out": _lin(sd, f"{t}.attention.output.dense"),
            },
            "mlp": {
                "fc1": _lin(sd, f"{t}.mlp.fc1"),
                "fc2": _lin(sd, f"{t}.mlp.fc2"),
            },
        }
    p["norm"] = _ln(sd, "layernorm")
    return {"params": p}


def preprocess_frames(frames: torch.Tensor) -> torch.Tensor:
    """HF BitImageProcessor path (``dinov3:107``): shortest edge to 256
    (bicubic), centre crop 224, ImageNet-normalise.  (B, H, W, 3)."""
    frames = to_float(frames)
    b, h, w, c = frames.shape
    if h < w:
        nh, nw = 256, max(1, int(round(w * 256 / h)))
    else:
        nh, nw = max(1, int(round(h * 256 / w))), 256
    frames = resize_nhwc(frames, (nh, nw), mode="bicubic")
    top, left = (nh - 224) // 2, (nw - 224) // 2
    frames = frames[:, top:top + 224, left:left + 224]
    return normalize(frames, IMAGENET_MEAN, IMAGENET_STD)
