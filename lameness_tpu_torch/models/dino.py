"""DINOv2 ViT (port of ``lameness_tpu/models/dino.py``).

ViT-B/14 by default (facebook/dinov2-base geometry): patch conv, cls token,
the 37x37 pretrain position grid resized bicubically to the input grid,
pre-norm blocks with layer scale, LayerNorm eps 1e-6, mean-pooled output.
Attention runs through ``ops.attention.flash_attention`` (kernel K1 on the
card), or with ``use_kernel=False`` (JAX's ``use_pallas=False``) through
the plain ``reference_attention`` on any device, which autograd can
differentiate.  The block modules hold the parameters; ``forward_tp`` is
the one forward, over one model position (``DinoV2.forward``) or
tensor-parallel over a mesh's model axis.  Inputs are channels-last
(B, H, W, 3), normalised.  ``convert_hf_state_dict`` turns an HF
``Dinov2Model`` state dict into the JAX package's flax tree (numpy
leaves; ``weights.from_jax_params`` does the rest).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.attention import flash_attention, reference_attention
from ..ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD, normalize,
                              resize_nhwc, to_float)


class Mlp(nn.Module):
    """fc1 and fc2 (the parameters; ``forward_tp`` computes)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Attention over (B, H, S, hd) views: ``flash_attention`` (kernel K1 on
    CUDA tensors, its plain version on CPU tensors), or with ``use_kernel``
    False the plain ``reference_attention`` on any device (what autograd can
    differentiate: K1 has no backward)."""
    if use_kernel is False:
        return reference_attention(q, k, v)
    return flash_attention(q, k, v)


class Attention(nn.Module):
    """query, key, value and out (the parameters), the head count and the
    attention route (``attend``'s ``use_kernel``)."""

    def __init__(self, dim: int, heads: int,
                 use_kernel: Optional[bool] = None):
        super().__init__()
        self.heads = heads
        self.use_kernel = use_kernel
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)


class Block(nn.Module):
    """A pre-norm block's parameters: norm1, attn, ls1, norm2, mlp, ls2."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 ls_init: float = 1.0, use_kernel: Optional[bool] = None):
        super().__init__()
        self.ls1 = nn.Parameter(torch.full((dim,), ls_init))
        self.ls2 = nn.Parameter(torch.full((dim,), ls_init))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, use_kernel)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)


class DinoV2(nn.Module):
    """forward(pixel_values (B, H, W, 3)) -> {"last_hidden_state"
    (B, 1+N, D), "pooled" (B, D)}."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 pos_grid: int = 37, mlp_ratio: int = 4,
                 ls_init: float = 1.0e-5,
                 use_kernel: Optional[bool] = None, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.patch_embed = nn.Conv2d(3, hidden_size, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid ** 2, hidden_size))
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(hidden_size, num_heads,
                                               mlp_ratio, ls_init,
                                               use_kernel))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.to(resolve_device(device))

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        params = dict(self.named_parameters())
        return forward_tp(self, lambda key, m: params[key], pixel_values,
                          [pixel_values.device])

    def tokens(self, pixel_values, patch_w, patch_b, cls_token, pos_embed):
        """The patch tokens with positions and the cls token (B, 1+N, D)."""
        b, h, w, _ = pixel_values.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        d = self.hidden_size
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2), patch_w, patch_b,
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                      # (B, N, D)
        pos_patch = pos_embed[:, 1:]
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            # bicubic; jax.image.resize antialiases this downscale (the
            # JAX comment says "no antialias", its code does) — matched
            g = self.pos_grid
            pos_patch = resize_nhwc(pos_patch.float().reshape(1, g, g, d),
                                    (gh, gw), mode="bicubic")
            pos_patch = pos_patch.reshape(1, gh * gw, d).to(x.dtype)
        x = x + pos_patch
        cls_tok = (cls_token + pos_embed[:, :1]).expand(b, 1, d)
        return torch.cat([cls_tok, x], dim=1)


def forward_tp(model: DinoV2, weights: Callable[[str, int], torch.Tensor],
               pixel_values: torch.Tensor,
               devices: Sequence[torch.device]) -> Dict[str, torch.Tensor]:
    """The forward of ``model``'s geometry (its parameters as ``weights``
    gives them), with its blocks tensor-parallel over ``len(devices)`` model
    positions (Megatron layout, ``parallel/mesh.py`` ``dino_tp_spec``).
    ``weights(key, m)`` is the state-dict tensor ``key`` as position ``m``
    holds it, on ``devices[m]``: query/key/value and fc1 a block of rows
    (whole heads), out and fc2 a block of columns, the rest whole.  The
    residual stream stays on ``pixel_values``' device, which is
    ``devices[0]``; each block's normed input moves to every position, and
    the row-parallel partial sums move back and are added there before the
    bias (the all-reduce GSPMD inserts).  Each block's attention takes its
    ``Attention.use_kernel`` route.  With one position this is
    ``DinoV2.forward``."""
    tp = len(devices)
    heads = model.num_heads
    if heads % tp:
        raise ValueError(f"forward_tp: {heads} heads do not split over {tp}")
    hd = model.hidden_size // heads
    x = model.tokens(pixel_values, weights("patch_embed.weight", 0),
                     weights("patch_embed.bias", 0), weights("cls_token", 0),
                     weights("pos_embed", 0))
    b, s, d = x.shape

    def norm(t, name):
        return F.layer_norm(t, (d,), weights(name + ".weight", 0),
                            weights(name + ".bias", 0), 1e-6)

    def row_parallel(parts, name):
        if tp == 1:
            return parts[0]
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return total + weights(name + ".bias", 0)

    def linear(t, name, m, bias=True):
        return F.linear(t, weights(name + ".weight", m),
                        weights(name + ".bias", m) if bias else None)

    def split(t):                        # (B, heads / tp, S, hd) view
        return t.view(b, s, heads // tp, hd).transpose(1, 2)

    for i in range(model.num_layers):
        pre = f"block{i}."
        use_kernel = getattr(model, f"block{i}").attn.use_kernel
        h = norm(x, pre + "norm1")
        parts = []
        for m, dev in enumerate(devices):
            hm = h.to(dev)
            q, k, v = (split(linear(hm, pre + "attn." + n, m))
                       for n in ("query", "key", "value"))
            o = attend(q, k, v, use_kernel).transpose(1, 2).reshape(
                b, s, d // tp)
            parts.append(linear(o, pre + "attn.out", m, bias=tp == 1))
        x = x + row_parallel(parts, pre + "attn.out") * weights(pre + "ls1", 0)
        h = norm(x, pre + "norm2")
        parts = [linear(F.gelu(linear(h.to(dev), pre + "mlp.fc1", m)),
                        pre + "mlp.fc2", m, bias=tp == 1)
                 for m, dev in enumerate(devices)]
        x = x + row_parallel(parts, pre + "mlp.fc2") * weights(pre + "ls2", 0)
    x = norm(x, "norm")
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
