"""SAM (Segment Anything), box-prompted masks (port of
``lameness_tpu/models/sam.py``): the ViTDet image encoder (windowed and
global attention with decomposed relative positions), the box prompt
encoder and the two-way-transformer mask decoder.

Channels-last at the public functions, as in the JAX package.  By default
the encoder's windowed layers run kernel K2 and its global layers kernel K3
on the card; the JAX package's switches select K4-K9 instead
(:class:`VisionAttention`, ``ops/sam_attention.py``).  The decoder's small
attentions stay plain PyTorch, as they are plain jnp in the JAX package.
Parameter names mirror the flax tree, so ``weights.from_jax_params``
converts one to one.  ``convert_hf_state_dict`` (HF ``SamModel``) and
``convert_sa_state_dict`` (segment-anything ``.pth``) give the JAX
package's flax tree with numpy leaves, as its converters do.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops import sam_attention as sa


def _promote(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """jnp type promotion for a product of x and a weight (bf16 with f32
    computes in f32) — torch refuses mixed dtypes instead."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over the last axis of NHWC (SAM's LayerNorm2d):
    stats in f32, output in the promoted dtype of f32 and the weights."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
        x32 = (x32 - mean) / torch.sqrt(var + self.eps)
        return x32 * self.weight + self.bias


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class VisionAttention(nn.Module):
    """x (B, H, W, C) -> (B, H, W, C).  ``input_size`` is the rel-pos table
    grid; smaller runtime grids centre-slice the tables (exact, no
    interpolation).  The kernel follows ``lameness_tpu/models/sam.py``'s
    fused paths and its switches, read at each call:

    - a window (H == W == input_size <= 16): ``LAMENESS_WIN_KERNEL``
      (default ``v3``) ``v3`` takes K2 and ``v5`` K9 on head-last views of
      the qkv output, unless hd + 2·H > 128 (the TPU's one 128-lane group
      per head), which falls back to ``v1``; any other value takes the
      head-major :func:`sam_window_attention` (K8 for ``v2``, else K7);
    - any other grid: ``LAMENESS_GLB_KERNEL=v3`` with hd + H <= 128 takes K6
      on head-last views; anything else the head-major
      :func:`sam_global_attention` (K3 by default, K4 for ``v1``, K5 for
      any other value, ``v3`` with hd + H > 128 included)."""

    def __init__(self, dim: int, heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.input_size = tuple(input_size)
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd = self.heads, self.dim // self.heads
        qkv = self.qkv(x.reshape(b, h * w, c)).view(b, h * w, 3, nh, hd)
        q, k, v = qkv.unbind(2)                       # (B, N, nH, hd) views
        sh, sw = self.input_size
        if h > sh or w > sw:
            raise ValueError(f"grid {(h, w)} exceeds the rel-pos tables "
                             f"{self.input_size}")
        rel_h = self.rel_pos_h[sh - h:sh + h - 1]
        rel_w = self.rel_pos_w[sw - w:sw + w - 1]
        if h == w == sh and h <= 16:
            win_kernel = os.environ.get("LAMENESS_WIN_KERNEL", "v3")
            if hd + 2 * h > 128 and win_kernel in ("v3", "v5"):
                win_kernel = "v1"
            if win_kernel in ("v3", "v5"):
                rh4, rw4 = sa.project_rel_tables_hl(q, rel_h, rel_w, h)
                fn = sa.sam_window_attention_v5 if win_kernel == "v5" \
                    else sa.sam_window_attention_v3
                out = fn(q, k, v, rh4, rw4)
                return self.proj(out.view(b, h, w, self.dim))
            qf = q.permute(0, 2, 1, 3).reshape(b * nh, h * w, hd)
            rh, rw = sa.project_rel_tables(qf, rel_h, rel_w, h)
            # (B, nH, N, hd) views of the qkv output, read in place
            of = sa.sam_window_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                rh.reshape(b, nh, h * w, h), rw.reshape(b, nh, h * w, h))
            out = of.transpose(1, 2)                  # (B, N, nH, hd)
            return self.proj(out.reshape(b, h, w, self.dim))
        if os.environ.get("LAMENESS_GLB_KERNEL") == "v3" and hd + h <= 128:
            rh4, rw4 = sa.project_rel_tables_hl(q, rel_h, rel_w, h, w)
            out = sa.sam_global_attention_v3(q, k, v, rh4, rw4)
            return self.proj(out.view(b, h, w, self.dim))

        def heads_first(t):
            return t.permute(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
        rh, rw = sa.project_rel_tables(qf, rel_h, rel_w, h, w)
        of = sa.sam_global_attention(qf, kf, vf, rh, rw)
        out = of.view(b, nh, h * w, hd).permute(0, 2, 1, 3)
        return self.proj(out.reshape(b, h, w, self.dim))


def window_partition(x: torch.Tensor, win: int):
    """(B, H, W, C) -> (B·nW, win, win, C), plus the padded (Hp, Wp).  The
    pad is zeros before the qkv projection, so pad tokens carry the qkv
    bias and join the attention unmasked, as in the reference ViTDet."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % win, (-w) % win
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x: torch.Tensor, win: int, padded_hw, orig_hw):
    hp, wp = padded_hw
    h, w = orig_hw
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.view(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class VisionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 window_size: int, global_input_size: Tuple[int, int]):
        super().__init__()
        self.window_size = window_size
        size = (window_size, window_size) if window_size > 0 \
            else global_input_size
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = VisionAttention(dim, heads, size)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        h = self.ln1(x)
        if self.window_size > 0:
            orig_hw = (h.shape[1], h.shape[2])
            h, padded = window_partition(h, self.window_size)
            h = self.attn(h)
            h = window_unpartition(h, self.window_size, padded, orig_hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.ln2(x))


class SamVisionEncoder(nn.Module):
    """ViTDet encoder: (B, 1024, 1024, 3) -> (B, 64, 64, 256)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.depth = depth
        self.window_size = window_size
        self.global_attn_indexes = tuple(global_attn_indexes)
        g = img_size // patch_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        for i in range(depth):
            win = 0 if i in self.global_attn_indexes else window_size
            self.add_module(f"layer{i}", VisionLayer(dim, heads, mlp_ratio,
                                                     win, (g, g)))
        self.neck_conv1 = nn.Conv2d(dim, out_chans, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(out_chans)
        self.neck_conv2 = nn.Conv2d(out_chans, out_chans, 3, padding=1,
                                    bias=False)
        self.neck_ln2 = LayerNorm2d(out_chans)

    def forward(self, x: torch.Tensor, content_rows: int = 0):
        """x (B, H, W, 3) normalised.  ``content_rows`` > 0 marks a
        bottom-padded square canvas whose token rows past it hold no image:
        they are identical across the batch (zero pixels), so before the
        first global layer whole pad window-rows are computed once and
        broadcast — the same per-window math (bit-exact in the JAX
        package), on fewer windows."""
        g = self.img_size // self.patch_size
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        gh, gw = x.shape[1], x.shape[2]
        pos = self.pos_embed if (gh, gw) == (g, g) \
            else self.pos_embed[:, :gh, :gw]
        x = x + pos
        first_global = min(self.global_attn_indexes) \
            if self.global_attn_indexes else self.depth
        for i in range(self.depth):
            layer = getattr(self, f"layer{i}")
            win = layer.window_size
            split = 0
            if (win and content_rows and i < first_global
                    and (gh, gw) == (g, g) and x.shape[0] > 1):
                split = -(-content_rows // win) * win
            if split and split < gh:
                xc = layer(x[:, :split])
                xp = layer(x[:1, split:])         # image-independent rows
                x = torch.cat([xc, xp.expand((x.shape[0],) + xp.shape[1:])],
                              dim=1)
            else:
                x = layer(x)

        def conv(t, m: nn.Conv2d, padding: int):
            t, w = _promote(t, m.weight)
            y = F.conv2d(t.permute(0, 3, 1, 2), w, padding=padding)
            return y.permute(0, 2, 3, 1)
        x = self.neck_ln1(conv(x, self.neck_conv1, 0))
        return self.neck_ln2(conv(x, self.neck_conv2, 1))


class SamPositionalEmbedding(nn.Module):
    """Random-Fourier positional encoding shared by prompt encoder and
    decoder."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(2,
                                                             num_pos_feats))

    def forward(self, coords):                      # (..., 2) in [0, 1]
        coords = 2.0 * coords.float() - 1.0
        coords = 2.0 * math.pi * (coords @ self.positional_embedding)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class SamPromptEncoder(nn.Module):
    """Box prompts and the no-mask dense embedding (the paths the reference
    uses: YOLO boxes only, sam3-pipeline/app/main.py:74-92)."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: int = 64,
                 input_image_size: int = 1024):
        super().__init__()
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.shared_embedding = SamPositionalEmbedding(embed_dim // 2)
        for i in range(4):
            self.register_parameter(f"point_embed_{i}", nn.Parameter(
                torch.randn(1, embed_dim)))
        self.not_a_point_embed = nn.Parameter(torch.randn(1, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.randn(1, embed_dim))

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) xyxy input-image pixels -> (B, 2, 256)."""
        coords = (boxes.reshape(-1, 2, 2) + 0.5) / self.input_image_size
        corner = self.shared_embedding(coords)
        return torch.stack([corner[:, 0] + self.point_embed_2[0],
                            corner[:, 1] + self.point_embed_3[0]], dim=1)

    def dense_no_mask(self, batch: int, gh: int, gw: int) -> torch.Tensor:
        return self.no_mask_embed.reshape(1, 1, 1, -1).expand(batch, gh, gw,
                                                              -1)

    def image_pe(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh, gw, 256); rect grids normalise by the square embedding
        size (the top-left slice of the square PE)."""
        e = self.image_embedding_size
        dev = self.no_mask_embed.device
        y = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / e
        x = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / e
        grid = torch.stack([x[None, :].expand(gh, gw),
                            y[:, None].expand(gh, gw)], dim=-1)
        return self.shared_embedding(grid)[None]


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        inner = qp.shape[-1]
        hd = inner // self.heads

        def split(t):
            return t.view(t.shape[0], t.shape[1], self.heads, hd
                          ).transpose(1, 2)
        a = (split(qp) @ split(kp).transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(a.float(), dim=-1).to(q.dtype)
        out = (a @ split(vp)).transpose(1, 2).reshape(q.shape[0],
                                                      q.shape[1], inner)
        return self.out_proj(out)


class TwoWayMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, heads)
        self.cross_attn_t2i = DecoderAttention(dim, heads, 2)
        self.cross_attn_i2t = DecoderAttention(dim, heads, 2)
        self.mlp = TwoWayMlp(dim, mlp_dim)
        for i in range(1, 5):
            self.add_module(f"ln{i}", nn.LayerNorm(dim, eps=1e-6))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.ln1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.ln2(queries + self.cross_attn_t2i(q, k, keys))
        queries = self.ln3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.ln4(keys + self.cross_attn_i2t(k, q, queries))
        return queries, keys


class ReluFeedForward(nn.Module):
    """SAM's MLP head: proj_in -> relu -> hidden layers -> proj_out."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        self.num_hidden = num_layers - 2
        self.proj_in = nn.Linear(dim, hidden)
        for i in range(self.num_hidden):
            self.add_module(f"layer{i}", nn.Linear(hidden, hidden))
        self.proj_out = nn.Linear(hidden, out)

    def forward(self, x):
        x = F.relu(self.proj_in(x))
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, depth: int = 2, heads: int = 8,
                 mlp_dim: int = 2048, num_multimask: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden: int = 256):
        super().__init__()
        self.dim = dim
        self.depth = depth
        self.num_mask_tokens = n = num_multimask + 1
        self.iou_token = nn.Parameter(torch.randn(1, dim))
        self.mask_tokens = nn.Parameter(torch.randn(n, dim))
        for i in range(depth):
            self.add_module(f"layer{i}", TwoWayLayer(
                dim, heads, mlp_dim, skip_first_layer_pe=(i == 0)))
        self.final_attn = DecoderAttention(dim, heads, 2)
        self.ln_final = nn.LayerNorm(dim, eps=1e-6)
        # ConvTranspose2d(k=2, s=2) weights kept in their (in, out, 2, 2)
        self.upscale_conv1 = nn.Parameter(torch.zeros(dim, dim // 4, 2, 2))
        self.upscale_conv1_bias = nn.Parameter(torch.zeros(dim // 4))
        self.upscale_conv2 = nn.Parameter(torch.zeros(dim // 4, dim // 8,
                                                      2, 2))
        self.upscale_conv2_bias = nn.Parameter(torch.zeros(dim // 8))
        self.upscale_ln = LayerNorm2d(dim // 4)
        for i in range(n):
            self.add_module(f"hyper{i}", ReluFeedForward(dim, dim, dim // 8))
        self.iou_head = ReluFeedForward(dim, iou_head_hidden, n,
                                        iou_head_depth)

    @staticmethod
    def _conv_t2x(x, wgt, bias):
        """ConvTranspose2d(k=2, s=2) as a per-pixel 2x2 expansion."""
        out = torch.einsum("bhwc,cokl->bhkwlo", x, wgt)
        b, h, _, w, _, o = out.shape
        return out.reshape(b, h * 2, w * 2, o) + bias

    def forward(self, image_embeddings, image_pe, sparse_prompt,
                dense_prompt, multimask_output: bool = False):
        """image_embeddings (B, h, w, 256) -> masks (B, M, 4h, 4w) and
        iou_pred (B, M)."""
        b = sparse_prompt.shape[0]
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        h, w = src.shape[1], src.shape[2]
        src = src.reshape(b, h * w, self.dim)
        pos = image_pe.reshape(1, h * w, self.dim).expand(b, -1, -1)
        queries, keys = tokens, src
        for i in range(self.depth):
            queries, keys = getattr(self, f"layer{i}")(queries, keys, tokens,
                                                        pos)
        attn = self.final_attn(queries + tokens, keys + pos, keys)
        queries = self.ln_final(queries + attn)
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + self.num_mask_tokens]

        u = self._conv_t2x(keys.reshape(b, h, w, self.dim),
                           self.upscale_conv1, self.upscale_conv1_bias)
        u = F.gelu(self.upscale_ln(u))
        u = F.gelu(self._conv_t2x(u, self.upscale_conv2,
                                  self.upscale_conv2_bias))
        hyper = torch.stack([getattr(self, f"hyper{i}")(mask_out[:, i])
                             for i in range(self.num_mask_tokens)], dim=1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, u)
        iou_pred = self.iou_head(iou_out)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]


# canonical segment_anything build_sam geometries; the prompt encoder and
# mask decoder are the same for every variant
SAM_VARIANTS: Dict[str, Dict[str, Any]] = {
    "vit_b": dict(encoder_dim=768, encoder_depth=12, encoder_heads=12,
                  global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(encoder_dim=1024, encoder_depth=24, encoder_heads=16,
                  global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(encoder_dim=1280, encoder_depth=32, encoder_heads=16,
                  global_attn_indexes=(7, 15, 23, 31)),
}


def infer_variant(encoder_dim: int) -> str:
    """Checkpoint geometry -> variant name (the widths are unique), as the
    reference selects a variant by checkpoint name (sam3:57-63)."""
    for name, geo in SAM_VARIANTS.items():
        if geo["encoder_dim"] == encoder_dim:
            return name
    raise ValueError(f"no SAM variant has encoder_dim={encoder_dim}")


class Sam(nn.Module):
    """Encoder + prompt encoder + decoder; call ``encode`` and
    ``decode_boxes`` separately so an image is encoded once."""

    def __init__(self, img_size: int = 1024, encoder_dim: int = 768,
                 encoder_depth: int = 12, encoder_heads: int = 12,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 window_size: int = 14, device=None):
        super().__init__()
        self.img_size = img_size
        self.encoder_dim = encoder_dim
        self.vision_encoder = SamVisionEncoder(
            img_size=img_size, dim=encoder_dim, depth=encoder_depth,
            heads=encoder_heads, global_attn_indexes=global_attn_indexes,
            window_size=window_size)
        self.prompt_encoder = SamPromptEncoder(
            input_image_size=img_size, image_embedding_size=img_size // 16)
        self.mask_decoder = SamMaskDecoder()
        self.to(resolve_device(device))

    def encode(self, images: torch.Tensor, content_rows: int = 0):
        return self.vision_encoder(images, content_rows)

    def decode_boxes(self, image_embeddings: torch.Tensor,
                     boxes: torch.Tensor, multimask_output: bool = False):
        gh, gw = image_embeddings.shape[1], image_embeddings.shape[2]
        sparse = self.prompt_encoder.embed_boxes(boxes)
        dense = self.prompt_encoder.dense_no_mask(boxes.shape[0], gh, gw)
        image_pe = self.prompt_encoder.image_pe(gh, gw)
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense,
                                 multimask_output)


def build_sam(variant: str = "vit_b", img_size: int = 1024,
              device=None) -> Sam:
    """Variant-geometry constructor (``config.sam.variant`` -> module)."""
    try:
        geo = SAM_VARIANTS[variant]
    except KeyError:
        raise ValueError(f"unknown SAM variant {variant!r}; expected one of "
                         f"{sorted(SAM_VARIANTS)}") from None
    return Sam(img_size=img_size, device=device, **geo)


# ---------------------------------------------------------------------------
# torch checkpoints (HF SamModel, segment-anything) -> the flax tree
# ---------------------------------------------------------------------------
def _lin(sd, prefix):
    return {"kernel": np.asarray(sd[prefix + ".weight"]).T,
            "bias": np.asarray(sd[prefix + ".bias"])}


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _ln2d(sd, prefix):
    return {"weight": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _attn(sd, prefix):
    return {"q_proj": _lin(sd, prefix + ".q_proj"),
            "k_proj": _lin(sd, prefix + ".k_proj"),
            "v_proj": _lin(sd, prefix + ".v_proj"),
            "out_proj": _lin(sd, prefix + ".out_proj")}


def _ffn(sd, prefix, num_layers=3):
    out = {"proj_in": _lin(sd, prefix + ".proj_in"),
           "proj_out": _lin(sd, prefix + ".proj_out")}
    for i in range(num_layers - 2):
        out[f"layer{i}"] = _lin(sd, f"{prefix}.layers.{i}")
    return out


def sa_to_hf_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Rename an original ``segment-anything`` checkpoint (the
    ``sam_vit_{b,l,h}_*.pth`` files the reference registry loads,
    services/sam3-pipeline/app/main.py:51-72) into the HF ``SamModel``
    key naming that :func:`convert_hf_state_dict` reads.

    Tensor VALUES are identical between the two layouts (HF's SamModel
    was converted from these checkpoints) — this is purely a key rename,
    so a dropped reference checkpoint converts without the
    segment-anything package installed.
    """
    import re
    rules = [
        (r"^image_encoder\.patch_embed\.proj\.",
         "vision_encoder.patch_embed.projection."),
        (r"^image_encoder\.blocks\.(\d+)\.norm1\.",
         r"vision_encoder.layers.\1.layer_norm1."),
        (r"^image_encoder\.blocks\.(\d+)\.norm2\.",
         r"vision_encoder.layers.\1.layer_norm2."),
        (r"^image_encoder\.blocks\.(\d+)\.", r"vision_encoder.layers.\1."),
        (r"^image_encoder\.neck\.0\.", "vision_encoder.neck.conv1."),
        (r"^image_encoder\.neck\.1\.", "vision_encoder.neck.layer_norm1."),
        (r"^image_encoder\.neck\.2\.", "vision_encoder.neck.conv2."),
        (r"^image_encoder\.neck\.3\.", "vision_encoder.neck.layer_norm2."),
        (r"^image_encoder\.", "vision_encoder."),
        (r"^prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix$",
         "prompt_encoder.shared_embedding.positional_embedding"),
        (r"^prompt_encoder\.point_embeddings\.",
         "prompt_encoder.point_embed."),
        # mask_downscaling is unused on the box-prompt path but mapped so
        # a torch-side SamModel.load_state_dict can be key-complete
        (r"^prompt_encoder\.mask_downscaling\.0\.",
         "prompt_encoder.mask_embed.conv1."),
        (r"^prompt_encoder\.mask_downscaling\.1\.",
         "prompt_encoder.mask_embed.layer_norm1."),
        (r"^prompt_encoder\.mask_downscaling\.3\.",
         "prompt_encoder.mask_embed.conv2."),
        (r"^prompt_encoder\.mask_downscaling\.4\.",
         "prompt_encoder.mask_embed.layer_norm2."),
        (r"^prompt_encoder\.mask_downscaling\.6\.",
         "prompt_encoder.mask_embed.conv3."),
        (r"^mask_decoder\.transformer\.norm_final_attn\.",
         "mask_decoder.transformer.layer_norm_final_attn."),
        (r"^mask_decoder\.transformer\.layers\.(\d+)\.norm([1-4])\.",
         r"mask_decoder.transformer.layers.\1.layer_norm\2."),
        (r"^mask_decoder\.output_upscaling\.0\.",
         "mask_decoder.upscale_conv1."),
        (r"^mask_decoder\.output_upscaling\.1\.",
         "mask_decoder.upscale_layer_norm."),
        (r"^mask_decoder\.output_upscaling\.3\.",
         "mask_decoder.upscale_conv2."),
        # 3-layer MLPs: SA uses layers.{0,1,2}; HF names them
        # proj_in / layers.0 / proj_out
        (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
         r"iou_prediction_head))\.layers\.0\.", r"\1.proj_in."),
        (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
         r"iou_prediction_head))\.layers\.1\.", r"\1.layers.0."),
        (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
         r"iou_prediction_head))\.layers\.2\.", r"\1.proj_out."),
    ]
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        nk = k
        for pat, rep in rules:
            nk2 = re.sub(pat, rep, nk)
            if nk2 != nk:
                nk = nk2
                break
        out[nk] = v
    return out


def detect_sam_layout(sd: Dict[str, Any]) -> str:
    """'hf' (transformers SamModel), 'sa' (original segment-anything),
    or raises for anything else."""
    if any(k.startswith("vision_encoder.") for k in sd):
        return "hf"
    if any(k.startswith("image_encoder.") for k in sd):
        return "sa"
    raise ValueError("state dict is neither HF SamModel nor "
                     "segment-anything layout")


def convert_sa_state_dict(sd: Dict[str, Any],
                          depth: Optional[int] = None,
                          decoder_depth: int = 2) -> Dict:
    """Convert an original segment-anything checkpoint (key rename +
    :func:`convert_hf_state_dict`)."""
    return convert_hf_state_dict(sa_to_hf_state_dict(sd), depth=depth,
                                 decoder_depth=decoder_depth)


def convert_hf_state_dict(sd: Dict[str, Any], depth: Optional[int] = None,
                          decoder_depth: int = 2) -> Dict:
    """Map ``SamModel.state_dict()`` to the flax tree ({"params": ...},
    numpy leaves) whose names this module's parameters carry.

    ``depth`` defaults to the number of encoder layers present in the
    state dict, so vit_b/l/h checkpoints (12/24/32 layers,
    SAM_VARIANTS) all convert without a geometry argument — matching
    the reference's by-checkpoint-name variant selection
    (services/sam3-pipeline/app/main.py:51-72).
    """
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in sd.items()}
    if depth is None:
        depth = 1 + max(
            int(k.split(".")[2]) for k in sd
            if k.startswith("vision_encoder.layers."))
    ve: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.transpose(
                sd["vision_encoder.patch_embed.projection.weight"],
                (2, 3, 1, 0)),
            "bias": sd["vision_encoder.patch_embed.projection.bias"],
        },
        "pos_embed": sd["vision_encoder.pos_embed"],
        "neck_conv1": {"kernel": np.transpose(
            sd["vision_encoder.neck.conv1.weight"], (2, 3, 1, 0))},
        "neck_ln1": _ln2d(sd, "vision_encoder.neck.layer_norm1"),
        "neck_conv2": {"kernel": np.transpose(
            sd["vision_encoder.neck.conv2.weight"], (2, 3, 1, 0))},
        "neck_ln2": _ln2d(sd, "vision_encoder.neck.layer_norm2"),
    }
    for i in range(depth):
        t = f"vision_encoder.layers.{i}"
        ve[f"layer{i}"] = {
            "ln1": _ln(sd, f"{t}.layer_norm1"),
            "ln2": _ln(sd, f"{t}.layer_norm2"),
            "attn": {
                "qkv": _lin(sd, f"{t}.attn.qkv"),
                "proj": _lin(sd, f"{t}.attn.proj"),
                "rel_pos_h": sd[f"{t}.attn.rel_pos_h"],
                "rel_pos_w": sd[f"{t}.attn.rel_pos_w"],
            },
            "mlp": {"lin1": _lin(sd, f"{t}.mlp.lin1"),
                    "lin2": _lin(sd, f"{t}.mlp.lin2")},
        }

    pe: Dict[str, Any] = {
        "shared_embedding": {"positional_embedding":
                             sd["prompt_encoder.shared_embedding.positional_embedding"]},
        "not_a_point_embed": sd["prompt_encoder.not_a_point_embed.weight"],
        "no_mask_embed": sd["prompt_encoder.no_mask_embed.weight"],
    }
    for i in range(4):
        pe[f"point_embed_{i}"] = sd[f"prompt_encoder.point_embed.{i}.weight"]

    md: Dict[str, Any] = {
        "iou_token": sd["mask_decoder.iou_token.weight"],
        "mask_tokens": sd["mask_decoder.mask_tokens.weight"],
        "ln_final": _ln(sd, "mask_decoder.transformer.layer_norm_final_attn"),
        "final_attn": _attn(sd, "mask_decoder.transformer.final_attn_token_to_image"),
        # torch ConvTranspose2d weight (in, out, kh, kw) -> ours (in, out, kh, kw)
        "upscale_conv1": sd["mask_decoder.upscale_conv1.weight"],
        "upscale_conv1_bias": sd["mask_decoder.upscale_conv1.bias"],
        "upscale_conv2": sd["mask_decoder.upscale_conv2.weight"],
        "upscale_conv2_bias": sd["mask_decoder.upscale_conv2.bias"],
        "upscale_ln": _ln2d(sd, "mask_decoder.upscale_layer_norm"),
        "iou_head": _ffn(sd, "mask_decoder.iou_prediction_head"),
    }
    for i in range(4):
        md[f"hyper{i}"] = _ffn(sd, f"mask_decoder.output_hypernetworks_mlps.{i}")
    for i in range(decoder_depth):
        t = f"mask_decoder.transformer.layers.{i}"
        md[f"layer{i}"] = {
            "self_attn": _attn(sd, f"{t}.self_attn"),
            "cross_attn_t2i": _attn(sd, f"{t}.cross_attn_token_to_image"),
            "cross_attn_i2t": _attn(sd, f"{t}.cross_attn_image_to_token"),
            "ln1": _ln(sd, f"{t}.layer_norm1"),
            "ln2": _ln(sd, f"{t}.layer_norm2"),
            "ln3": _ln(sd, f"{t}.layer_norm3"),
            "ln4": _ln(sd, f"{t}.layer_norm4"),
            "mlp": {"lin1": _lin(sd, f"{t}.mlp.lin1"),
                    "lin2": _lin(sd, f"{t}.mlp.lin2")},
        }
    return {"params": {"vision_encoder": ve, "prompt_encoder": pe,
                       "mask_decoder": md}}
