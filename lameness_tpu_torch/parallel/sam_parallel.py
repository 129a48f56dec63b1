"""Multi-device paths for the SAM ViTDet encoder (port of
``lameness_tpu/parallel/sam_parallel.py``).

* ``sam_encoder_pipeline``: GPipe over a ``stage`` mesh axis
  (``pipeline_parallel.py``).  ViTDet-B repeats [window, window, global]
  (global layers 2, 5, 8, 11), so 4 stages of 3 layers have one parameter
  structure and stack; each position holds a quarter of the encoder.  The
  stages run the encoder's own layers (``torch.func.functional_call`` on
  stage 0's modules with each stage's weights), so on the card K2 and K3
  run inside them.
* ``sam_ring_attention``: one global layer's biased attention with the
  token grid split over a ``seq`` axis (``ring_attention.py``'s online
  softmax).  The decomposed rel-pos bias b[q, k] = rh[q, k // G] +
  rw[q, k % G] is rebuilt for each visiting block from the (BH, N, G)
  tables: the (N, N) bias never exists.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch.func import functional_call

from ..models.sam import SamVisionEncoder
from .mesh import Mesh
from .pipeline_parallel import pipeline_apply, stack_stage_params
from .ring_attention import fold_block


def _stage_windows(enc: SamVisionEncoder, n_stages: int) -> list:
    """The window size of each layer of a stage; the pattern must be the
    same in every stage."""
    if enc.depth % n_stages:
        raise ValueError(f"depth {enc.depth} over {n_stages} stages")
    per = enc.depth // n_stages
    wins = [0 if i in enc.global_attn_indexes else enc.window_size
            for i in range(enc.depth)]
    stages = [wins[s * per:(s + 1) * per] for s in range(n_stages)]
    if any(st != stages[0] for st in stages):
        raise ValueError(f"layer pattern not uniform across stages: "
                         f"{stages}")
    return stages[0]


def encoder_stages(enc: SamVisionEncoder, n_stages: int):
    """(stage_fn, per-stage parameter trees) of the encoder's layers cut
    into ``n_stages`` stages: stage s holds layers s·per .. s·per + per - 1
    as ``{"sub<j>": state dict}``."""
    _stage_windows(enc, n_stages)
    per = enc.depth // n_stages
    templates = [getattr(enc, f"layer{j}") for j in range(per)]
    per_stage = []
    for s in range(n_stages):
        per_stage.append({f"sub{j}": dict(getattr(
            enc, f"layer{s * per + j}").state_dict())
            for j in range(per)})

    def stage_fn(p_s, h):
        for j, layer in enumerate(templates):
            h = functional_call(layer, p_s[f"sub{j}"], (h,))
        return h
    return stage_fn, per_stage


def sam_encoder_pipeline(enc: SamVisionEncoder, params, images: torch.Tensor,
                         mesh: Mesh, num_microbatches: int = 2
                         ) -> torch.Tensor:
    """The encoder with its layers pipelined over ``mesh``'s stage axis.
    ``params``: the encoder's state dict (None: its own weights);
    ``images``: (B, img, img, 3) normalised, B divisible by
    ``num_microbatches``.  The patch embedding runs before the pipeline and
    the neck after it, on the images' device."""
    if params is not None:
        enc = copy.deepcopy(enc)
        enc.load_state_dict(params)
    stage_fn, per_stage = encoder_stages(enc, mesh.size)
    x = enc.embed(images)
    x = pipeline_apply(stage_fn, stack_stage_params(per_stage), x, mesh,
                       num_microbatches)
    return enc.neck(x)


def sam_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rel_h: torch.Tensor, rel_w: torch.Tensor,
                       mesh: Mesh, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """Biased attention over the (G, G) token grid, sequence-split.

    q, k, v: (BH, N, D) with N = G² divisible by the mesh size; rel_h,
    rel_w: (BH, G, G, G) q-projected tables (``ops.sam_attention.
    project_rel_tables``).  Equal to ``sam_attention_reference`` up to
    float reassociation (float32 scores and accumulators here; the
    reference rounds the softmax weights to q's dtype before PV).  Returns
    (BH, N, D) in q's dtype on q's device."""
    bh, n, d = q.shape
    g = rel_h.shape[1]
    if n != g * g:
        raise ValueError(f"{n} tokens is not a {g}x{g} grid")
    devices = list(mesh.devices.flat)
    n_ring = len(devices)
    if n % n_ring:
        raise ValueError(f"{n} tokens do not split over {n_ring}")
    blk = n // n_ring
    if scale is None:
        scale = d ** -0.5
    rh = rel_h.reshape(bh, n, g)              # [bh, q, kh]
    rw = rel_w.reshape(bh, n, g)              # [bh, q, kw]
    local = []
    for i, dev in enumerate(devices):
        rows = slice(i * blk, (i + 1) * blk)
        local.append((q[:, rows].to(dev), rh[:, rows].float().to(dev),
                      rw[:, rows].float().to(dev)))
    kv = [(k[:, i * blk:(i + 1) * blk].to(dev),
           v[:, i * blk:(i + 1) * blk].to(dev))
          for i, dev in enumerate(devices)]
    accs = [(torch.full((bh, blk, 1), -torch.inf, device=dev),
             torch.zeros((bh, blk, 1), device=dev),
             torch.zeros((bh, blk, d), device=dev)) for dev in devices]
    for step in range(n_ring):
        for i, (q_l, rh_l, rw_l) in enumerate(local):
            # the block visiting position i at this step started on
            # position (i - step) mod n_ring
            src = (i - step) % n_ring
            k_idx = torch.arange(src * blk, (src + 1) * blk,
                                 device=q_l.device)
            bias = rh_l[..., k_idx // g] + rw_l[..., k_idx % g]
            k_blk, v_blk = kv[i]
            s = (q_l.float() @ k_blk.float().transpose(-1, -2)) * scale
            accs[i] = fold_block(accs[i], s + bias, v_blk)
        if step < n_ring - 1:
            kv = [(a.to(devices[i]), b.to(devices[i]))
                  for i, (a, b) in enumerate(kv[-1:] + kv[:-1])]
    return torch.cat([(o / l).to(q.dtype).to(q.device) for _, l, o in accs],
                     dim=1)
