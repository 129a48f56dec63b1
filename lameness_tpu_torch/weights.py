"""Parameters for the port: converted from the JAX engine, or seeded.

``from_jax_params`` turns the JAX engine's ``params`` dict (flax trees with
numpy leaves) into a state dict per sub-model.  The port's modules carry
the flax module names, so the conversion is by structure: Dense kernels
(in, out) -> Linear (out, in); Conv HWIO -> OIHW; LayerNorm scale -> weight;
DenseGeneral kernels flatten to Linear (in -> (3, h, hd) and in -> (h, hd)
told apart from (h, hd) -> out by the bias's rank); the TCN's WIO ``v`` ->
(out, in, k).  Other leaves (BN stats, GraphGPS's InferenceBN
``scale``/``bias``/``mean``/``var``, rel_pos_h/w, ls1/ls2, positional,
degree and prompt embeddings, the decoder's ConvTranspose weights) carry
over as they are.

``init_params`` is the seeded initialisation at the same shapes, from a
``torch.Generator``, for the card (where there is no JAX).
``conv_tree_from_state_dict`` is the inverse for convolutional models
(YOLO), so seeded weights can be written in a reference file layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _convert_tree(node: Mapping[str, Any], prefix: str,
                  out: Dict[str, torch.Tensor]) -> None:
    keys = set(node)
    if keys in ({"kernel"}, {"kernel", "bias"}):
        k = np.asarray(node["kernel"])
        b = None if "bias" not in node else np.asarray(node["bias"])
        if k.ndim == 2:                                 # Dense
            w = k.T
        elif b is not None and 1 < b.ndim == k.ndim - 1:
            # DenseGeneral in->(3, h, hd) or in->(h, hd): the bias has the
            # output's rank
            w = k.reshape(k.shape[0], -1).T
            b = b.reshape(-1)
        elif k.ndim == 3:                               # DenseGeneral h,hd->out
            w = k.reshape(-1, k.shape[-1]).T
        elif k.ndim == 4:                               # Conv HWIO -> OIHW
            w = np.transpose(k, (3, 2, 0, 1))
        else:
            raise ValueError(f"{prefix}kernel: unexpected shape {k.shape}")
        out[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if b is not None:
            out[prefix + "bias"] = torch.from_numpy(np.ascontiguousarray(b))
        return
    if keys == {"scale", "bias"}:                       # LayerNorm
        out[prefix + "weight"] = torch.from_numpy(np.asarray(node["scale"]))
        out[prefix + "bias"] = torch.from_numpy(np.asarray(node["bias"]))
        return
    for key, val in node.items():
        if isinstance(val, Mapping):
            _convert_tree(val, f"{prefix}{key}.", out)
            continue
        arr = np.asarray(val)
        if key == "v" and arr.ndim == 3:                # TCN WIO -> (O, I, K)
            arr = np.transpose(arr, (2, 1, 0))
        out[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, Dict[str,
                                                               torch.Tensor]]:
    """{"yolo": {"params": ...}, "dino": ..., ...} with numpy leaves ->
    {"yolo": state_dict, ...} for ``LamenessEngine.load_state_dicts``."""
    out = {}
    for name, sub in tree.items():
        sd: Dict[str, torch.Tensor] = {}
        _convert_tree(sub.get("params", sub), "", sd)
        out[name] = sd
    return out


def conv_tree_from_state_dict(sd: Mapping[str, torch.Tensor]
                              ) -> Dict[str, Any]:
    """A convolutional model's state dict (YOLO: Conv2d weights, biases, BN
    leaves) -> {"params": flax tree} with numpy leaves, the inverse of
    ``from_jax_params`` for such models: OIHW weights to HWIO kernels
    (bf16 tensors read as f32)."""
    tree: Dict[str, Any] = {}
    for key, val in sd.items():
        *path, leaf = key.split(".")
        t = val.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{key}: not a convolution ({arr.shape})")
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return {"params": tree}


def _fill(name: str, t: torch.Tensor, gen: torch.Generator,
          gain: float = 1.0) -> None:
    leaf = name.rsplit(".", 1)[-1]

    def normal(std: float) -> torch.Tensor:
        return torch.randn(t.shape, generator=gen) * std
    if leaf in ("bias", "b", "mean") or leaf.endswith("_bias"):
        t.zero_()
    elif leaf in ("var", "g", "scale") or (leaf == "weight" and t.dim() == 1):
        t.fill_(1.0)
    elif leaf in ("ls1", "ls2"):
        pass                          # the module's layer-scale init value
    elif leaf in ("rel_pos_h", "rel_pos_w", "pos_embed", "cls_token",
                  "degree_embed", "out_degree_embed", "virtual_node"):
        t.copy_(normal(0.02))
    elif leaf == "v":                 # TCN conv: he-normal over (in, k)
        t.copy_(normal(math.sqrt(2.0 / (t.shape[1] * t.shape[2]))))
    elif leaf == "weight":            # Linear/Conv (out, in, ...): lecun
        t.copy_(normal(gain / math.sqrt(t[0].numel())))
    elif leaf.startswith("upscale_conv"):   # (in, out, 2, 2)
        t.copy_(normal(1.0 / math.sqrt(t.shape[0])))
    else:                             # prompt / token embeddings
        t.copy_(normal(1.0))


def seeded_state_dict(model: torch.nn.Module, generator: torch.Generator,
                      gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """A CPU state dict of ``model`` with every tensor drawn (or set) from
    ``generator`` in key order: zeros for biases and BN means, ones for
    norm scales and BN variances, lecun-normal kernels (times ``gain``),
    he-normal TCN kernels, N(0, 0.02²) positional, degree and virtual-node
    tables, N(0, 1) prompt embeddings."""
    with torch.no_grad():
        sd = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}
        for key in sorted(sd):
            _fill(key, sd[key], generator, gain)
    return sd


def init_params(spec, config, generator: torch.Generator
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Seeded random weights for the engine's sub-models at (spec, config)
    geometry, as CPU state dicts: what the JAX engine runs with no
    checkpoint installed, drawn from a torch.Generator."""
    from .pipeline.engine import build_models
    return {name: seeded_state_dict(model, generator)
            for name, model in build_models(spec, config, "cpu").items()}
